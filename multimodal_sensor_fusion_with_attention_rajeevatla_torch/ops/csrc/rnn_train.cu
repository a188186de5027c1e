// Grouped LSTM / GRU recurrences for training: forward with residuals and the
// reverse-time backward, f32, for Hopper (sm_90a).
//
// Replaces: multimodal_sensor_fusion_with_attention_rajeevatla_tpu/ops/pallas_rnn_train.py
//   _fwd_kernel     (grouped_lstm_trainable's forward): the LSTM over x_proj
//                   [T, G, B, 4H] (b_ih inside) -> h_T [G, B, H], and per step
//                   the post-activation gates [T, G, B, 4H], h_{t-1} and c_{t-1}
//                   [T, G, B, H]
//   _bwd_kernel     (its backward): reverse time with dh, dc on chip ->
//                   dz [T, G, B, 4H], the x_proj cotangent
//   _gru_fwd_kernel (grouped_gru_trainable's forward): the GRU (r, z, n; b_hn
//                   inside the reset gate) -> h_T, gates [T, G, B, 3H],
//                   h_{t-1} and hn = h_{t-1} W_hn + b_hn [T, G, B, H]
//   _gru_bwd_kernel (its backward): dx = (dr_pre, dz_pre, dn_pre); the hidden
//                   path carries dn_pre * r in the candidate slot
// dW_hh and db_hh are not summed here: the wrapper takes them as one product
// and one sum over the dz this kernel writes (the reference leaves them to XLA
// the same way), so nothing needs atomics and a run repeats bit for bit. A row
// past its length is frozen: its residuals stay zero, its dz is exactly zero,
// and dh passes through to the step before unchanged.
//
// What bounds them on the H100: at T 512, G 4, B 32, H 256 a direction is
// 2 G H NG H per valid row-step (NG = 4 gates for the LSTM, 3 for the GRU),
// 34.4 / 25.8 GFLOP over Sum(len) = 16.4 k: 0.21 / 0.16 ms on the 3xTF32
// tensor cores (165 TFLOP/s), 0.51 / 0.38 on the CUDA cores, against 0.5-0.7
// GB of x_proj and residuals (0.15-0.20 ms). Neither is what sets the time:
// the T steps depend on each other, and each step is a chain of a product,
// an exchange and a barrier.
//
// All four kernels run rnn_cluster.cuh's body where H is a multiple of 64 up
// to 256: one cluster of 8 CTAs per (group, 16 batch rows), each CTA holding
// its units' slice of W_hh (four gate slots a unit, the GRU's fourth a zero
// column: 128 KB at H 256) in shared memory for the whole sequence and
// running the step products as 3xTF32 mma.sync; h (forward) and the partials
// of dh (backward) cross the cluster through distributed shared memory, one
// cluster barrier a step. So a step costs one CTA's product (16 x 128 x 256,
// 3.1 MFLOP of TF32 mma.sync), the exchange and the barrier, and not the
// 0.75-1 MB weight stream a block of the SIMT body pulls from L2 at every
// step (16.6 us a step forward, 19.4 backward on it at H 256 for the LSTM,
// 12.1 and 15.3 for the GRU; chip_smoke.py on an H100 80GB HBM3 at 700 W).
// At B 32 that is 64 CTAs (32 blocks on the SIMT body), and an LSTM step
// takes 5.4-5.7 us: the product ~2.3-3.1, the exchange ~0.9 (16 KB out of
// each CTA), a bare step with its cell, staging and barrier ~1.8-2.1
// (scripts/lstm_cluster_variants.py, same card). The GRU's forward keeps the
// zero column (its lane then holds r, z and h W_hn of its unit and runs the
// cell with no shuffle); its backward's product takes depth 3U, with no
// zero column (6% faster on the card than 4U). The wrapper routes any other H (the
// slice and buffers past one CTA's shared memory) to the SIMT body below:
// two hand-written kernels a direction, one count.
//
// rnn.cu's serving kernels (grouped_lstm_fused, grouped_gru_fused) run the
// same design with the input projection inside (rnn_cluster_fused.cuh, on
// this body's helpers); this file's cluster kernels are not shared with them.
//
// The SIMT body (both pairs at the other H) is rnn_cell.cuh's
// recurrence (rnn.cu's precomputed-projection path, row 16, and the fused
// serving kernels' fallback for the H and D their cluster body does not take)
// with the residual stores added: the thread that finishes unit j of a row holds that unit's gates and
// carries, so each store is its own, and unit j's columns lie side by side
// across the warp. Stores are made for valid steps only; the wrapper
// allocates the residuals (and dz) with torch.zeros, so the steps past a
// tile's longest length, which no block walks, hold zeros and the product
// dW_hh = h_prev^T dz never meets uninitialised memory. Its backward gives a
// block the same tile (kRows batch rows of one group, all steps) and walks t
// from the tile's longest length - 1 down to 0, with dh and dc of the tile in
// shared memory ([unit][row]). Per step, (1) thread (u, s) computes the 4 (3)
// gate cotangents of unit u for the rows of half s from the residuals (read
// from device memory), writes them to dz and to shared memory ([column][row]),
// and keeps the element-wise part of dh_{t-1} (the GRU's dh z; the frozen
// lane's dh); (2) after a barrier, dh_{t-1} += dz W_hh^T: thread (u, s) sums
// unit u's row of W_hh over half s of the 4H (3H) columns for all kRows rows,
// and the halves swap partial sums as in the forward. W_hh read in place
// would give each thread a row strided by 4H across the warp, so the wrapper
// transposes it once per call into [G, NG*H, H] and this reduction reads
// unit-consecutive words, coalesced, like the forward's. Both directions load
// the weights of a batch of rows (16 forward, 32 backward) into registers
// before their FMAs: left to `#pragma unroll`, ptxas kept one load in flight
// and the LSTM forward took 59.6 us a step, the GRU backward 34.8. Two
// barriers per step. 64-bit offsets; expf / tanhf, no fast math.

#include "rnn_cell.cuh"
#include "rnn_cluster.cuh"

using namespace msfa_rnn;

namespace {

constexpr int kUnrollT = 32;  // reduction columns whose weight loads are issued together

__device__ __forceinline__ void fma_col(float w, const float* vk, float (&acc)[kRows]) {
  float d[kRows];
  load_rows(vk, d);
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = fmaf(d[r], w, acc[r]);
}

// acc[r] += sum_{k0 <= k < k1} v[k][r] * Wt[k][j]: one unit's column of a
// transposed weight [NG*H, H], kUnrollT weight loads issued before their FMAs
__device__ __forceinline__ void accumulate_t(const float* __restrict__ wt, int k0, int k1, int H,
                                             int j, const float* v, float (&acc)[kRows]) {
  int k = k0;
  for (; k + kUnrollT <= k1; k += kUnrollT) {
    float w[kUnrollT];
#pragma unroll
    for (int i = 0; i < kUnrollT; ++i) w[i] = __ldg(wt + (size_t)(k + i) * H + j);
#pragma unroll
    for (int i = 0; i < kUnrollT; ++i) fma_col(w[i], v + (k + i) * kRows, acc);
  }
  for (; k < k1; ++k) fma_col(__ldg(wt + (size_t)k * H + j), v + k * kRows, acc);
}

// gates [T, G, B, NG*H] and `aux` (c_{t-1} or hn), hprev [T, G, B, H] (GRU
// only), w_t [G, NG*H, H] (W_hh transposed), dh_out [G, B, H] -> dx
// [T, G, B, NG*H], written at valid steps only (zero-filled by the caller)
template <int CELL>
__device__ __forceinline__ void recurrence_bwd(const float* __restrict__ gates,
                                               const float* __restrict__ hprev,
                                               const float* __restrict__ aux,
                                               const float* __restrict__ w_t,
                                               const int* __restrict__ lengths,
                                               const float* __restrict__ dh_out,
                                               float* __restrict__ dx, int T, int G, int B,
                                               int H) {
  constexpr int NG = CELL == kLstm ? 4 : 3;
  const int cols = NG * H;
  extern __shared__ float4 smem4[];
  float* dh_s = reinterpret_cast<float*>(smem4);  // [H][kRows] the carried dh
  float* dc_s = dh_s + H * kRows;                 // [H][kRows] the carried dc (LSTM)
  float* dz_s = dc_s + H * kRows;                 // [NG*H][kRows] the hidden path's cotangent
  float* red_s = dz_s + (size_t)cols * kRows;     // [2][kHalf][kUnits] partial sums
  __shared__ int len_s[kRows];

  const int g = blockIdx.y, b0 = blockIdx.x * kRows, tid = threadIdx.x;
  const int u = tid % kUnits, half = tid / kUnits;  // a warp lies in one half
  if (tid < kRows) {
    const int b = b0 + tid;
    len_s[tid] = b < B ? min(max(lengths[b], 0), T) : 0;
  }
  for (int i = tid; i < H * kRows; i += kThreads) {
    const int j = i / kRows, r = i - j * kRows;
    dh_s[i] = b0 + r < B ? dh_out[((size_t)g * B + b0 + r) * H + j] : 0.f;
    dc_s[i] = 0.f;
  }
  __syncthreads();
  int t_end = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) t_end = max(t_end, len_s[r]);

  const float* wt_g = w_t + (size_t)g * cols * H;
  const int k_mid = (cols + 1) / 2;  // this half's part of the reduction
  const int k0 = half ? k_mid : 0, k1 = half ? cols : k_mid;
  for (int t = t_end - 1; t >= 0; --t) {
    const size_t row0 = ((size_t)t * G + g) * B + b0;
    // (1) gate cotangents of unit j for this half's rows
    for (int j = u; j < H; j += kUnits) {
#pragma unroll
      for (int rr = 0; rr < kHalf; ++rr) {
        const int r = half * kHalf + rr;
        const int at = j * kRows + r;
        float d[NG];
#pragma unroll
        for (int q = 0; q < NG; ++q) d[q] = 0.f;
        if (t < len_s[r]) {  // else frozen: dz 0, dh and dc pass through
          const size_t row = row0 + r;
          const float* gt = gates + row * cols + j;
          float* dxr = dx + row * cols + j;
          const float dh = dh_s[at];
          if constexpr (CELL == kLstm) {
            const float gi = gt[0], gf = gt[H], gg = gt[2 * H], go = gt[3 * H];
            const float c_prev = aux[row * H + j];
            const float tc = tanhf(gf * c_prev + gi * gg);  // c_t recomputed
            const float dc = dc_s[at] + dh * go * (1.f - tc * tc);
            d[0] = dc * gg * gi * (1.f - gi);
            d[1] = dc * c_prev * gf * (1.f - gf);
            d[2] = dc * gi * (1.f - gg * gg);
            d[3] = dh * tc * go * (1.f - go);
            dc_s[at] = dc * gf;
            dh_s[at] = 0.f;  // dh_{t-1} is all dz W_hh^T, added below
#pragma unroll
            for (int q = 0; q < 4; ++q) dxr[q * H] = d[q];
          } else {
            const float gr = gt[0], gz = gt[H], gn = gt[2 * H];
            const float h_prev = hprev[row * H + j], hn = aux[row * H + j];
            const float dn_pre = dh * (1.f - gz) * (1.f - gn * gn);
            d[0] = dn_pre * hn * gr * (1.f - gr);
            d[1] = dh * (h_prev - gn) * gz * (1.f - gz);
            dxr[0] = d[0];
            dxr[H] = d[1];
            dxr[2 * H] = dn_pre;
            d[2] = dn_pre * gr;  // n = tanh(x_n + r hn): the hidden path's slot
            dh_s[at] = dh * gz;
          }
        }
#pragma unroll
        for (int q = 0; q < NG; ++q) dz_s[(q * H + j) * kRows + r] = d[q];
      }
    }
    __syncthreads();  // dz of the whole tile is in place
    // (2) dh_{t-1} += dz W_hh^T, units in passes of kUnits
    for (int j0 = 0; j0 < H; j0 += kUnits) {
      const int j = j0 + u;
      const bool active = j < H;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      if (active) {
        accumulate_t(wt_g, k0, k1, H, j, dz_s, acc);
        float* dst = red_s + (1 - half) * kHalf * kUnits + u;
#pragma unroll
        for (int rr = 0; rr < kHalf; ++rr) dst[rr * kUnits] = acc[(1 - half) * kHalf + rr];
      }
      __syncthreads();  // the partial sums are in place
      if (active) {
        const float* src = red_s + half * kHalf * kUnits + u;
#pragma unroll
        for (int rr = 0; rr < kHalf; ++rr) {
          const int r = half * kHalf + rr;
          dh_s[j * kRows + r] += acc[r] + src[rr * kUnits];
        }
      }
      if (j0 + kUnits < H) __syncthreads();  // the next pass reuses the exchange buffer
    }
    // the next step's (1) reads only this thread's own dh, dc; its dz stores
    // come after every thread has passed the barrier above
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_train_fwd_kernel(const float* __restrict__ x_proj, const float* __restrict__ w_hh,
                      const float* __restrict__ b_hh, const int* __restrict__ lengths,
                      float* __restrict__ out, float* __restrict__ gates,
                      float* __restrict__ hprev, float* __restrict__ cprev, int T, int G, int B,
                      int H) {
  recurrence<kLstm, false, true>(x_proj, nullptr, w_hh, b_hh, nullptr, lengths, out, T, G, B, 0,
                                 H, Residuals{gates, hprev, cprev});
}

__global__ void __launch_bounds__(kThreads)
gru_train_fwd_kernel(const float* __restrict__ x_proj, const float* __restrict__ w_hh,
                     const float* __restrict__ b_hh, const int* __restrict__ lengths,
                     float* __restrict__ out, float* __restrict__ gates,
                     float* __restrict__ hprev, float* __restrict__ hn, int T, int G, int B,
                     int H) {
  // x_proj holds b_ih; b_hh stays on the hidden path
  recurrence<kGru, false, true>(x_proj, nullptr, w_hh, nullptr, b_hh, lengths, out, T, G, B, 0,
                                H, Residuals{gates, hprev, hn});
}

__global__ void __launch_bounds__(kThreads)
lstm_train_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cprev,
                      const float* __restrict__ w_t, const int* __restrict__ lengths,
                      const float* __restrict__ dh_out, float* __restrict__ dx, int T, int G,
                      int B, int H) {
  recurrence_bwd<kLstm>(gates, nullptr, cprev, w_t, lengths, dh_out, dx, T, G, B, H);
}

__global__ void __launch_bounds__(kThreads)
gru_train_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ hprev,
                     const float* __restrict__ hn, const float* __restrict__ w_t,
                     const int* __restrict__ lengths, const float* __restrict__ dh_out,
                     float* __restrict__ dx, int T, int G, int B, int H) {
  recurrence_bwd<kGru>(gates, hprev, hn, w_t, lengths, dh_out, dx, T, G, B, H);
}

// dh, dc, dz of the tile and the exchange buffer
size_t smem_bwd_bytes(int H, int NG) {
  return sizeof(float) * ((size_t)(2 + NG) * H * kRows + 2 * kHalf * kUnits);
}

void cluster_config(cudaLaunchConfig_t& config, cudaLaunchAttribute (&attr)[1], size_t smem,
                    int B, int G, int H, void* stream) {
  using namespace msfa_cluster;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.gridDim = dim3(kCluster, (B + kTileRows - 1) / kTileRows, G);
  config.blockDim = dim3(cluster_threads(H));
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int B, int G, void* stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows, G);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

// one cluster of kCluster CTAs per (tile of kTileRows rows, group)
template <class... Params, class... Args>
int launch_cluster(void (*kernel)(Params...), size_t smem, int B, int G, int H, void* stream,
                   Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  cluster_config(config, attr, smem, B, G, H, stream);
  err = cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The training pairs on the cluster body (rnn_cluster.cuh); an H it does not
// take (H a multiple of 64 up to 256; ops/rnn.py's rnn_train_route) is refused.
int msfa_lstm_train_fwd(const float* x_proj, const float* w_hh, const float* b_hh,
                        const int* lengths, float* out, float* gates, float* hprev, float* cprev,
                        int T, int G, int B, int H, void* stream) {
  using namespace msfa_cluster;
  if (bad_shape(T, G, B, 0, H) || !supported(H)) return (int)cudaErrorInvalidValue;
  return launch_cluster(lstm_train_fwd_cluster_kernel, fwd_smem_bytes<kLstm>(H), B, G, H, stream,
                        x_proj, w_hh, b_hh, lengths, out, gates, hprev, cprev, T, G, B, H);
}

int msfa_lstm_train_bwd(const float* gates, const float* cprev, const float* w_hh,
                        const int* lengths, const float* dh_out, float* dx, int T, int G, int B,
                        int H, void* stream) {
  using namespace msfa_cluster;
  if (bad_shape(T, G, B, 0, H) || !supported(H)) return (int)cudaErrorInvalidValue;
  return launch_cluster(lstm_train_bwd_cluster_kernel, bwd_smem_bytes<kLstm>(H), B, G, H,
                        stream, gates, cprev, w_hh, lengths, dh_out, dx, T, G, B, H);
}

int msfa_gru_train_fwd(const float* x_proj, const float* w_hh, const float* b_hh,
                       const int* lengths, float* out, float* gates, float* hprev, float* hn,
                       int T, int G, int B, int H, void* stream) {
  using namespace msfa_cluster;
  if (bad_shape(T, G, B, 0, H) || !supported(H)) return (int)cudaErrorInvalidValue;
  return launch_cluster(gru_train_fwd_cluster_kernel, fwd_smem_bytes<kGru>(H), B, G, H, stream,
                        x_proj, w_hh, b_hh, lengths, out, gates, hprev, hn, T, G, B, H);
}

int msfa_gru_train_bwd(const float* gates, const float* hprev, const float* hn, const float* w_hh,
                       const int* lengths, const float* dh_out, float* dx, int T, int G, int B,
                       int H, void* stream) {
  using namespace msfa_cluster;
  if (bad_shape(T, G, B, 0, H) || !supported(H)) return (int)cudaErrorInvalidValue;
  return launch_cluster(gru_train_bwd_cluster_kernel, bwd_smem_bytes<kGru>(H), B,
                        G, H, stream, gates, hprev, hn, w_hh, lengths, dh_out, dx, T, G, B, H);
}

// The cluster body's launch for cell `gru` (0 LSTM, 1 GRU) at hidden H, batch
// B and G groups: info[0] CTAs per cluster, info[1] batch rows per cluster,
// info[2] threads per CTA, info[3] / info[4] dynamic shared memory of the
// forward / backward (bytes), info[5] / info[6] the clusters of each that fit
// on the card at once (cudaOccupancyMaxActiveClusters), info[7] the clusters
// one launch runs.
int msfa_rnn_train_cluster_info(int gru, int H, int B, int G, int* info) {
  using namespace msfa_cluster;
  if (!supported(H) || B <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem[2] = {gru ? fwd_smem_bytes<kGru>(H) : fwd_smem_bytes<kLstm>(H),
                          gru ? bwd_smem_bytes<kGru>(H) : bwd_smem_bytes<kLstm>(H)};
  const void* kernels[2] = {
      gru ? (const void*)gru_train_fwd_cluster_kernel : (const void*)lstm_train_fwd_cluster_kernel,
      gru ? (const void*)gru_train_bwd_cluster_kernel : (const void*)lstm_train_bwd_cluster_kernel};
  info[0] = kCluster;
  info[1] = kTileRows;
  info[2] = cluster_threads(H);
  for (int d = 0; d < 2; ++d) {
    info[3 + d] = (int)smem[d];
    cudaError_t err = cudaFuncSetAttribute(kernels[d], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem[d]);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t config = {};
    cudaLaunchAttribute attr[1];
    cluster_config(config, attr, smem[d], B, G, H, nullptr);
    err = cudaOccupancyMaxActiveClusters(&info[5 + d], kernels[d], &config);
    if (err != cudaSuccess) return (int)err;
  }
  info[7] = G * ((B + kTileRows - 1) / kTileRows);
  return 0;
}

// Both pairs on the SIMT body, for the H the cluster body does not take (the
// backward reads W_hh transposed, [G, NG H, H]).
int msfa_lstm_train_fwd_simt(const float* x_proj, const float* w_hh, const float* b_hh,
                             const int* lengths, float* out, float* gates, float* hprev,
                             float* cprev, int T, int G, int B, int H, void* stream) {
  if (bad_shape(T, G, B, 0, H)) return (int)cudaErrorInvalidValue;
  return launch(lstm_train_fwd_kernel, smem_bytes(H, (size_t)kRows * 4 * H), B, G, stream,
                x_proj, w_hh, b_hh, lengths, out, gates, hprev, cprev, T, G, B, H);
}

int msfa_gru_train_fwd_simt(const float* x_proj, const float* w_hh, const float* b_hh,
                            const int* lengths, float* out, float* gates, float* hprev, float* hn,
                            int T, int G, int B, int H, void* stream) {
  if (bad_shape(T, G, B, 0, H)) return (int)cudaErrorInvalidValue;
  return launch(gru_train_fwd_kernel, smem_bytes(H, (size_t)kRows * 3 * H), B, G, stream,
                x_proj, w_hh, b_hh, lengths, out, gates, hprev, hn, T, G, B, H);
}

int msfa_lstm_train_bwd_simt(const float* gates, const float* cprev, const float* w_t,
                             const int* lengths, const float* dh_out, float* dx, int T, int G,
                             int B, int H, void* stream) {
  if (bad_shape(T, G, B, 0, H)) return (int)cudaErrorInvalidValue;
  return launch(lstm_train_bwd_kernel, smem_bwd_bytes(H, 4), B, G, stream,
                gates, cprev, w_t, lengths, dh_out, dx, T, G, B, H);
}

int msfa_gru_train_bwd_simt(const float* gates, const float* hprev, const float* hn,
                            const float* w_t, const int* lengths, const float* dh_out, float* dx,
                            int T, int G, int B, int H, void* stream) {
  if (bad_shape(T, G, B, 0, H)) return (int)cudaErrorInvalidValue;
  return launch(gru_train_bwd_kernel, smem_bwd_bytes(H, 3), B, G, stream,
                gates, hprev, hn, w_t, lengths, dh_out, dx, T, G, B, H);
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
