// Grouped LSTM / GRU recurrences (inference, final hidden state), f32, for
// Hopper (sm_90a).
//
// Replaces: multimodal_sensor_fusion_with_attention_rajeevatla_tpu/ops/pallas_rnn.py
//   _lstm_kernel       (launched by grouped_lstm_forward): recurrence over a
//                      precomputed x_proj [T, G, B, 4H]
//   _lstm_fused_kernel (grouped_lstm_fused): the input projection x_t W_ih
//                      computed in the kernel from raw x [T, G, B, D]
//   _gru_fused_kernel  (grouped_gru_fused): GRU (r, z, n), input projection
//                      in the kernel, b_hh inside the reset gate
// Each returns the final hidden state [G, B, H]; a row's carry freezes at its
// length (keep * new + (1 - keep) * old with keep = t < length), so a row of
// length 0 returns exact zeros. Every product is computed here; no library
// call.
//
// What bounds them on the H100: operations. One step of the whole batch is
// 2 G B H (4H + 4D) = 0.14 GFLOP at G 4, B 64, H 256, D 17; at T 512 and a
// real batch's lengths the LSTM's whole call is 70.95 GFLOP (row 17 of
// PERF.md's kernel table), 0.43 ms on the 3xTF32 tensor cores, 1.06 on the
// CUDA cores, against a few KB of input per step (row 16 over x_proj: 66.53
// GFLOP, 0.40 ms, against 537 MB of x_proj, 0.16 ms); and the T steps depend on
// each other, so the sequence cannot be spread over time. What sets the time
// is a step's chain: its product, the exchange of h and a barrier.
//
// All three run rnn_cluster_fused.cuh's body where H is a multiple of 64 up
// to 256 (and, for the two fused ones, D at most 64; ops/rnn.py's
// grouped_fused_route and grouped_lstm_forward_route): one cluster of 8 CTAs
// per (group, tile of 16 or 32 batch rows), each CTA holding its units'
// slices of W_hh and W_ih in shared memory for the whole sequence, computing
// the input projection itself from raw x (no x_proj in device memory, as in
// the reference), running the step
// products as 3xTF32 mma.sync and exchanging the new h through distributed
// shared memory, one cluster barrier a step; the x part of the next step
// runs while a CTA waits at that barrier. A step then costs one CTA's
// product (16 x 128 x 256 at 16 rows), the exchange and the barrier, as the
// LSTM training forward's (rnn_train.cu's note), not the weight stream the
// SIMT body below pulls from the L2. 16 rows a cluster at B 64, G 4 is 16
// clusters, one more than fit on the card at once: the wrapper reads the
// active-cluster count (msfa_grouped_fused_cluster_info) and takes 32 rows
// (two m16 tiles a CTA, each B fragment loaded once for both) where that
// runs a launch in fewer waves. On an H100 80GB HBM3 at 700 W
// (chip_smoke.py, scripts/rnn_fused_variants.py): a step at 16 rows takes
// 5.2 us (product ~2.8, exchange ~0.7, the x part ~0.3 of barrier wait it
// does not hide, barrier, cell and staging ~1.4), at 32 rows 8.2 (product
// ~4.4, exchange ~1.2); the LSTM at T 512, B 64 4.21 ms against the SIMT
// body's 10.48 (scripts/attention_kernels_ab.py, the same call).
// grouped_lstm_forward (row 16) is the same body with the x part read from
// the precomputed x_proj (rnn_cluster_fused.cuh's kXProj): no W_ih slice and
// no x product, each lane's 16 x_proj values loaded into registers one step
// ahead during the barrier wait: 4.1 ms (8.0 us a step) at T 512, B 64,
// where the SIMT body below took 7.4 ms (14.6 us), streaming W_hh from the
// L2 (scripts/attention_kernels_ab.py, the same call).
//
// The SIMT body (rnn_cell.cuh), kept for the H and D the cluster body does
// not take (the *_simt entries of the three kernels): the TPU
// kernel keeps W_hh [G, H, 4H] (1 MB per group) and the carries in VMEM for
// the whole sequence and walks a sequential grid of time blocks. An SM has
// 227 KB of shared memory, so there the weights stream: they are read again
// at every step and stay in the 50 MB L2 (4 MB for all groups). The chains
// are independent across groups and batch rows, which the grid uses: block
// (tile of kRows batch rows, group) runs all T steps itself, with no
// synchronisation between blocks. h (two buffers) and c of the tile live in
// shared memory, laid out [unit][row] so that one unit's kRows values are one
// 16-byte broadcast load.
//
// A block has 512 threads: thread (u, s) works on hidden unit u (units beyond
// 256 in further passes) and on half s of the reduction: it accumulates the
// gate columns u, H + u, 2H + u (, 3H + u) over its half of the rows of W_hh
// (and of W_ih) for all kRows batch rows in registers (16 accumulators),
// reading each weight once, coalesced across the warp. The two halves then
// swap partial sums through shared memory: half s hands over the sums of the
// other half's batch rows, adds what it receives, and finishes its own rows
// (gates, c, h) without a further exchange. Two barriers per step.
//
// What a step of the SIMT body costs is the weight stream, not the
// arithmetic: every block pulls its group's whole W_hh (and W_ih) from the
// L2 at each step, and one SM sustains about 57 GB/s of that (19 us a step
// for the fused LSTM at H 256, D 17 before the cluster body took it over;
// chip_smoke.py on an H100 80GB HBM3 at 700 W). kRows = 4 gives G B / 4 = 64
// blocks at B 64, 64 SMs pulling at once; 8 rows (32 blocks) was slower and
// 2 would ask the L2 for twice what it gives. On the precomputed-projection
// path the unrolled loop left one weight load in flight at a time (30.1 us a
// step); that path loads the weights of 16 rows into registers before their
// FMAs (rnn_cell.cuh `accumulate`) and reads 14.8 us a step (same script,
// same card).
//
// The SIMT body stages its input per step: x_t of the tile (kRows x D
// values), or its precomputed projection (kRows x 4H), is copied into shared
// memory one step ahead (cp.async), and W_ih is read like W_hh (D more rows
// of the same product), so any D is taken. A block stops at the longest
// length in its tile. No padding of B, T or D: rows past the batch are
// computed as zeros and never written. Offsets are 64-bit (x_proj [1024, 4,
// 64, 1024] has 268 M elements). expf / tanhf, no fast math.
//
// The SIMT recurrence is in rnn_cell.cuh: the GRU training forward of
// rnn_train.cu is the same body with per-step residual stores.

#include "rnn_cell.cuh"
#include "rnn_cluster_fused.cuh"

using namespace msfa_rnn;

namespace {

__global__ void __launch_bounds__(kThreads)
grouped_lstm_forward_kernel(const float* __restrict__ x_proj, const float* __restrict__ w_hh,
                            const float* __restrict__ b_hh, const int* __restrict__ lengths,
                            float* __restrict__ out, int T, int G, int B, int H) {
  recurrence<kLstm, false, false>(x_proj, nullptr, w_hh, b_hh, nullptr, lengths, out, T, G, B, 0,
                                  H, Residuals{});
}

__global__ void __launch_bounds__(kThreads)
grouped_lstm_fused_kernel(const float* __restrict__ x, const float* __restrict__ w_ih,
                          const float* __restrict__ w_hh, const float* __restrict__ bias,
                          const int* __restrict__ lengths, float* __restrict__ out, int T, int G,
                          int B, int D, int H) {
  recurrence<kLstm, true, false>(x, w_ih, w_hh, bias, nullptr, lengths, out, T, G, B, D, H,
                                 Residuals{});
}

__global__ void __launch_bounds__(kThreads)
grouped_gru_fused_kernel(const float* __restrict__ x, const float* __restrict__ w_ih,
                         const float* __restrict__ w_hh, const float* __restrict__ b_ih,
                         const float* __restrict__ b_hh, const int* __restrict__ lengths,
                         float* __restrict__ out, int T, int G, int B, int D, int H) {
  recurrence<kGru, true, false>(x, w_ih, w_hh, b_ih, b_hh, lengths, out, T, G, B, D, H,
                                Residuals{});
}

// the cluster body (rnn_cluster_fused.cuh), MT m16 tiles of batch rows a CTA
template <int MT>
__global__ void __launch_bounds__(msfa_cluster::fused_max_threads(MT), 1)
grouped_lstm_forward_cluster_kernel(const float* __restrict__ x_proj,
                                    const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                                    const int* __restrict__ lengths, float* __restrict__ out,
                                    int T, int G, int B, int H) {
  msfa_cluster::fused_cluster_body<kLstm, MT, msfa_cluster::kXProj>(
      x_proj, nullptr, w_hh, b_hh, nullptr, lengths, out, T, G, B, 0, H);
}

template <int MT>
__global__ void __launch_bounds__(msfa_cluster::fused_max_threads(MT), 1)
grouped_lstm_fused_cluster_kernel(const float* __restrict__ x, const float* __restrict__ w_ih,
                                  const float* __restrict__ w_hh, const float* __restrict__ bias,
                                  const int* __restrict__ lengths, float* __restrict__ out, int T,
                                  int G, int B, int D, int H) {
  msfa_cluster::fused_cluster_body<kLstm, MT>(x, w_ih, w_hh, bias, nullptr, lengths, out, T, G, B,
                                              D, H);
}

template <int MT>
__global__ void __launch_bounds__(msfa_cluster::fused_max_threads(MT), 1)
grouped_gru_fused_cluster_kernel(const float* __restrict__ x, const float* __restrict__ w_ih,
                                 const float* __restrict__ w_hh, const float* __restrict__ b_ih,
                                 const float* __restrict__ b_hh, const int* __restrict__ lengths,
                                 float* __restrict__ out, int T, int G, int B, int D, int H) {
  msfa_cluster::fused_cluster_body<kGru, MT>(x, w_ih, w_hh, b_ih, b_hh, lengths, out, T, G, B, D,
                                             H);
}

// a cluster kernel at `rows` batch rows a cluster: the launch, or the error
// that refused it
template <class... Params, class... Args>
int launch_cluster(void (*kernel)(Params...), int rows, int B, int G, int D, int H, void* stream,
                   Args... args) {
  const size_t smem = msfa_cluster::fused_smem_bytes(H, D, rows / msfa_cluster::kTileRows);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attr[1];
  msfa_cluster::fused_cluster_config(config, attr, smem, rows, B, G, H, stream);
  err = cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// a shape the cluster body does not take; D = 0: the x_proj entry
bool bad_cluster_shape(int T, int G, int B, int D, int H, int rows) {
  const bool fits = D == 0 ? msfa_cluster::supported(H) : msfa_cluster::fused_supported(H, D);
  return bad_shape(T, G, B, D, H) || !fits ||
         (rows != msfa_cluster::kTileRows && rows != 2 * msfa_cluster::kTileRows);
}

}  // namespace

extern "C" {

// grouped_lstm_forward on the cluster body at `rows` (16 or 32) batch rows a
// cluster; an H it does not take (ops/rnn.py's grouped_lstm_forward_route)
// is refused.
int msfa_grouped_lstm_forward(const float* x_proj, const float* w_hh, const float* b_hh,
                              const int* lengths, float* out, int T, int G, int B, int H,
                              int rows, void* stream) {
  if (bad_cluster_shape(T, G, B, 0, H, rows)) return (int)cudaErrorInvalidValue;
  if (rows == msfa_cluster::kTileRows)
    return launch_cluster(grouped_lstm_forward_cluster_kernel<1>, rows, B, G, 0, H, stream,
                          x_proj, w_hh, b_hh, lengths, out, T, G, B, H);
  return launch_cluster(grouped_lstm_forward_cluster_kernel<2>, rows, B, G, 0, H, stream, x_proj,
                        w_hh, b_hh, lengths, out, T, G, B, H);
}

// The SIMT body (rnn_cell.cuh) of grouped_lstm_forward, for the H the
// cluster body does not take.
int msfa_grouped_lstm_forward_simt(const float* x_proj, const float* w_hh, const float* b_hh,
                                   const int* lengths, float* out, int T, int G, int B, int H,
                                   void* stream) {
  if (bad_shape(T, G, B, 0, H)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H, (size_t)kRows * 4 * H);
  cudaError_t err = allow_smem(grouped_lstm_forward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows, G);
  grouped_lstm_forward_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x_proj, w_hh, b_hh, lengths, out, T, G, B, H);
  return (int)cudaGetLastError();
}

// The two fused recurrences on the cluster body at `rows` (16 or 32) batch
// rows a cluster; an H or D it does not take (ops/rnn.py's
// grouped_fused_route) is refused.
int msfa_grouped_lstm_fused(const float* x, const float* w_ih, const float* w_hh,
                            const float* bias, const int* lengths, float* out, int T, int G,
                            int B, int D, int H, int rows, void* stream) {
  if (bad_cluster_shape(T, G, B, D, H, rows)) return (int)cudaErrorInvalidValue;
  if (rows == msfa_cluster::kTileRows)
    return launch_cluster(grouped_lstm_fused_cluster_kernel<1>, rows, B, G, D, H, stream, x, w_ih,
                          w_hh, bias, lengths, out, T, G, B, D, H);
  return launch_cluster(grouped_lstm_fused_cluster_kernel<2>, rows, B, G, D, H, stream, x, w_ih,
                        w_hh, bias, lengths, out, T, G, B, D, H);
}

int msfa_grouped_gru_fused(const float* x, const float* w_ih, const float* w_hh,
                           const float* b_ih, const float* b_hh, const int* lengths, float* out,
                           int T, int G, int B, int D, int H, int rows, void* stream) {
  if (bad_cluster_shape(T, G, B, D, H, rows)) return (int)cudaErrorInvalidValue;
  if (rows == msfa_cluster::kTileRows)
    return launch_cluster(grouped_gru_fused_cluster_kernel<1>, rows, B, G, D, H, stream, x, w_ih,
                          w_hh, b_ih, b_hh, lengths, out, T, G, B, D, H);
  return launch_cluster(grouped_gru_fused_cluster_kernel<2>, rows, B, G, D, H, stream, x, w_ih,
                        w_hh, b_ih, b_hh, lengths, out, T, G, B, D, H);
}

// The cluster body's launch of grouped_lstm_fused (kind 0), grouped_gru_fused
// (kind 1) or grouped_lstm_forward (kind 2, D = 0) at hidden H, input width
// D, batch B and G groups, for 16 and for 32 rows a cluster: info[0] CTAs per
// cluster; then per tiling (16 rows at info[1..4], 32 at info[5..8]) the
// threads per CTA, the dynamic shared memory (bytes), the clusters that fit
// on the card at once (cudaOccupancyMaxActiveClusters; 0 where the shared
// memory does not fit a CTA) and the clusters one launch runs.
int msfa_grouped_fused_cluster_info(int kind, int H, int D, int B, int G, int* info) {
  using namespace msfa_cluster;
  const bool fits = kind == 2 ? D == 0 && supported(H) : fused_supported(H, D);
  if (kind < 0 || kind > 2 || !fits || B <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  const void* kernels[3][2] = {
      {(const void*)grouped_lstm_fused_cluster_kernel<1>,
       (const void*)grouped_lstm_fused_cluster_kernel<2>},
      {(const void*)grouped_gru_fused_cluster_kernel<1>,
       (const void*)grouped_gru_fused_cluster_kernel<2>},
      {(const void*)grouped_lstm_forward_cluster_kernel<1>,
       (const void*)grouped_lstm_forward_cluster_kernel<2>}};
  info[0] = kCluster;
  for (int mt = 1; mt <= 2; ++mt) {
    const int rows = kTileRows * mt;
    int* slot = info + 1 + 4 * (mt - 1);
    const size_t smem = fused_smem_bytes(H, D, mt);
    slot[0] = fused_threads(H, mt);
    slot[1] = (int)smem;
    slot[2] = 0;
    slot[3] = G * ((B + rows - 1) / rows);
    const void* kernel = kernels[kind][mt - 1];
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
        cudaSuccess) {
      cudaGetLastError();  // more than a CTA may hold: this tiling does not run
      continue;
    }
    cudaLaunchConfig_t config = {};
    cudaLaunchAttribute attr[1];
    fused_cluster_config(config, attr, smem, rows, B, G, H, nullptr);
    cudaError_t err = cudaOccupancyMaxActiveClusters(&slot[2], kernel, &config);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The SIMT body (rnn_cell.cuh) of the two fused recurrences, for the H and D
// the cluster body does not take.
int msfa_grouped_lstm_fused_simt(const float* x, const float* w_ih, const float* w_hh,
                                 const float* bias, const int* lengths, float* out, int T, int G,
                                 int B, int D, int H, void* stream) {
  if (bad_shape(T, G, B, D, H) || D == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H, (size_t)D * kRows);
  cudaError_t err = allow_smem(grouped_lstm_fused_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows, G);
  grouped_lstm_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w_ih, w_hh, bias, lengths, out, T, G, B, D, H);
  return (int)cudaGetLastError();
}

int msfa_grouped_gru_fused_simt(const float* x, const float* w_ih, const float* w_hh,
                                const float* b_ih, const float* b_hh, const int* lengths,
                                float* out, int T, int G, int B, int D, int H, void* stream) {
  if (bad_shape(T, G, B, D, H) || D == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H, (size_t)D * kRows);
  cudaError_t err = allow_smem(grouped_gru_fused_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows, G);
  grouped_gru_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w_ih, w_hh, b_ih, b_hh, lengths, out, T, G, B, D, H);
  return (int)cudaGetLastError();
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
