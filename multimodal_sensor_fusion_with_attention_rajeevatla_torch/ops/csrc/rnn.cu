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
// What bounds it on the H100: operations. One step of the whole batch is
// 2 G B H (4H + 4D) = 0.14 GFLOP at G 4, B 64, H 256, D 17, about 2 us at the
// f32 peak, against a few KB of input per step; and the T steps depend on
// each other, so the sequence cannot be spread over time.
//
// The TPU kernel keeps W_hh [G, H, 4H] (1 MB per group) and the carries in
// VMEM for the whole sequence and walks a sequential grid of time blocks. An
// SM has 227 KB of shared memory, so here the weights stream: they are read
// again at every step and stay in the 50 MB L2 (4 MB for all groups). The
// chains are independent across groups and batch rows, which the grid uses:
// block (tile of kRows batch rows, group) runs all T steps itself, with no
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
// (gates, c, h) without a further exchange. Two barriers per step. The split
// exists to hide latency, not to add arithmetic: with one half (256 threads,
// 2 warps per scheduler) and 8 rows a step took 27-51 us, each warp waiting
// out the L2 latency of its weight loads between bursts of FMAs.
//
// What a step costs is the weight stream, not the arithmetic: every block
// pulls its group's whole W_hh and W_ih (1.09 MB at H 256, D 17) through its
// SM's port to the L2 at each step, and one SM sustains about 57 GB/s of that
// here (19 us a step for the LSTM, chip_smoke.py on an H100 80GB HBM3 at 700
// W), while its FMAs (2.2 MFLOP a step at kRows = 4) need 5 us. kRows = 4
// gives G B / 4 = 64 blocks, 64 SMs pulling at once, 3.7 TB/s of L2 reads in
// all. With 8 rows (32 blocks) the same script read 11.0 ms (LSTM) and 9.8 ms
// (GRU) at T = 512 against 9.7 and 7.7 with 4; 2 rows would ask the L2 for
// twice what it gives. Also tried and slower: the weights prefetched into L1
// (prefetch.global.L1), and a ring of cp.async weight tiles in shared memory
// (a barrier per 8 weight rows). Only 64 of 132 SMs work, each re-reading
// what it read a step before; keeping the weights on chip by splitting the
// gate columns over a thread-block cluster (h exchanged through distributed
// shared memory) is the design that would lift that.
//
// The input is staged per step: x_t of the tile (kRows x D values), or its
// precomputed projection (kRows x 4H), is copied into shared memory one step
// ahead (cp.async, started at the beginning of the step before), and W_ih is read
// like W_hh (D more rows of the same product), so any D is taken. A block
// stops at the longest length in its tile. No padding of B, T or D: rows past
// the batch are computed as zeros and never written. Offsets are 64-bit
// (x_proj [1024, 4, 64, 1024] has 268 M elements). expf / tanhf, no fast math.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 4;             // batch rows per block
constexpr int kUnroll = 4;           // reduction rows whose weight loads are in flight together
constexpr int kHalf = kRows / 2;     // rows each half of the block finishes
static_assert(kRows % 4 == 0, "a unit's rows are read as 16-byte vectors");
constexpr int kUnits = 256;          // hidden units per pass
constexpr int kThreads = 2 * kUnits; // two halves of the reduction
constexpr int kLstm = 0, kGru = 1;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// one unit's kRows values [unit][row] as 16-byte accesses
__device__ __forceinline__ void load_rows(const float* p, float (&v)[kRows]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < kRows / 4; ++i) {
    const float4 t = p4[i];
    v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
  }
}

// acc[slot][r] += sum_{k0 <= k < k1} v[k][r] * W[k][q * H + j] for the NG gate
// columns q of unit j; gate 2 goes to slot S2 (the GRU keeps the input and
// hidden parts of its candidate gate apart), the others to their own index.
template <int NG, int S2>
__device__ __forceinline__ void accumulate(const float* __restrict__ W, int k0, int k1, int H,
                                           int j, const float* v, float (&acc)[4][kRows]) {
  const size_t ld = (size_t)NG * H;
#pragma unroll kUnroll
  for (int k = k0; k < k1; ++k) {
    const float* wk = W + k * ld + j;
    float w[NG];
#pragma unroll
    for (int q = 0; q < NG; ++q) w[q] = __ldg(wk + q * H);
    float hv[kRows];
    load_rows(v + k * kRows, hv);
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const int slot = q == 2 ? S2 : q;
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[slot][r] = fmaf(hv[r], w[q], acc[slot][r]);
    }
  }
}

// x_t of the tile -> shared memory [d][row], asynchronously; rows past the
// batch keep the zeros the buffer was initialised with
__device__ __forceinline__ void stage_input(const float* __restrict__ x, float* x_s, int t, int g,
                                            int b0, int G, int B, int D) {
  const float* src = x + (((size_t)t * G + g) * B + b0) * D;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (b0 + r < B) __pipeline_memcpy_async(x_s + d * kRows + r, src + i, sizeof(float));
  }
  __pipeline_commit();
}

// x_proj_t of the tile -> shared memory [row][4H], asynchronously, 16 bytes a copy
__device__ __forceinline__ void stage_projection(const float* __restrict__ x_proj, float* xp_s,
                                                 int t, int g, int b0, int G, int B, int cols) {
  const float* src = x_proj + (((size_t)t * G + g) * B + b0) * cols;
  const int quads = cols / 4;
  for (int i = threadIdx.x; i < kRows * quads; i += kThreads) {
    const int r = i / quads;
    if (b0 + r < B) __pipeline_memcpy_async(xp_s + 4 * i, src + 4 * i, sizeof(float4));
  }
  __pipeline_commit();
}

// half HALF hands the partial sums of the other half's rows over
template <int HALF>
__device__ __forceinline__ void hand_over(const float (&acc)[4][kRows], float* red_s, int u) {
  float* dst = red_s + (1 - HALF) * 4 * kHalf * kUnits + u;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int rr = 0; rr < kHalf; ++rr)
      dst[(q * kHalf + rr) * kUnits] = acc[q][(1 - HALF) * kHalf + rr];
}

// half HALF adds what it received and finishes its rows of unit j: gates, c, h
// (xp: this tile's precomputed projection [row][4H] in shared memory, or null)
template <int CELL, int HALF>
__device__ __forceinline__ void finish(const float (&acc)[4][kRows], const float* red_s, int u,
                                       int j, const float* xp, int H, const float (&ba)[4],
                                       const float (&bb)[4], const int* len_s, int t,
                                       const float* h_cur, float* h_nxt, float* c_s) {
  const float* src = red_s + HALF * 4 * kHalf * kUnits + u;
  const int at = j * kRows + HALF * kHalf;
#pragma unroll
  for (int rr = 0; rr < kHalf; ++rr) {
    float z[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      z[q] = acc[q][HALF * kHalf + rr] + src[(q * kHalf + rr) * kUnits];
      if (xp != nullptr) z[q] += xp[(HALF * kHalf + rr) * 4 * H + q * H + j];
    }
    const float keep = t < len_s[HALF * kHalf + rr] ? 1.f : 0.f;
    const float h_old = h_cur[at + rr];
    float h;
    if (CELL == kLstm) {
      const float gi = sigmoid(z[0] + ba[0]);
      const float gf = sigmoid(z[1] + ba[1]);
      const float gg = tanhf(z[2] + ba[2]);
      const float go = sigmoid(z[3] + ba[3]);
      const float c_old = c_s[at + rr];
      const float c = gf * c_old + gi * gg;
      h = go * tanhf(c);
      c_s[at + rr] = keep * c + (1.f - keep) * c_old;
    } else {
      // slot 2 holds h W_hn, slot 3 x W_in: b_hn stays inside the reset gate
      const float gr = sigmoid(z[0] + ba[0] + bb[0]);
      const float gz = sigmoid(z[1] + ba[1] + bb[1]);
      const float gn = tanhf(z[3] + ba[2] + gr * (z[2] + bb[2]));
      h = (1.f - gz) * gn + gz * h_old;
    }
    h_nxt[at + rr] = keep * h + (1.f - keep) * h_old;
  }
}

// CELL: kLstm or kGru. PROJ: `in` is raw x [T, G, B, D] and w_ih [G, D, NG*H]
// projects it here; else `in` is x_proj [T, G, B, NG*H]. bias_a is the one
// additive bias of the LSTM, b_ih of the GRU; bias_b is b_hh of the GRU.
template <int CELL, bool PROJ>
__device__ __forceinline__ void recurrence(const float* __restrict__ in,
                                           const float* __restrict__ w_ih,
                                           const float* __restrict__ w_hh,
                                           const float* __restrict__ bias_a,
                                           const float* __restrict__ bias_b,
                                           const int* __restrict__ lengths,
                                           float* __restrict__ out, int T, int G, int B, int D,
                                           int H) {
  constexpr int NG = CELL == kLstm ? 4 : 3;
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // [2][H][kRows]
  float* c_s = h_s + 2 * H * kRows;              // [H][kRows]
  // the staged input, two buffers: x_t [D][kRows], or x_proj_t [kRows][4H]
  const int staged = PROJ ? D * kRows : kRows * NG * H;
  float* x_s = c_s + H * kRows;
  float* red_s = x_s + 2 * staged;  // [2][4][kHalf][kUnits] partial sums
  __shared__ int len_s[kRows];

  const int g = blockIdx.y, b0 = blockIdx.x * kRows, tid = threadIdx.x;
  const int u = tid % kUnits, half = tid / kUnits;  // a warp lies in one half
  if (tid < kRows) {
    const int b = b0 + tid;
    len_s[tid] = b < B ? min(max(lengths[b], 0), T) : 0;
  }
  for (int i = tid; i < 3 * H * kRows + 2 * staged; i += kThreads) h_s[i] = 0.f;  // h, c, input
  __syncthreads();
  int t_end = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) t_end = max(t_end, len_s[r]);
  if (t_end > 0) {
    if (PROJ) stage_input(in, x_s, 0, g, b0, G, B, D);
    else stage_projection(in, x_s, 0, g, b0, G, B, NG * H);
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  const size_t gate_cols = (size_t)NG * H;
  const float* whh_g = w_hh + (size_t)g * H * gate_cols;
  const float* wih_g = PROJ ? w_ih + (size_t)g * D * gate_cols : nullptr;
  // this half's part of each reduction
  const int h_mid = (H + 1) / 2, d_mid = (D + 1) / 2;
  const int hk0 = half ? h_mid : 0, hk1 = half ? H : h_mid;
  const int dk0 = half ? d_mid : 0, dk1 = half ? D : d_mid;
  int cur = 0;
  for (int t = 0; t < t_end; ++t) {
    const float* h_cur = h_s + cur * H * kRows;
    float* h_nxt = h_s + (cur ^ 1) * H * kRows;
    if (t + 1 < t_end) {  // the next step's input arrives while this one computes
      if (PROJ) stage_input(in, x_s + (cur ^ 1) * staged, t + 1, g, b0, G, B, D);
      else stage_projection(in, x_s + (cur ^ 1) * staged, t + 1, g, b0, G, B, NG * H);
    }
    for (int j0 = 0; j0 < H; j0 += kUnits) {
      const int j = j0 + u;
      const bool active = j < H;
      float acc[4][kRows];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[q][r] = 0.f;
      float ba[4] = {0.f, 0.f, 0.f, 0.f}, bb[4] = {0.f, 0.f, 0.f, 0.f};
      if (active) {
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          ba[q] = __ldg(bias_a + g * gate_cols + q * H + j);
          if (CELL == kGru) bb[q] = __ldg(bias_b + g * gate_cols + q * H + j);
        }
        accumulate<NG, 2>(whh_g, hk0, hk1, H, j, h_cur, acc);
        if (PROJ)
          accumulate<NG, CELL == kGru ? 3 : 2>(wih_g, dk0, dk1, H, j, x_s + cur * staged, acc);
        if (half == 0) hand_over<0>(acc, red_s, u); else hand_over<1>(acc, red_s, u);
      }
      __syncthreads();  // the partial sums are in place
      if (active) {
        const float* xp = PROJ ? nullptr : x_s + cur * staged;
        if (half == 0)
          finish<CELL, 0>(acc, red_s, u, j, xp, H, ba, bb, len_s, t, h_cur, h_nxt, c_s);
        else
          finish<CELL, 1>(acc, red_s, u, j, xp, H, ba, bb, len_s, t, h_cur, h_nxt, c_s);
      }
      if (j0 + kUnits < H) __syncthreads();  // the next pass reuses the exchange buffer
    }
    __pipeline_wait_prior(0);
    __syncthreads();  // the new h and the next input are in place
    cur ^= 1;
  }

  const float* h_fin = h_s + cur * H * kRows;
  for (int j = tid; j < H; j += kThreads)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (b0 + r < B) out[((size_t)g * B + b0 + r) * H + j] = h_fin[j * kRows + r];
}

__global__ void __launch_bounds__(kThreads)
grouped_lstm_forward_kernel(const float* __restrict__ x_proj, const float* __restrict__ w_hh,
                            const float* __restrict__ b_hh, const int* __restrict__ lengths,
                            float* __restrict__ out, int T, int G, int B, int H) {
  recurrence<kLstm, false>(x_proj, nullptr, w_hh, b_hh, nullptr, lengths, out, T, G, B, 0, H);
}

__global__ void __launch_bounds__(kThreads)
grouped_lstm_fused_kernel(const float* __restrict__ x, const float* __restrict__ w_ih,
                          const float* __restrict__ w_hh, const float* __restrict__ bias,
                          const int* __restrict__ lengths, float* __restrict__ out, int T, int G,
                          int B, int D, int H) {
  recurrence<kLstm, true>(x, w_ih, w_hh, bias, nullptr, lengths, out, T, G, B, D, H);
}

__global__ void __launch_bounds__(kThreads)
grouped_gru_fused_kernel(const float* __restrict__ x, const float* __restrict__ w_ih,
                         const float* __restrict__ w_hh, const float* __restrict__ b_ih,
                         const float* __restrict__ b_hh, const int* __restrict__ lengths,
                         float* __restrict__ out, int T, int G, int B, int D, int H) {
  recurrence<kGru, true>(x, w_ih, w_hh, b_ih, b_hh, lengths, out, T, G, B, D, H);
}

// h (two buffers), c, the staged input (two buffers of `staged` floats), the exchange buffer
size_t smem_bytes(int H, size_t staged) {
  return sizeof(float) * ((size_t)3 * H * kRows + 2 * staged + 2 * 4 * kHalf * kUnits);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int T, int G, int B, int D, int H) {
  return T < 0 || G <= 0 || B <= 0 || D < 0 || H <= 0;
}

}  // namespace

extern "C" {

int msfa_grouped_lstm_forward(const float* x_proj, const float* w_hh, const float* b_hh,
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

int msfa_grouped_lstm_fused(const float* x, const float* w_ih, const float* w_hh,
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

int msfa_grouped_gru_fused(const float* x, const float* w_ih, const float* w_hh,
                           const float* b_ih, const float* b_hh, const int* lengths, float* out,
                           int T, int G, int B, int D, int H, void* stream) {
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
