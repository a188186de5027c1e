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
// shared memory) is the design that would lift that. On the precomputed-
// projection path (grouped_lstm_forward) the unrolled loop left one weight
// load in flight at a time (30.1 us a step); that path loads the weights of
// 16 rows into registers before their FMAs (rnn_cell.cuh `accumulate`) and
// reads 14.8 us a step (chip_smoke.py, same card).
//
// The input is staged per step: x_t of the tile (kRows x D values), or its
// precomputed projection (kRows x 4H), is copied into shared memory one step
// ahead (cp.async, started at the beginning of the step before), and W_ih is read
// like W_hh (D more rows of the same product), so any D is taken. A block
// stops at the longest length in its tile. No padding of B, T or D: rows past
// the batch are computed as zeros and never written. Offsets are 64-bit
// (x_proj [1024, 4, 64, 1024] has 268 M elements). expf / tanhf, no fast math.
//
// The recurrence body is in rnn_cell.cuh: the training forward of rnn_train.cu
// is the same body with per-step residual stores.

#include "rnn_cell.cuh"

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
