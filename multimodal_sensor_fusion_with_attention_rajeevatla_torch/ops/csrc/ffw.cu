// Fused feed-forward block, forward and backward, f32, for Hopper (sm_90a).
//
// Replaces: multimodal_sensor_fusion_with_attention_rajeevatla_tpu/ops/pallas_mlp.py
//   _fwd_kernel and _bwd_kernel (launched by _mlp_forward / _mlp_backward,
//   reached by fused_mlp and transformer_ffw(use_fused=True): the feed-forward
//   of a transformer encoder layer in training when the combined
//   residual-LayerNorm kernel is off).
//
// Forward, per row of x [N, D] (W1 [D, F], W2 [F, D], both stored [in, out]):
//   pre = x W1 + b1,  hd = relu(pre) * mask * inv_keep   [N, F]
//   out = hd W2 + b2
// Backward, from dout: recompute pre and hd, then
//   dhd = (dout W2^T) * mask * inv_keep,  dpre = (pre > 0) ? dhd : 0,
//   dx = dpre W1^T,  dW1 = x^T dpre,  db1 = sum dpre,  dW2 = hd^T dout.
//   db2 = sum dout is a column sum the wrapper takes outside, as the TPU
//   version does.
//
// What bounds it on the H100: operations. At the training shape (N = 16384,
// D = 256, F = 2048) the forward does 4*N*D*F = 34.4 GFLOP (0.51 ms at
// 67 TFLOP/s f32) against ~71 MB of x, mask and output (0.02 ms); the
// backward does 10*N*D*F = 85.9 GFLOP (1.28 ms).
//
// Design. The row-tile walk of ffw_tile.cuh: a block
// of 256 threads owns 32 whole rows and walks d_ff in 64-wide chunks, so the
// [N, F] hidden never reaches device memory in the forward (as on the TPU).
// The backward makes one pass over the chunks: pre and hd of the chunk, dhd
// from the block's dout rows in shared memory, dpre, then dx accumulated in
// registers. The TPU kernel summed dW1, db1 and dW2 across its sequential
// grid; here hd and dpre go to scratch ([N, F] each, allocated by the
// wrapper) and a second pass (reduce.cuh) forms the three sums in split row
// blocks: deterministic, no atomics. Rows past N load zeros, are never
// written and add nothing; inv_keep = 0 gives exact zeros.

#include <cuda_runtime.h>

#include "ffw_tile.cuh"
#include "reduce.cuh"

namespace {

using namespace msfa::ffw;

template <int D>
__global__ void __launch_bounds__(kThreads)
ffw_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, const unsigned char* __restrict__ mask,
               float* __restrict__ out, int N, int F, float inv_keep) {
  constexpr int DJ = D / 32;
  extern __shared__ float smem[];
  float* Xs = smem;
  float* Wb = Xs + kRows * D;
  float* Hs = Wb + wbuf_floats<D>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  load_rows<D>(x, row0, N, Xs);
  float acc[4][DJ];
  ffw_tile<D, false>(Xs, w1, b1, w2, mask, nullptr, nullptr, row0, N, F, inv_keep, Wb, Hs, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = row0 + warp * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      out[(long)n * D + c] = acc[i][j] + b2[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
ffw_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const unsigned char* __restrict__ mask, const float* __restrict__ dout,
               float* __restrict__ dx, float* __restrict__ hd_out,
               float* __restrict__ dpre_out, int N, int F, float inv_keep) {
  constexpr int DJ = D / 32;
  extern __shared__ float smem[];
  float* Xs = smem;
  float* Wb = Xs + kRows * D;
  float* Hs = Wb + wbuf_floats<D>();
  float* DYs = Hs + kRows * (kFC + 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  load_rows<D>(x, row0, N, Xs);
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, c = e % D, n = row0 + r;
    DYs[r * (D + 1) + c] = n < N ? dout[(long)n * D + c] : 0.f;
  }

  float dxa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dxa[i][j] = 0.f;

  for (int c0 = 0; c0 < F; c0 += kFC) {
    float pre[4][2], fs[4][2], dhd[4][2];
    chunk_pre<D>(Xs, w1, F, c0, Wb, pre);  // its first barrier also covers DYs
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = row0 + warp * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int f = lane + 32 * jj;
        pre[i][jj] += b1[c0 + f];
        fs[i][jj] = 1.f;
        if (mask) fs[i][jj] = (n < N ? (float)mask[(long)n * F + c0 + f] : 0.f) * inv_keep;
        if (n < N) hd_out[(long)n * F + c0 + f] = fmaxf(pre[i][jj], 0.f) * fs[i][jj];
      }
    }
    chunk_dhd<D>(DYs, w2, c0, Wb, dhd);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = row0 + warp * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int f = lane + 32 * jj;
        const float dp = (n < N && pre[i][jj] > 0.f) ? dhd[i][jj] * fs[i][jj] : 0.f;
        if (n < N) dpre_out[(long)n * F + c0 + f] = dp;
        Hs[(warp * 4 + i) * (kFC + 1) + f] = dp;
      }
    }
    chunk_dx<D>(Hs, w1, F, c0, Wb, dxa);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = row0 + warp * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dx[(long)n * D + lane + 32 * j] = dxa[i][j];
  }
}

template <int D>
int launch_fwd(const float* x, const float* w1, const float* b1, const float* w2,
               const float* b2, const unsigned char* mask, float* out, int N, int F,
               float inv_keep, cudaStream_t s) {
  const int smem = fwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffw_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ffw_fwd_kernel<D><<<(N + kRows - 1) / kRows, kThreads, smem, s>>>(
      x, w1, b1, w2, b2, mask, out, N, F, inv_keep);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const float* x, const float* w1, const float* b1, const float* w2,
               const unsigned char* mask, const float* dout, float* dx, float* dw1,
               float* db1, float* dw2, float* hd, float* dpre, float* atb_part,
               float* col_part, int N, int F, int splits, int col_splits, float inv_keep,
               cudaStream_t s) {
  const int smem = bwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffw_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ffw_bwd_kernel<D><<<(N + kRows - 1) / kRows, kThreads, smem, s>>>(
      x, w1, b1, w2, mask, dout, dx, hd, dpre, N, F, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = msfa::atb(hd, dout, dw2, atb_part, N, F, D, splits, s);  // dW2 = hd^T dout
  if (err != cudaSuccess) return (int)err;
  err = msfa::atb(x, dpre, dw1, atb_part, N, D, F, splits, s);  // dW1 = x^T dpre
  if (err != cudaSuccess) return (int)err;
  return (int)msfa::colsum(dpre, db1, col_part, N, F, col_splits, s);
}

}  // namespace

extern "C" {

// Widths the kernels are instantiated for (D); F must be a multiple of 64.
// The wrapper checks both before calling. mask may be null (no dropout).
int msfa_ffw_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                 const float* b2, const unsigned char* mask, float* out, int N, int D, int F,
                 float inv_keep, void* stream) {
  if (N <= 0 || F <= 0 || F % kFC != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_FFW_FWD(W) launch_fwd<W>(x, w1, b1, w2, b2, mask, out, N, F, inv_keep, s)
  switch (D) {
    case 32: return MSFA_FFW_FWD(32);
    case 64: return MSFA_FFW_FWD(64);
    case 128: return MSFA_FFW_FWD(128);
    case 256: return MSFA_FFW_FWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSFA_FFW_FWD
}

// Scratch: hd, dpre [N, F], atb_part [splits, D, F], col_part [col_splits, F].
int msfa_ffw_bwd(const float* x, const float* w1, const float* b1, const float* w2,
                 const unsigned char* mask, const float* dout, float* dx, float* dw1,
                 float* db1, float* dw2, float* hd, float* dpre, float* atb_part,
                 float* col_part, int N, int D, int F, int splits, int col_splits,
                 float inv_keep, void* stream) {
  if (N <= 0 || F <= 0 || F % kFC != 0 || splits <= 0 || col_splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_FFW_BWD(W)                                                                   \
  launch_bwd<W>(x, w1, b1, w2, mask, dout, dx, dw1, db1, dw2, hd, dpre, atb_part,        \
                col_part, N, F, splits, col_splits, inv_keep, s)
  switch (D) {
    case 32: return MSFA_FFW_BWD(32);
    case 64: return MSFA_FFW_BWD(64);
    case 128: return MSFA_FFW_BWD(128);
    case 256: return MSFA_FFW_BWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSFA_FFW_BWD
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
