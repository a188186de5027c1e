// Fused feed-forward + residual dropout + add + LayerNorm, forward and
// backward, f32, for Hopper (sm_90a).
//
// Replaces: multimodal_sensor_fusion_with_attention_rajeevatla_tpu/ops/pallas_mlp.py
//   _ffw_ln_fwd_kernel and _ffw_ln_bwd_kernel (launched by _ffw_ln_forward /
//   _ffw_ln_backward, reached by fused_mlp_residual_ln: the second half of a
//   transformer encoder layer in training).
//
// Forward, per row of x [N, D] (W1 [D, F], W2 [F, D], both stored [in, out]):
//   pre = x W1 + b1,  hd = relu(pre) * fmask * inv_keep          [N, F]
//   y   = (hd W2 + b2) * rmask * inv_keep,  out = LayerNorm(x + y)
// Backward, from dout: recompute pre, hd, y and the row statistics, then
//   dr = LayerNorm backward,  dy = dr * rmask * inv_keep,
//   dpre = (pre > 0) * (dy W2^T) * fmask * inv_keep,  dx = dr + dpre W1^T,
//   dW1 = x^T dpre, db1 = sum dpre, dW2 = hd^T dy, db2 = sum dy,
//   dgamma = sum dout * xhat, dbeta = sum dout.
//
// What bounds it on the H100: operations. At the training shape (N = 16384,
// D = 256, F = 2048) the forward does 4*N*D*F = 34.4 GFLOP (0.51 ms at
// 67 TFLOP/s f32) against ~104 MB of x, masks and output (0.03 ms); the
// backward does 12*N*D*F = 103 GFLOP (1.54 ms).
//
// Design (the row-tile walk itself is in ffw_tile.cuh, shared with ffw.cu).
// Forward: one block of 256 threads owns 32 whole rows and keeps them
// in shared memory; it walks d_ff in 64-wide chunks: pre for the chunk (W1
// streaming in 32-row slices), ReLU and the hidden mask, then y += h W2[chunk]
// into a [32, D] accumulator held in registers (4 rows x D/32 columns per
// thread). The [N, F] hidden never reaches device memory, as on the TPU; the
// LayerNorm is the epilogue (each warp owns 4 whole rows). Backward: the same
// block recomputes the forward, writing pre and hd to scratch ([N, F] each,
// allocated by the wrapper), takes the LayerNorm backward, then walks d_ff
// again for dpre (overwriting pre in place) and accumulates dx in registers.
// The TPU kernel summed dW1, dW2 and the bias/LN gradients across its
// sequential grid; here per-block partials and the scratch feed a second
// pass (reduce.cuh): deterministic, no atomics. Rows past N load zeros, are
// never written and add nothing.

#include <cuda_runtime.h>
#include <math.h>

#include "ffw_tile.cuh"
#include "reduce.cuh"

namespace {

using namespace msfa::ffw;  // the row-tile walk shared with ffw.cu

template <int D>
__global__ void __launch_bounds__(kThreads)
ffw_ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const unsigned char* __restrict__ fmask,
                  const unsigned char* __restrict__ rmask, float* __restrict__ out,
                  int N, int F, float inv_keep, float eps) {
  constexpr int DJ = D / 32;
  extern __shared__ float smem[];
  float* Xs = smem;
  float* Wb = Xs + kRows * D;
  float* Hs = Wb + wbuf_floats<D>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  load_rows<D>(x, row0, N, Xs);
  float acc[4][DJ];
  ffw_tile<D, false>(Xs, w1, b1, w2, fmask, nullptr, nullptr, row0, N, F, inv_keep, Wb, Hs, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = warp * 4 + i, n = row0 + row;
    if (n >= N) continue;  // warp-uniform
    float r[DJ], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      float y = acc[i][j] + b2[c];
      if (rmask) y *= (float)rmask[(long)n * D + c] * inv_keep;
      r[j] = Xs[row * D + c] + y;
      s1 += r[j];
      s2 += r[j] * r[j];
    }
    const float mu = msfa::warp_sum(s1) / D;
    const float var = fmaxf(msfa::warp_sum(s2) / D - mu * mu, 0.f);
    const float inv = 1.f / sqrtf(var + eps);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      out[(long)n * D + c] = (r[j] - mu) * inv * gamma[c] + beta[c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
ffw_ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ gamma,
                  const unsigned char* __restrict__ fmask,
                  const unsigned char* __restrict__ rmask, const float* __restrict__ dout,
                  float* __restrict__ dx, float* __restrict__ hd_out,
                  float* __restrict__ dpre_out, float* __restrict__ dy_out,
                  float* __restrict__ partial, int N, int F, float inv_keep, float eps) {
  constexpr int DJ = D / 32;
  extern __shared__ float smem[];
  float* Xs = smem;
  float* Wb = Xs + kRows * D;
  float* Hs = Wb + wbuf_floats<D>();
  float* DYs = Hs + kRows * (kFC + 1);
  float* Red = Xs;  // after the epilogue has read the residual rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  load_rows<D>(x, row0, N, Xs);

  // 1. recompute the forward; pre goes to dpre_out, hd to hd_out
  float acc[4][DJ];
  ffw_tile<D, true>(Xs, w1, b1, w2, fmask, dpre_out, hd_out, row0, N, F, inv_keep, Wb, Hs, acc);

  // 2. LayerNorm backward; dx starts at dr
  float dxa[4][DJ], pg[DJ], pb[DJ], po[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) pg[j] = pb[j] = po[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = warp * 4 + i, n = row0 + row;
    if (n >= N) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dxa[i][j] = 0.f;
        DYs[row * (D + 1) + lane + 32 * j] = 0.f;
      }
      continue;
    }
    float r[DJ], rs[DJ], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      float y = acc[i][j] + b2[c];
      rs[j] = rmask ? (float)rmask[(long)n * D + c] * inv_keep : 1.f;
      if (rmask) y *= rs[j];
      r[j] = Xs[row * D + c] + y;
      s1 += r[j];
      s2 += r[j] * r[j];
    }
    const float mu = msfa::warp_sum(s1) / D;
    const float var = fmaxf(msfa::warp_sum(s2) / D - mu * mu, 0.f);
    const float inv = 1.f / sqrtf(var + eps);
    float xh[DJ], gd[DJ], g[DJ], sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      xh[j] = (r[j] - mu) * inv;
      g[j] = dout[(long)n * D + c];
      gd[j] = g[j] * gamma[c];
      sg += gd[j];
      sgx += gd[j] * xh[j];
    }
    const float mean_g = msfa::warp_sum(sg) / D;
    const float mean_gx = msfa::warp_sum(sgx) / D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      const float dr = (gd[j] - mean_g - xh[j] * mean_gx) * inv;
      const float dy = rmask ? dr * rs[j] : dr;
      dxa[i][j] = dr;
      dy_out[(long)n * D + c] = dy;
      DYs[row * (D + 1) + c] = dy;
      pg[j] += g[j] * xh[j];
      pb[j] += g[j];
      po[j] += dy;
    }
  }
  __syncthreads();  // every warp is done with Xs before it holds the partials
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    const int c = lane + 32 * j;
    Red[(warp * 3 + 0) * D + c] = pg[j];
    Red[(warp * 3 + 1) * D + c] = pb[j];
    Red[(warp * 3 + 2) * D + c] = po[j];
  }
  __syncthreads();
  for (int e = tid; e < 3 * D; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += Red[w * 3 * D + e];
    partial[(long)blockIdx.x * 3 * D + e] = s;
  }

  // 3. back through the FFW, chunk by chunk
  for (int c0 = 0; c0 < F; c0 += kFC) {
    float dhd[4][2];
    chunk_dhd<D>(DYs, w2, c0, Wb, dhd);  // dhd = dy W2[chunk]^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = row0 + warp * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int f = lane + 32 * jj;
        float dp = 0.f;
        if (n < N) {
          const long at = (long)n * F + c0 + f;
          const float fs = fmask ? (float)fmask[at] * inv_keep : 1.f;
          dp = dpre_out[at] > 0.f ? dhd[i][jj] * fs : 0.f;  // this thread wrote pre here
          dpre_out[at] = dp;
        }
        Hs[(warp * 4 + i) * (kFC + 1) + f] = dp;
      }
    }
    chunk_dx<D>(Hs, w1, F, c0, Wb, dxa);  // dx += dpre W1[:, chunk]^T
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
               const float* b2, const float* gamma, const float* beta,
               const unsigned char* fmask, const unsigned char* rmask, float* out, int N,
               int F, float inv_keep, float eps, cudaStream_t s) {
  const int smem = fwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffw_ln_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ffw_ln_fwd_kernel<D><<<(N + kRows - 1) / kRows, kThreads, smem, s>>>(
      x, w1, b1, w2, b2, gamma, beta, fmask, rmask, out, N, F, inv_keep, eps);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const float* x, const float* w1, const float* b1, const float* w2,
               const float* b2, const float* gamma, const unsigned char* fmask,
               const unsigned char* rmask, const float* dout, float* dx, float* dw1,
               float* db1, float* dw2, float* sums, float* hd, float* dpre, float* dy,
               float* partial, float* atb_part, float* col_part, int N, int F,
               int splits, int col_splits, float inv_keep, float eps, cudaStream_t s) {
  const int smem = bwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffw_ln_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kRows - 1) / kRows;
  ffw_ln_bwd_kernel<D><<<blocks, kThreads, smem, s>>>(
      x, w1, b1, w2, b2, gamma, fmask, rmask, dout, dx, hd, dpre, dy, partial, N, F,
      inv_keep, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msfa::reduce_splits_kernel<<<(3 * D + 255) / 256, 256, 0, s>>>(partial, sums, blocks, 3L * D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = msfa::atb(hd, dy, dw2, atb_part, N, F, D, splits, s);  // dW2 = hd^T dy
  if (err != cudaSuccess) return (int)err;
  err = msfa::atb(x, dpre, dw1, atb_part, N, D, F, splits, s);  // dW1 = x^T dpre
  if (err != cudaSuccess) return (int)err;
  return (int)msfa::colsum(dpre, db1, col_part, N, F, col_splits, s);
}

}  // namespace

extern "C" {

// Widths the kernels are instantiated for (D); F must be a multiple of 64.
// The wrapper checks both before calling.
int msfa_ffw_ln_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                    const float* b2, const float* gamma, const float* beta,
                    const unsigned char* fmask, const unsigned char* rmask, float* out,
                    int N, int D, int F, float inv_keep, float eps, void* stream) {
  if (N <= 0 || F <= 0 || F % kFC != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_FFW_FWD(W) \
  launch_fwd<W>(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, out, N, F, inv_keep, eps, s)
  switch (D) {
    case 32: return MSFA_FFW_FWD(32);
    case 64: return MSFA_FFW_FWD(64);
    case 128: return MSFA_FFW_FWD(128);
    case 256: return MSFA_FFW_FWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSFA_FFW_FWD
}

// sums [3, D] receives dgamma | dbeta | db2. Scratch: hd, dpre [N, F], dy [N, D],
// partial [ceil(N/32), 3, D], atb_part [splits, D, F], col_part [col_splits, F].
int msfa_ffw_ln_bwd(const float* x, const float* w1, const float* b1, const float* w2,
                    const float* b2, const float* gamma, const unsigned char* fmask,
                    const unsigned char* rmask, const float* dout, float* dx, float* dw1,
                    float* db1, float* dw2, float* sums, float* hd, float* dpre, float* dy,
                    float* partial, float* atb_part, float* col_part, int N, int D, int F,
                    int splits, int col_splits, float inv_keep, float eps, void* stream) {
  if (N <= 0 || F <= 0 || F % kFC != 0 || splits <= 0 || col_splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_FFW_BWD(W)                                                                  \
  launch_bwd<W>(x, w1, b1, w2, b2, gamma, fmask, rmask, dout, dx, dw1, db1, dw2, sums,  \
                hd, dpre, dy, partial, atb_part, col_part, N, F, splits, col_splits,    \
                inv_keep, eps, s)
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
