// Fused out-projection + residual dropout + add + LayerNorm, forward and
// backward, f32, for Hopper (sm_90a).
//
// Replaces: multimodal_sensor_fusion_with_attention_rajeevatla_tpu/ops/pallas_mlp.py
//   _proj_ln_fwd_kernel and _proj_ln_bwd_kernel (launched by _proj_ln_forward /
//   _proj_ln_backward, reached by fused_proj_residual_ln: the first half of a
//   transformer encoder layer in training).
//
// Forward, per row of x, a [N, D] (Wo [D, D] stored [in, out]):
//   y   = (a Wo + bo) * rmask * inv_keep        (mask optional, u8)
//   out = LayerNorm(x + y)                        flax: fast variance, eps
// Backward, from dout: recompute y and the row statistics, then
//   dr = (g - mean(g) - xhat * mean(g * xhat)) * inv,   g = dout * gamma
//   dx = dr,  dy = dr * rmask * inv_keep,  da = dy Wo^T,
//   dWo = a^T dy, dbo = sum dy, dgamma = sum dout * xhat, dbeta = sum dout.
//
// What bounds it on the H100: at the training shape (N = 16384, D = 256) the
// forward does 2*N*D*D = 2.1 GFLOP against 50 MB (x, a, mask in, out back),
// the backward 6*N*D*D = 6.4 GFLOP against ~100 MB; in f32 on the CUDA cores
// (67 TFLOP/s) both are operation-bound (0.03 ms and 0.10 ms) by a small
// margin over the bytes (0.015 ms and 0.03 ms).
//
// Design: one block of 256 threads owns 32 whole rows (8 warps x 4 rows), so
// the LayerNorm is an epilogue: each warp holds its 4 rows' D columns (lane
// + 32 j) in registers and takes the row sums with shuffles. Wo streams
// through shared memory in 32-row slices. The TPU kernel carried dWo, dbo,
// dgamma and dbeta across its sequential grid; here the backward writes per-
// block column partials and dy, and a second pass sums them (reduce.cuh):
// deterministic, no atomics. A row past N (the last block's tail) loads
// zeros, is never written and adds nothing to any sum.

#include <cuda_runtime.h>
#include <math.h>

#include "reduce.cuh"

namespace {

constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr int kK = 32;  // depth of one streamed weight slice

template <int D>
constexpr int fwd_smem_floats() {
  return kRows * kK + D * (kK + 1);
}

template <int D>
constexpr int bwd_smem_floats() {
  // As, Ws (forward slices [kK][D] or transposed [D][kK+1]), DYs, per-warp partials
  return kRows * kK + D * (kK + 1) + kRows * (D + 1) + 8 * 3 * D;
}

// acc[i][j] = (a Wo)[row0 + warp*4 + i][lane + 32 j], a [N, D], Wo [D, D].
template <int D>
__device__ __forceinline__ void tile_product(const float* __restrict__ a,
                                             const float* __restrict__ wo,
                                             int row0, int N, float* As, float* Ws,
                                             float (&acc)[4][D / 32]) {
  constexpr int DJ = D / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kK) {
    __syncthreads();
    for (int e = tid; e < kRows * kK; e += kThreads) {
      const int r = e / kK, c = e % kK, n = row0 + r;
      As[e] = n < N ? a[(long)n * D + k0 + c] : 0.f;
    }
    for (int e = tid; e < kK * D; e += kThreads) Ws[e] = wo[(long)k0 * D + e];
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      float wv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) wv[j] = Ws[kk * D + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = As[(warp * 4 + i) * kK + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
proj_ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ wo, const float* __restrict__ bo,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const unsigned char* __restrict__ rmask, float* __restrict__ out,
                   int N, float inv_keep, float eps) {
  constexpr int DJ = D / 32;
  extern __shared__ float smem[];
  float* As = smem;
  float* Ws = As + kRows * kK;
  const int row0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[4][DJ];
  tile_product<D>(a, wo, row0, N, As, Ws, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = row0 + warp * 4 + i;
    if (n >= N) continue;  // warp-uniform
    float r[DJ], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      float y = acc[i][j] + bo[c];
      if (rmask) y *= (float)rmask[(long)n * D + c] * inv_keep;
      r[j] = x[(long)n * D + c] + y;
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
proj_ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ wo, const float* __restrict__ bo,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const unsigned char* __restrict__ rmask,
                   const float* __restrict__ dout, float* __restrict__ dx,
                   float* __restrict__ da, float* __restrict__ dy_out,
                   float* __restrict__ partial, int N, float inv_keep, float eps) {
  constexpr int DJ = D / 32;
  extern __shared__ float smem[];
  float* As = smem;
  float* Ws = As + kRows * kK;
  float* DYs = Ws + D * (kK + 1);
  float* Red = DYs + kRows * (D + 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  (void)beta;  // the LayerNorm backward does not read beta

  float acc[4][DJ];
  tile_product<D>(a, wo, row0, N, As, Ws, acc);

  float pg[DJ], pb[DJ], po[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) pg[j] = pb[j] = po[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = warp * 4 + i, n = row0 + row;
    if (n >= N) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) DYs[row * (D + 1) + lane + 32 * j] = 0.f;
      continue;
    }
    float r[DJ], rs[DJ], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      float y = acc[i][j] + bo[c];
      rs[j] = rmask ? (float)rmask[(long)n * D + c] * inv_keep : 1.f;
      if (rmask) y *= rs[j];
      r[j] = x[(long)n * D + c] + y;
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
      dx[(long)n * D + c] = dr;
      dy_out[(long)n * D + c] = dy;
      DYs[row * (D + 1) + c] = dy;
      pg[j] += g[j] * xh[j];
      pb[j] += g[j];
      po[j] += dy;
    }
  }
  // column partials of this block: dgamma | dbeta | dbo
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

  // da = dy Wo^T: Wo streams as transposed 32-column slices
  float dacc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dacc[i][j] = 0.f;
  for (int o0 = 0; o0 < D; o0 += kK) {
    __syncthreads();
    for (int e = tid; e < D * kK; e += kThreads) {
      const int ii = e / kK, oo = e % kK;
      Ws[ii * (kK + 1) + oo] = wo[(long)ii * D + o0 + oo];
    }
    __syncthreads();
#pragma unroll 8
    for (int oo = 0; oo < kK; ++oo) {
      float wv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) wv[j] = Ws[(lane + 32 * j) * (kK + 1) + oo];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dyv = DYs[(warp * 4 + i) * (D + 1) + o0 + oo];
#pragma unroll
        for (int j = 0; j < DJ; ++j) dacc[i][j] = fmaf(dyv, wv[j], dacc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = row0 + warp * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) da[(long)n * D + lane + 32 * j] = dacc[i][j];
  }
}

template <int D>
int launch_fwd(const float* x, const float* a, const float* wo, const float* bo,
               const float* gamma, const float* beta, const unsigned char* rmask,
               float* out, int N, float inv_keep, float eps, cudaStream_t s) {
  const int smem = fwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      proj_ln_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  proj_ln_fwd_kernel<D><<<(N + kRows - 1) / kRows, kThreads, smem, s>>>(
      x, a, wo, bo, gamma, beta, rmask, out, N, inv_keep, eps);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const float* x, const float* a, const float* wo, const float* bo,
               const float* gamma, const float* beta, const unsigned char* rmask,
               const float* dout, float* dx, float* da, float* dwo, float* sums,
               float* dy, float* partial, float* atb_part, int N, int splits,
               float inv_keep, float eps, cudaStream_t s) {
  const int smem = bwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      proj_ln_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kRows - 1) / kRows;
  proj_ln_bwd_kernel<D><<<blocks, kThreads, smem, s>>>(
      x, a, wo, bo, gamma, beta, rmask, dout, dx, da, dy, partial, N, inv_keep, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msfa::reduce_splits_kernel<<<(3 * D + 255) / 256, 256, 0, s>>>(partial, sums, blocks, 3L * D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)msfa::atb(a, dy, dwo, atb_part, N, D, D, splits, s);
}

}  // namespace

extern "C" {

// Widths the kernels are instantiated for; the wrapper checks before calling.
int msfa_proj_ln_fwd(const float* x, const float* a, const float* wo, const float* bo,
                     const float* gamma, const float* beta, const unsigned char* rmask,
                     float* out, int N, int D, float inv_keep, float eps, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_fwd<32>(x, a, wo, bo, gamma, beta, rmask, out, N, inv_keep, eps, s);
    case 64: return launch_fwd<64>(x, a, wo, bo, gamma, beta, rmask, out, N, inv_keep, eps, s);
    case 128: return launch_fwd<128>(x, a, wo, bo, gamma, beta, rmask, out, N, inv_keep, eps, s);
    case 256: return launch_fwd<256>(x, a, wo, bo, gamma, beta, rmask, out, N, inv_keep, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// sums [3, D] receives dgamma | dbeta | dbo; dy [N, D], partial [ceil(N/32), 3, D]
// and atb_part [splits, D, D] are scratch.
int msfa_proj_ln_bwd(const float* x, const float* a, const float* wo, const float* bo,
                     const float* gamma, const float* beta, const unsigned char* rmask,
                     const float* dout, float* dx, float* da, float* dwo, float* sums,
                     float* dy, float* partial, float* atb_part, int N, int D, int splits,
                     float inv_keep, float eps, void* stream) {
  if (N <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_PROJ_BWD(W)                                                                   \
  launch_bwd<W>(x, a, wo, bo, gamma, beta, rmask, dout, dx, da, dwo, sums, dy, partial,   \
                atb_part, N, splits, inv_keep, eps, s)
  switch (D) {
    case 32: return MSFA_PROJ_BWD(32);
    case 64: return MSFA_PROJ_BWD(64);
    case 128: return MSFA_PROJ_BWD(128);
    case 256: return MSFA_PROJ_BWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSFA_PROJ_BWD
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
