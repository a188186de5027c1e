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
// the backward 6*N*D*D = 6.4 GFLOP against ~100 MB: operations, 0.03 ms and
// 0.10 ms on the CUDA cores (67 TFLOP/s), the backward 0.04 ms as 3xTF32 on
// the tensor cores (165 TFLOP/s), over the bytes (0.015 ms and 0.03 ms).
//
// Forward, on the CUDA cores: one block of 256 threads owns 32 whole rows (8
// warps x 4 rows), so the LayerNorm is an epilogue: each warp holds its 4
// rows' D columns (lane + 32 j) in registers and takes the row sums with
// shuffles. Wo streams through shared memory in 32-row slices.
//
// Backward: three products on the TF32 tensor cores at f32 accuracy
// (3xTF32), each a tile of tc_product.cuh's template, on the bodies that
// residual_ln.cuh shares with ffw_ln.cu's:
//   ln:   y = a Wo + bo on 64 whole rows; its epilogue is the LayerNorm
//         backward: dx = dr, dy, and per-block partials of dgamma, dbeta
//         and dbo (ln_bwd_tile)
//   da:   da = dy Wo^T on 64 whole rows (dx_tile)
//   dw:   dWo = a^T dy per split of the rows (grad_tile)
//   sum:  the splits and the per-block partials, added in order
// The TPU kernel carried dWo, dbo, dgamma and dbeta across its sequential
// grid; here every sum across blocks is partials added in a fixed order:
// deterministic, no atomics. A row past N (the last block's tail) loads
// zeros, is never written and adds nothing to any sum.

#include <cuda_runtime.h>
#include <math.h>

#include "residual_ln.cuh"

namespace {

constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr int kK = 32;  // depth of one streamed weight slice

template <int D>
constexpr int fwd_smem_floats() {
  return kRows * kK + D * (kK + 1);
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
    const float mu = msfa_ln::warp_sum(s1) / D;
    const float var = fmaxf(msfa_ln::warp_sum(s2) / D - mu * mu, 0.f);
    const float inv = 1.f / sqrtf(var + eps);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      out[(long)n * D + c] = (r[j] - mu) * inv * gamma[c] + beta[c];
    }
  }
}

// y = a Wo + bo for 64 whole rows, then the LayerNorm backward: dx = dr, dy,
// and the block's sums over its rows of dout * xhat | dout | dy
template <int D>
__global__ void __launch_bounds__(msfa_ln::LnProduct<D>::kThreads)
proj_ln_bwd_ln_kernel(const float* __restrict__ a, const float* __restrict__ wo,
                      const float* __restrict__ bo, const float* __restrict__ x,
                      const float* __restrict__ gamma, const unsigned char* __restrict__ rmask,
                      const float* __restrict__ dout, float* __restrict__ dx,
                      float* __restrict__ dy, float* __restrict__ part, int N, float inv_keep,
                      float eps) {
  extern __shared__ __align__(16) float smem[];
  msfa_ln::ln_bwd_tile<D>(a, D, wo, bo, x, gamma, rmask, dout, dx, dy, part, N, inv_keep, eps,
                          smem);
}

// da = dy Wo^T for 64 whole rows
template <int D>
__global__ void __launch_bounds__(msfa_ln::DxProduct<D>::kThreads)
proj_ln_bwd_da_kernel(const float* __restrict__ dy, const float* __restrict__ wo,
                      float* __restrict__ da, int N) {
  extern __shared__ __align__(16) float smem[];
  msfa_ln::dx_tile<D, false>(dy, D, wo, da, N, smem);  // (Wo^T)(o, i) = Wo[i][o]
}

// part[split] = a[rows of split]^T dy[rows of split] for a 128 x 64 tile of dWo
__global__ void __launch_bounds__(msfa_ln::GradProduct::kThreads, 2)
proj_ln_bwd_dw_kernel(const float* __restrict__ a, const float* __restrict__ dy,
                      float* __restrict__ part, int N, int D, int rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  msfa_ln::grad_tile(a, D, dy, D, part, N, rows_per_split, smem);
}

// out[e] = sum over s of part[s][e], s in order
__global__ void __launch_bounds__(256)
proj_ln_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int splits,
                       long width) {
  msfa_ln::ordered_sum(part, out, splits, width);
}

cudaError_t sum_splits(const float* part, float* out, int splits, long width, cudaStream_t s) {
  proj_ln_bwd_sum_kernel<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(part, out, splits,
                                                                          width);
  return cudaGetLastError();
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
               const float* gamma, const unsigned char* rmask, const float* dout, float* dx,
               float* da, float* dwo, float* sums, float* dy, float* ln_part, float* dw_part,
               int N, int splits, float inv_keep, float eps, cudaStream_t s) {
  using namespace msfa_ln;
  constexpr int kLnFloats = ln_smem_floats<D>();
  MSFA_TRY(allow_smem(proj_ln_bwd_ln_kernel<D>, kLnFloats));
  MSFA_TRY(allow_smem(proj_ln_bwd_da_kernel<D>, DxProduct<D>::kSmemFloats));
  MSFA_TRY(allow_smem(proj_ln_bwd_dw_kernel, GradProduct::kSmemFloats));
  const int row_tiles = (N + kRowsD - 1) / kRowsD;
  const int fb = (int)sizeof(float);
  proj_ln_bwd_ln_kernel<D><<<row_tiles, LnProduct<D>::kThreads, kLnFloats * fb, s>>>(
      a, wo, bo, x, gamma, rmask, dout, dx, dy, ln_part, N, inv_keep, eps);
  MSFA_TRY(cudaGetLastError());
  proj_ln_bwd_da_kernel<D><<<row_tiles, DxProduct<D>::kThreads,
                             DxProduct<D>::kSmemFloats * fb, s>>>(dy, wo, da, N);
  MSFA_TRY(cudaGetLastError());
  const dim3 grid((D + kGradM - 1) / kGradM, (D + kGradO - 1) / kGradO, splits);
  proj_ln_bwd_dw_kernel<<<grid, GradProduct::kThreads, GradProduct::kSmemFloats * fb, s>>>(
      a, dy, dw_part, N, D, rows_per_split(N, splits));
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum_splits(dw_part, dwo, splits, (long)D * D, s));
  MSFA_TRY(sum_splits(ln_part, sums, row_tiles, 3L * D, s));
  return 0;
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

// sums [3, D] receives dgamma | dbeta | dbo. Scratch: dy [N, D],
// ln_part [ceil(N/64), 3, D], dw_part [splits, D * D].
int msfa_proj_ln_bwd(const float* x, const float* a, const float* wo, const float* bo,
                     const float* gamma, const unsigned char* rmask, const float* dout,
                     float* dx, float* da, float* dwo, float* sums, float* dy, float* ln_part,
                     float* dw_part, int N, int D, int splits, float inv_keep, float eps,
                     void* stream) {
  if (N <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_PROJ_BWD(W)                                                                 \
  launch_bwd<W>(x, a, wo, bo, gamma, rmask, dout, dx, da, dwo, sums, dy, ln_part, dw_part, \
                N, splits, inv_keep, eps, s)
  switch (D) {
    case 32: return MSFA_PROJ_BWD(32);
    case 64: return MSFA_PROJ_BWD(64);
    case 128: return MSFA_PROJ_BWD(128);
    case 256: return MSFA_PROJ_BWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSFA_PROJ_BWD
}

// Dynamic shared memory per block of the backward's three product kernels
// (ln, da, dw) at width D, into bytes[0..2].
int msfa_proj_ln_bwd_smem_bytes(int D, int* bytes) {
  using namespace msfa_ln;
  const int fb = (int)sizeof(float);
  bytes[2] = GradProduct::kSmemFloats * fb;
  switch (D) {
#define MSFA_PROJ_SMEM(W)                                 \
  case W:                                                 \
    bytes[0] = ln_smem_floats<W>() * fb;                  \
    bytes[1] = DxProduct<W>::kSmemFloats * fb;            \
    return 0;
    MSFA_PROJ_SMEM(32)
    MSFA_PROJ_SMEM(64)
    MSFA_PROJ_SMEM(128)
    MSFA_PROJ_SMEM(256)
#undef MSFA_PROJ_SMEM
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
