// Fused out-projection + residual dropout + add + LayerNorm, forward and
// backward, f32 and bf16 operands, for Hopper (sm_90a).
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
// forward does 2*N*D*D = 2.1 GFLOP against 55 MB (x, a, out, the u8 mask, Wo),
// the backward 6*N*D*D = 6.4 GFLOP against ~100 MB. As 3xTF32 on the tensor
// cores (165 TFLOP/s) the forward's operations take 0.013 ms and its bytes
// 0.016 ms: bytes bound it; the backward's operations, 0.04 ms.
//
// Forward: y = a Wo + bo on 64 whole rows, on the TF32 tensor cores at f32
// accuracy (3xTF32), a tile of tc_product.cuh's template; its epilogue is the
// residual and the LayerNorm (residual_ln.cuh's ln_fwd_tile, the body of
// ffw_ln.cu's LN-forward product at K = D).
//
// Backward: three products, each a tile of the same template, on the bodies
// that residual_ln.cuh shares with ffw_ln.cu's:
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
//
// bf16 entries (msfa_proj_ln_fwd_bf16, msfa_proj_ln_bwd_bf16: mixed_precision).
// The same kernels at T = bf16, the function of the reference's kernels when
// x is bf16: x, a, Wo, dout bf16 and out, dx, da, dWo bf16 (dx = dr rounded,
// da = dy Wo^T rounded, dy itself rounded before both of its products); bo,
// gamma, beta and dbo, dgamma, dbeta f32; y, the residual and the LayerNorm
// in f32. Every product takes two bf16 operands, one TF32 product a k-step.
// At the training shape bytes bound both directions: the forward moves 29.5
// MB (0.0088 ms) against 2.15 GFLOP (0.0022 ms at the bf16 peak, 989
// TFLOP/s), the backward 46.4 MB (0.0138 ms) against 6.44 GFLOP (0.0065 ms).

#include <cuda_runtime.h>
#include <math.h>

#include "residual_ln.cuh"

namespace {

using bf16 = __nv_bfloat16;

// out = LayerNorm(x + (a Wo + bo) * rmask * inv_keep) for 64 whole rows
template <int D, typename T>
__global__ void __launch_bounds__(msfa_ln::LnProduct<D>::kThreads)
proj_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ a, const T* __restrict__ wo,
                   const float* __restrict__ bo, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const unsigned char* __restrict__ rmask,
                   T* __restrict__ out, int N, int Dv, float inv_keep, float eps) {
  extern __shared__ __align__(16) float smem[];
  msfa_ln::ln_fwd_tile<D>(a, D, wo, bo, x, gamma, beta, rmask, out, N, inv_keep, eps, Dv, smem);
}

// y = a Wo + bo for 64 whole rows, then the LayerNorm backward: dx = dr, dy,
// and the block's sums over its rows of dout * xhat | dout | dy
template <int D, typename T>
__global__ void __launch_bounds__(msfa_ln::LnProduct<D>::kThreads)
proj_ln_bwd_ln_kernel(const T* __restrict__ a, const T* __restrict__ wo,
                      const float* __restrict__ bo, const T* __restrict__ x,
                      const float* __restrict__ gamma, const unsigned char* __restrict__ rmask,
                      const T* __restrict__ dout, T* __restrict__ dx, T* __restrict__ dy,
                      float* __restrict__ part, int N, int Dv, float inv_keep, float eps) {
  extern __shared__ __align__(16) float smem[];
  msfa_ln::ln_bwd_tile<D>(a, D, wo, bo, x, gamma, rmask, dout, dx, dy, part, N, inv_keep, eps,
                          Dv, smem);
}

// da = dy Wo^T for 64 whole rows
template <int D, typename T>
__global__ void __launch_bounds__(msfa_ln::DxProduct<D>::kThreads)
proj_ln_bwd_da_kernel(const T* __restrict__ dy, const T* __restrict__ wo, T* __restrict__ da,
                      int N) {
  extern __shared__ __align__(16) float smem[];
  msfa_ln::dx_tile<D, false>(dy, D, wo, nullptr, da, N, smem);  // (Wo^T)(o, i) = Wo[i][o]
}

// part[split] = a[rows of split]^T dy[rows of split] for a 128 x 64 tile of dWo
template <typename T>
__global__ void __launch_bounds__(msfa_ln::GradProduct::kThreads, 2)
proj_ln_bwd_dw_kernel(const T* __restrict__ a, const T* __restrict__ dy,
                      float* __restrict__ part, int N, int D, int rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  msfa_ln::grad_tile(a, D, dy, D, part, N, rows_per_split, smem);
}

// out[e] = sum over s of part[s][e], s in order
template <typename Out>
__global__ void __launch_bounds__(256)
proj_ln_bwd_sum_kernel(const float* __restrict__ part, Out* __restrict__ out, int splits,
                       long width) {
  msfa_ln::ordered_sum(part, out, splits, width);
}

template <typename Out>
cudaError_t sum_splits(const float* part, Out* out, int splits, long width, cudaStream_t s) {
  proj_ln_bwd_sum_kernel<Out><<<(unsigned)((width + 255) / 256), 256, 0, s>>>(part, out, splits,
                                                                               width);
  return cudaGetLastError();
}

template <int D, typename T>
int launch_fwd(const T* x, const T* a, const T* wo, const float* bo, const float* gamma,
               const float* beta, const unsigned char* rmask, T* out, int N, int Dv,
               float inv_keep, float eps, cudaStream_t s) {
  using namespace msfa_ln;
  constexpr int kFloats = ln_smem_floats<D, T>();
  MSFA_TRY(allow_smem(proj_ln_fwd_kernel<D, T>, kFloats));
  proj_ln_fwd_kernel<D, T><<<(N + kRowsD - 1) / kRowsD, LnProduct<D>::kThreads,
                             kFloats * (int)sizeof(float), s>>>(x, a, wo, bo, gamma, beta, rmask,
                                                                out, N, Dv, inv_keep, eps);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_bwd(const T* x, const T* a, const T* wo, const float* bo, const float* gamma,
               const unsigned char* rmask, const T* dout, T* dx, T* da, T* dwo, float* sums,
               T* dy, float* ln_part, float* dw_part, int N, int Dv, int splits, float inv_keep,
               float eps, cudaStream_t s) {
  using namespace msfa_ln;
  using PX = DxProduct<D, T>;
  using PG = GradProductOf<T>;
  constexpr int kLnFloats = ln_smem_floats<D, T>();
  MSFA_TRY(allow_smem(proj_ln_bwd_ln_kernel<D, T>, kLnFloats));
  MSFA_TRY(allow_smem(proj_ln_bwd_da_kernel<D, T>, PX::kSmemFloats));
  MSFA_TRY(allow_smem(proj_ln_bwd_dw_kernel<T>, PG::kSmemFloats));
  const int row_tiles = (N + kRowsD - 1) / kRowsD;
  const int fb = (int)sizeof(float);
  proj_ln_bwd_ln_kernel<D, T><<<row_tiles, LnProduct<D>::kThreads, kLnFloats * fb, s>>>(
      a, wo, bo, x, gamma, rmask, dout, dx, dy, ln_part, N, Dv, inv_keep, eps);
  MSFA_TRY(cudaGetLastError());
  proj_ln_bwd_da_kernel<D, T><<<row_tiles, PX::kThreads, PX::kSmemFloats * fb, s>>>(
      dy, wo, da, N);
  MSFA_TRY(cudaGetLastError());
  const dim3 grid((D + kGradM - 1) / kGradM, (D + kGradO - 1) / kGradO, splits);
  proj_ln_bwd_dw_kernel<T><<<grid, PG::kThreads, PG::kSmemFloats * fb, s>>>(
      a, dy, dw_part, N, D, rows_per_split(N, splits));
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum_splits(dw_part, dwo, splits, (long)D * D, s));
  MSFA_TRY(sum_splits(ln_part, sums, row_tiles, 3L * D, s));
  return 0;
}

template <typename T>
int fwd_entry(const T* x, const T* a, const T* wo, const float* bo, const float* gamma,
              const float* beta, const unsigned char* rmask, T* out, int N, int D, int Dv,
              float inv_keep, float eps, void* stream) {
  if (N <= 0 || Dv <= 0 || Dv > D) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_PROJ_FWD(W) \
  launch_fwd<W>(x, a, wo, bo, gamma, beta, rmask, out, N, Dv, inv_keep, eps, s)
  switch (D) {
    case 32: return MSFA_PROJ_FWD(32);
    case 64: return MSFA_PROJ_FWD(64);
    case 128: return MSFA_PROJ_FWD(128);
    case 256: return MSFA_PROJ_FWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSFA_PROJ_FWD
}

template <typename T>
int bwd_entry(const T* x, const T* a, const T* wo, const float* bo, const float* gamma,
              const unsigned char* rmask, const T* dout, T* dx, T* da, T* dwo, float* sums,
              T* dy, float* ln_part, float* dw_part, int N, int D, int Dv, int splits,
              float inv_keep, float eps, void* stream) {
  if (N <= 0 || splits <= 0 || Dv <= 0 || Dv > D) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_PROJ_BWD(W)                                                                 \
  launch_bwd<W>(x, a, wo, bo, gamma, rmask, dout, dx, da, dwo, sums, dy, ln_part, dw_part, \
                N, Dv, splits, inv_keep, eps, s)
  switch (D) {
    case 32: return MSFA_PROJ_BWD(32);
    case 64: return MSFA_PROJ_BWD(64);
    case 128: return MSFA_PROJ_BWD(128);
    case 256: return MSFA_PROJ_BWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSFA_PROJ_BWD
}

template <typename T>
int bwd_smem_bytes(int D, int* bytes) {
  using namespace msfa_ln;
  const int fb = (int)sizeof(float);
  bytes[2] = GradProductOf<T>::kSmemFloats * fb;
  switch (D) {
#define MSFA_PROJ_SMEM(W)                                 \
  case W:                                                 \
    bytes[0] = ln_smem_floats<W, T>() * fb;               \
    bytes[1] = DxProduct<W, T>::kSmemFloats * fb;         \
    return 0;
    MSFA_PROJ_SMEM(32)
    MSFA_PROJ_SMEM(64)
    MSFA_PROJ_SMEM(128)
    MSFA_PROJ_SMEM(256)
#undef MSFA_PROJ_SMEM
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Widths the kernels are instantiated for (D); the LayerNorm's statistics
// over the first Dv columns (0 < Dv <= D; x, a, wo, bo, gamma and beta zero
// past Dv). The wrapper checks before calling.
int msfa_proj_ln_fwd(const float* x, const float* a, const float* wo, const float* bo,
                     const float* gamma, const float* beta, const unsigned char* rmask,
                     float* out, int N, int D, int Dv, float inv_keep, float eps,
                     void* stream) {
  return fwd_entry(x, a, wo, bo, gamma, beta, rmask, out, N, D, Dv, inv_keep, eps, stream);
}

// The bf16 entry: x, a, wo and out bf16.
int msfa_proj_ln_fwd_bf16(const bf16* x, const bf16* a, const bf16* wo, const float* bo,
                          const float* gamma, const float* beta, const unsigned char* rmask,
                          bf16* out, int N, int D, int Dv, float inv_keep, float eps,
                          void* stream) {
  return fwd_entry(x, a, wo, bo, gamma, beta, rmask, out, N, D, Dv, inv_keep, eps, stream);
}

// sums [3, D] receives dgamma | dbeta | dbo; dx is 0 past Dv. Scratch: dy [N, D],
// ln_part [ceil(N/64), 3, D], dw_part [splits, D * D].
int msfa_proj_ln_bwd(const float* x, const float* a, const float* wo, const float* bo,
                     const float* gamma, const unsigned char* rmask, const float* dout,
                     float* dx, float* da, float* dwo, float* sums, float* dy, float* ln_part,
                     float* dw_part, int N, int D, int Dv, int splits, float inv_keep,
                     float eps, void* stream) {
  return bwd_entry(x, a, wo, bo, gamma, rmask, dout, dx, da, dwo, sums, dy, ln_part, dw_part,
                   N, D, Dv, splits, inv_keep, eps, stream);
}

// The bf16 entry: x, a, wo, dout, dx, da, dwo and the scratch dy bf16.
int msfa_proj_ln_bwd_bf16(const bf16* x, const bf16* a, const bf16* wo, const float* bo,
                          const float* gamma, const unsigned char* rmask, const bf16* dout,
                          bf16* dx, bf16* da, bf16* dwo, float* sums, bf16* dy, float* ln_part,
                          float* dw_part, int N, int D, int Dv, int splits, float inv_keep,
                          float eps, void* stream) {
  return bwd_entry(x, a, wo, bo, gamma, rmask, dout, dx, da, dwo, sums, dy, ln_part, dw_part,
                   N, D, Dv, splits, inv_keep, eps, stream);
}

// Dynamic shared memory per block of the backward's three product kernels
// (ln, da, dw) at width D, into bytes[0..2]; the bf16 entry's beside it.
int msfa_proj_ln_bwd_smem_bytes(int D, int* bytes) { return bwd_smem_bytes<float>(D, bytes); }
int msfa_proj_ln_bf16_bwd_smem_bytes(int D, int* bytes) { return bwd_smem_bytes<bf16>(D, bytes); }

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
