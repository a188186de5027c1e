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
// D = 256, F = 2048) the forward does 4*N*D*F = 34.4 GFLOP and the backward
// 12*N*D*F = 103 GFLOP: 0.21 ms and 0.62 ms at 495/3 = 165 TFLOP/s as 3xTF32
// on the tensor cores (0.51 ms and 1.54 ms on the CUDA cores), against
// ~104 MB of x, masks and output (0.03 ms).
//
// Both directions are chains of products on the TF32 tensor cores at f32
// accuracy (3xTF32), each a tile of tc_product.cuh's template with its own
// epilogue; residual_ln.cuh holds the bodies shared with proj_ln.cu,
// ffw_products.cuh those shared with the feed-forward pair (ffw.cu). The
// hidden is an [N, F] operand in device memory (scratch the wrapper
// allocates): the forward writes it once and reads it once (268 MB at the
// training shape, ~0.08 ms), where the TPU kernel kept it on chip.
//   hidden:   hd = relu(x W1 + b1) * fmask * inv_keep, 128-row x 64-column
//             tiles: ffw_ln_hidden_kernel, launched by both directions (the
//             body of ffw.cu's hidden kernel too: the same bits)
// Forward:
//   fwd:      y = hd W2 + b2 on 64 whole rows; its epilogue is the residual
//             and the LayerNorm (ln_fwd_tile)
// Backward:
//   ln:       the same product; its epilogue is the LayerNorm backward: dr
//             (the start of dx), dy, and per-block partials of dgamma, dbeta
//             and db2 (ln_bwd_tile)
//   dpre:     dpre = (hd > 0) * (dy W2^T) * fmask * inv_keep, and per-block
//             partials of db1 (hd > 0 is pre > 0 wherever the mask keeps the
//             unit; where it drops it, dpre is 0 either way)
//   dx:       dx = dr + dpre W1^T
//   dw:       dW2 = hd^T dy and dW1 = x^T dpre, per split of the rows
//   sum:      the splits and the per-block partials, added in order
// The ReLU's derivative is a step, so the backward must take the branch the
// forward took. Both directions compute the hidden by one kernel with the
// same arguments, so the backward's hd, and with it every branch, is the
// forward's bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "ffw_products.cuh"
#include "residual_ln.cuh"

namespace {

using namespace msfa_ffw;
using namespace msfa_ln;

// hd = relu(x W1 + b1) * fmask * inv_keep for a 128-row x 64-column tile
__global__ void __launch_bounds__(HiddenProduct::kThreads, 2)
ffw_ln_hidden_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ b1, const unsigned char* __restrict__ fmask,
                     float* __restrict__ hd, int N, int D, int F, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  hidden_tile(x, w1, b1, fmask, hd, N, D, F, inv_keep, smem);
}

// out = LayerNorm(x + (hd W2 + b2) * rmask * inv_keep) for 64 whole rows
template <int D>
__global__ void __launch_bounds__(LnProduct<D>::kThreads)
ffw_ln_fwd_kernel(const float* __restrict__ hd, const float* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ x,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const unsigned char* __restrict__ rmask, float* __restrict__ out, int N, int F,
                  int Dv, float inv_keep, float eps) {
  extern __shared__ __align__(16) float smem[];
  ln_fwd_tile<D>(hd, F, w2, b2, x, gamma, beta, rmask, out, N, inv_keep, eps, Dv, smem);
}

// y = hd W2 + b2 for 64 whole rows, then the LayerNorm backward: dr (into
// dx), dy, and the block's sums over its rows of dout * xhat | dout | dy
template <int D>
__global__ void __launch_bounds__(LnProduct<D>::kThreads)
ffw_ln_bwd_ln_kernel(const float* __restrict__ hd, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ x,
                     const float* __restrict__ gamma, const unsigned char* __restrict__ rmask,
                     const float* __restrict__ dout, float* __restrict__ dr_out,
                     float* __restrict__ dy_out, float* __restrict__ part, int N, int F,
                     int Dv, float inv_keep, float eps) {
  extern __shared__ __align__(16) float smem[];
  ln_bwd_tile<D>(hd, F, w2, b2, x, gamma, rmask, dout, dr_out, dy_out, part, N, inv_keep, eps,
                 Dv, smem);
}

// dpre = (hd > 0) * (dy W2^T) * fmask * inv_keep for a 128-row x 64-column
// tile, and the block's column sums of dpre (db1's partial)
__global__ void __launch_bounds__(DhdProduct::kThreads, 2)
ffw_ln_bwd_dpre_kernel(const float* __restrict__ dy, const float* __restrict__ w2,
                       const float* __restrict__ hd, const unsigned char* __restrict__ fmask,
                       float* __restrict__ dpre, float* __restrict__ part, int N, int D, int F,
                       float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  dpre_tile(dy, w2, hd, fmask, dpre, part, N, D, F, inv_keep, smem);
}

// dx = dr + dpre W1^T for 64 whole rows (dx holds dr on entry)
template <int D>
__global__ void __launch_bounds__(DxProduct<D>::kThreads)
ffw_ln_bwd_dx_kernel(const float* __restrict__ dpre, const float* __restrict__ w1,
                     float* __restrict__ dx, int N, int F) {
  extern __shared__ __align__(16) float smem[];
  dx_tile<D, true>(dpre, F, w1, dx, N, smem);
}

// part[split] = A[rows of split]^T B[rows of split] for a 128 x 64 tile of
// the [M, O] weight gradient (A [N, M], B [N, O] row-major)
__global__ void __launch_bounds__(GradProduct::kThreads, 2)
ffw_ln_bwd_dw_kernel(const float* __restrict__ A, int M, const float* __restrict__ B, int O,
                     float* __restrict__ part, int N, int rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  grad_tile(A, M, B, O, part, N, rows_per_split, smem);
}

// out[e] = sum over s of part[s][e], s in order
__global__ void __launch_bounds__(256)
ffw_ln_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int splits,
                      long width) {
  ordered_sum(part, out, splits, width);
}

cudaError_t sum_splits(const float* part, float* out, int splits, long width, cudaStream_t s) {
  ffw_ln_bwd_sum_kernel<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(part, out, splits, width);
  return cudaGetLastError();
}

// the hidden, as both directions take it
cudaError_t launch_hidden(const float* x, const float* w1, const float* b1,
                          const unsigned char* fmask, float* hd, int N, int D, int F,
                          float inv_keep, cudaStream_t s) {
  const cudaError_t err = allow_smem(ffw_ln_hidden_kernel, HiddenProduct::kSmemFloats);
  if (err != cudaSuccess) return err;
  const dim3 grid(F / kColsF, (N + kRowsF - 1) / kRowsF);
  ffw_ln_hidden_kernel<<<grid, HiddenProduct::kThreads,
                         HiddenProduct::kSmemFloats * (int)sizeof(float), s>>>(
      x, w1, b1, fmask, hd, N, D, F, inv_keep);
  return cudaGetLastError();
}

template <int D>
int launch_fwd(const float* x, const float* w1, const float* b1, const float* w2,
               const float* b2, const float* gamma, const float* beta,
               const unsigned char* fmask, const unsigned char* rmask, float* out, float* hd,
               int N, int Dv, int F, float inv_keep, float eps, cudaStream_t s) {
  constexpr int kLnFloats = ln_smem_floats<D>();
  MSFA_TRY(allow_smem(ffw_ln_fwd_kernel<D>, kLnFloats));
  MSFA_TRY(launch_hidden(x, w1, b1, fmask, hd, N, D, F, inv_keep, s));
  ffw_ln_fwd_kernel<D><<<(N + kRowsD - 1) / kRowsD, LnProduct<D>::kThreads,
                         kLnFloats * (int)sizeof(float), s>>>(
      hd, w2, b2, x, gamma, beta, rmask, out, N, F, Dv, inv_keep, eps);
  MSFA_TRY(cudaGetLastError());
  return 0;
}

template <int D>
int launch_bwd(const float* x, const float* w1, const float* b1, const float* w2,
               const float* b2, const float* gamma, const unsigned char* fmask,
               const unsigned char* rmask, const float* dout, float* dx, float* dw1,
               float* db1, float* dw2, float* sums, float* hd, float* dpre, float* dy,
               float* ln_part, float* db1_part, float* dw_part, int N, int Dv, int F,
               int splits, float inv_keep, float eps, cudaStream_t s) {
  constexpr int kLnFloats = ln_smem_floats<D>();
  MSFA_TRY(allow_smem(ffw_ln_bwd_ln_kernel<D>, kLnFloats));
  MSFA_TRY(allow_smem(ffw_ln_bwd_dpre_kernel, DhdProduct::kSmemFloats));
  MSFA_TRY(allow_smem(ffw_ln_bwd_dx_kernel<D>, DxProduct<D>::kSmemFloats));
  MSFA_TRY(allow_smem(ffw_ln_bwd_dw_kernel, GradProduct::kSmemFloats));
  const int row_tiles_f = (N + kRowsF - 1) / kRowsF, row_tiles_d = (N + kRowsD - 1) / kRowsD;
  const dim3 grid_f(F / kColsF, row_tiles_f);
  const int fb = (int)sizeof(float);

  MSFA_TRY(launch_hidden(x, w1, b1, fmask, hd, N, D, F, inv_keep, s));
  ffw_ln_bwd_ln_kernel<D><<<row_tiles_d, LnProduct<D>::kThreads, kLnFloats * fb, s>>>(
      hd, w2, b2, x, gamma, rmask, dout, dx, dy, ln_part, N, F, Dv, inv_keep, eps);
  MSFA_TRY(cudaGetLastError());
  ffw_ln_bwd_dpre_kernel<<<grid_f, DhdProduct::kThreads, DhdProduct::kSmemFloats * fb, s>>>(
      dy, w2, hd, fmask, dpre, db1_part, N, D, F, inv_keep);
  MSFA_TRY(cudaGetLastError());
  ffw_ln_bwd_dx_kernel<D><<<row_tiles_d, DxProduct<D>::kThreads,
                            DxProduct<D>::kSmemFloats * fb, s>>>(dpre, w1, dx, N, F);
  MSFA_TRY(cudaGetLastError());

  const int per_split = rows_per_split(N, splits);
  const int dw_bytes = GradProduct::kSmemFloats * fb;
  ffw_ln_bwd_dw_kernel<<<dim3((F + kGradM - 1) / kGradM, (D + kGradO - 1) / kGradO, splits),
                         GradProduct::kThreads, dw_bytes, s>>>(hd, F, dy, D, dw_part, N,
                                                               per_split);  // dW2 = hd^T dy
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum_splits(dw_part, dw2, splits, (long)F * D, s));
  ffw_ln_bwd_dw_kernel<<<dim3((D + kGradM - 1) / kGradM, (F + kGradO - 1) / kGradO, splits),
                         GradProduct::kThreads, dw_bytes, s>>>(x, D, dpre, F, dw_part, N,
                                                               per_split);  // dW1 = x^T dpre
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum_splits(dw_part, dw1, splits, (long)D * F, s));
  MSFA_TRY(sum_splits(ln_part, sums, row_tiles_d, 3L * D, s));
  MSFA_TRY(sum_splits(db1_part, db1, row_tiles_f, F, s));
  return 0;
}

}  // namespace

extern "C" {

// Widths the kernels are instantiated for (D); the LayerNorm's statistics
// over the first Dv columns (0 < Dv <= D; x, w1's rows, w2's columns, b2,
// gamma and beta zero past Dv); F must be a multiple of 64. The wrapper
// checks before calling. Scratch: hd [N, F], which holds the hidden on return.
int msfa_ffw_ln_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                    const float* b2, const float* gamma, const float* beta,
                    const unsigned char* fmask, const unsigned char* rmask, float* out,
                    float* hd, int N, int D, int Dv, int F, float inv_keep, float eps,
                    void* stream) {
  if (N <= 0 || F <= 0 || F % kColsF != 0 || Dv <= 0 || Dv > D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_FFW_FWD(W) \
  launch_fwd<W>(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, out, hd, N, Dv, F, inv_keep, eps, s)
  switch (D) {
    case 32: return MSFA_FFW_FWD(32);
    case 64: return MSFA_FFW_FWD(64);
    case 128: return MSFA_FFW_FWD(128);
    case 256: return MSFA_FFW_FWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSFA_FFW_FWD
}

// sums [3, D] receives dgamma | dbeta | db2; dx is 0 past Dv. Scratch: hd,
// dpre [N, F], dy [N, D], ln_part [ceil(N/64), 3, D], db1_part [ceil(N/128), F],
// dw_part [splits, D * F]; hd holds the hidden on return.
int msfa_ffw_ln_bwd(const float* x, const float* w1, const float* b1, const float* w2,
                    const float* b2, const float* gamma, const unsigned char* fmask,
                    const unsigned char* rmask, const float* dout, float* dx, float* dw1,
                    float* db1, float* dw2, float* sums, float* hd, float* dpre, float* dy,
                    float* ln_part, float* db1_part, float* dw_part, int N, int D, int Dv,
                    int F, int splits, float inv_keep, float eps, void* stream) {
  if (N <= 0 || F <= 0 || F % kColsF != 0 || splits <= 0 || Dv <= 0 || Dv > D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_FFW_BWD(W)                                                                  \
  launch_bwd<W>(x, w1, b1, w2, b2, gamma, fmask, rmask, dout, dx, dw1, db1, dw2, sums,  \
                hd, dpre, dy, ln_part, db1_part, dw_part, N, Dv, F, splits, inv_keep, eps, s)
  switch (D) {
    case 32: return MSFA_FFW_BWD(32);
    case 64: return MSFA_FFW_BWD(64);
    case 128: return MSFA_FFW_BWD(128);
    case 256: return MSFA_FFW_BWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSFA_FFW_BWD
}

// Dynamic shared memory per block of the six product kernels (hidden, fwd,
// ln, dpre, dx, dw) at width D, into bytes[0..5].
int msfa_ffw_ln_smem_bytes(int D, int* bytes) {
  const int fb = (int)sizeof(float);
  bytes[0] = HiddenProduct::kSmemFloats * fb;
  bytes[3] = DhdProduct::kSmemFloats * fb;
  bytes[5] = GradProduct::kSmemFloats * fb;
  switch (D) {
#define MSFA_FFW_SMEM(W)                                  \
  case W:                                                 \
    bytes[1] = bytes[2] = ln_smem_floats<W>() * fb;       \
    bytes[4] = DxProduct<W>::kSmemFloats * fb;            \
    return 0;
    MSFA_FFW_SMEM(32)
    MSFA_FFW_SMEM(64)
    MSFA_FFW_SMEM(128)
    MSFA_FFW_SMEM(256)
#undef MSFA_FFW_SMEM
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
