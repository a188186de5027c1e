// Fused feed-forward + residual dropout + add + LayerNorm, forward and
// backward, f32 and bf16 operands, for Hopper (sm_90a).
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
//             and the LayerNorm (ln_fwd_tile; the bf16 entry's on 128 rows,
//             below)
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
//
// bf16 entries (msfa_ffw_ln_fwd_bf16, msfa_ffw_ln_bwd_bf16: mixed_precision),
// the function of the reference's kernels when x is bf16 (their compute type
// is x's): x, W1, W2 and dout bf16 and out, dx, dW1, dW2 bf16; b1, b2,
// gamma, beta and db1, db2, dgamma, dbeta f32. pre sums exact bf16 products
// in f32; the hidden is rounded to bf16 before W2's product (and kept so in
// its scratch, half the bytes), dy and dpre before theirs; the residual, the
// LayerNorm and its backward run in f32, and dr waits in an f32 scratch for
// dx's product. Every product takes two bf16 operands: the forward's 34.4
// GFLOP and the backward's 103 bound at the bf16 tensor-core peak (989
// TFLOP/s): 0.035 ms and 0.104 ms at the training shape.
//   Both directions on wgmma (wgmma_ffw.cuh over wgmma_bf16.cuh's
//   WgProduct, m64n64k16 bf16 from 128-byte-swizzled shared memory filled by
//   cp.async, the transposed operands W1^T, W2^T, hd^T, dpre^T read
//   MN-major). The hidden and dpre (k = D) on 128 x 128 tiles with the whole
//   k in the unit, the mask or hd tile prefetched beside the product and the
//   output stored through shared memory; y = hd W2 (k = d_ff) on 128 whole
//   rows, 64-deep fresh accumulators added in f32, staged in shared memory
//   (wg_y_rows), then the forward's LayerNorm (wg_ln_fwd_tile) or the LN
//   backward (wg_ln_bwd_tile): one body, so the backward normalises the
//   forward's y bit for bit, as the f32 pair's one LnProduct does; dx (k =
//   d_ff) as y; dW2 = hd^T dy and dW1 = (dpre^T x)^T on 128 x D tiles per
//   split of the rows (mlp.py _wg_grad_splits), the same fresh chunks; the
//   ordered sums. They replaced these kernels at T = bf16 (one TF32
//   mma.sync pass a k-step on widened bf16 values, tc_product.cuh): the
//   backward went 1.0895 -> 0.5211 ms and the forward, its hidden on wgmma,
//   0.3551 -> 0.2465 at the training shape (scripts/attention_kernels_ab.py,
//   an H100 80GB HBM3 at 700 W); the forward's LN product came after
//   (PERF.md, row 12b).

#include <cuda_runtime.h>
#include <math.h>

#include "ffw_products.cuh"
#include "residual_ln.cuh"
#include "wgmma_ffw.cuh"

namespace {

using namespace msfa_ffw;
using namespace msfa_ln;
using bf16 = __nv_bfloat16;

// The f32 entries' kernels

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
// dr_out, f32), dy, and the block's sums over its rows of dout * xhat | dout | dy
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

// dx = dr + dpre W1^T for 64 whole rows (dr is dx itself)
template <int D>
__global__ void __launch_bounds__(DxProduct<D>::kThreads)
ffw_ln_bwd_dx_kernel(const float* __restrict__ dpre, const float* __restrict__ w1,
                     const float* dr, float* dx, int N, int F) {
  extern __shared__ __align__(16) float smem[];
  dx_tile<D, true>(dpre, F, w1, dr, dx, N, smem);
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
template <typename Out>
__global__ void __launch_bounds__(256)
ffw_ln_bwd_sum_kernel(const float* __restrict__ part, Out* __restrict__ out, int splits,
                      long width) {
  ordered_sum(part, out, splits, width);
}

template <typename Out>
cudaError_t sum_splits(const float* part, Out* out, int splits, long width, cudaStream_t s) {
  ffw_ln_bwd_sum_kernel<Out><<<(unsigned)((width + 255) / 256), 256, 0, s>>>(part, out, splits,
                                                                             width);
  return cudaGetLastError();
}

// The bf16 entries' kernels on wgmma (wgmma_ffw.cuh's bodies)
__global__ void __launch_bounds__(msfa_wg::WgFProduct::kThreads, 2)
ffw_ln_hidden_wg_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                        const float* __restrict__ b1, const unsigned char* __restrict__ fmask,
                        bf16* __restrict__ hd, int N, int D, int F, float inv_keep) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  msfa_wg::wg_hidden_tile(x, w1, b1, fmask, hd, N, D, F, inv_keep, msfa_wg::align1024(wg_smem));
}

// out = LayerNorm(x + (hd W2 + b2) * rmask * inv_keep) for 128 whole rows,
// rounded to bf16 (wg_y_rows, the LN backward's product)
template <int D>
__global__ void __launch_bounds__(msfa_wg::WgLnProduct<D>::kThreads)
ffw_ln_fwd_wg_kernel(const bf16* __restrict__ hd, const bf16* __restrict__ w2,
                     const float* __restrict__ b2, const bf16* __restrict__ x,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const unsigned char* __restrict__ rmask, bf16* __restrict__ out, int N,
                     int F, int Dv, float inv_keep, float eps) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  msfa_wg::wg_ln_fwd_tile<D>(hd, F, w2, b2, x, gamma, beta, rmask, out, N, inv_keep, eps, Dv,
                             msfa_wg::align1024(wg_smem));
}

template <int D>
__global__ void __launch_bounds__(msfa_wg::WgLnProduct<D>::kThreads)
ffw_ln_bwd_ln_wg_kernel(const bf16* __restrict__ hd, const bf16* __restrict__ w2,
                        const float* __restrict__ b2, const bf16* __restrict__ x,
                        const float* __restrict__ gamma, const unsigned char* __restrict__ rmask,
                        const bf16* __restrict__ dout, float* __restrict__ dr_out,
                        bf16* __restrict__ dy_out, float* __restrict__ part, int N, int F, int Dv,
                        float inv_keep, float eps) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  msfa_wg::wg_ln_bwd_tile<D>(hd, F, w2, b2, x, gamma, rmask, dout, dr_out, dy_out, part, N,
                             inv_keep, eps, Dv, msfa_wg::align1024(wg_smem));
}

__global__ void __launch_bounds__(msfa_wg::WgDpreProduct::kThreads, 2)
ffw_ln_bwd_dpre_wg_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w2,
                          const bf16* __restrict__ hd, const unsigned char* __restrict__ fmask,
                          bf16* __restrict__ dpre, float* __restrict__ part, int N, int D, int F,
                          float inv_keep) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  msfa_wg::wg_dpre_tile(dy, w2, hd, fmask, dpre, part, N, D, F, inv_keep,
                        msfa_wg::align1024(wg_smem));
}

template <int D>
__global__ void __launch_bounds__(msfa_wg::WgDxProduct<D>::kThreads)
ffw_ln_bwd_dx_wg_kernel(const bf16* __restrict__ dpre, const bf16* __restrict__ w1,
                        const float* __restrict__ dr, bf16* __restrict__ dx, int N, int F) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  msfa_wg::wg_dx_tile<D, true>(dpre, F, w1, dr, dx, N, msfa_wg::align1024(wg_smem));
}

template <int D, bool kTransposed>
__global__ void __launch_bounds__(msfa_wg::WgGradProduct<D>::kThreads)
ffw_ln_bwd_dw_wg_kernel(const bf16* __restrict__ A, int M, const bf16* __restrict__ B,
                        float* __restrict__ part, int N, int rows_per_split) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  msfa_wg::wg_grad_tile<D, kTransposed>(A, M, B, part, N, rows_per_split,
                                        msfa_wg::align1024(wg_smem));
}

// the hidden, as both directions take it
cudaError_t launch_hidden(const float* x, const float* w1, const float* b1,
                          const unsigned char* fmask, float* hd, int N, int D, int F,
                          float inv_keep, cudaStream_t s) {
  using P = HiddenProduct;
  const cudaError_t err = allow_smem(ffw_ln_hidden_kernel, P::kSmemFloats);
  if (err != cudaSuccess) return err;
  const dim3 grid(F / kColsF, (N + kRowsF - 1) / kRowsF);
  ffw_ln_hidden_kernel<<<grid, P::kThreads, P::kSmemFloats * (int)sizeof(float), s>>>(
      x, w1, b1, fmask, hd, N, D, F, inv_keep);
  return cudaGetLastError();
}

// the bf16 hidden, on wgmma: both bf16 directions (and ffw.cu's bf16 pair) take it
cudaError_t launch_hidden(const bf16* x, const bf16* w1, const float* b1,
                          const unsigned char* fmask, bf16* hd, int N, int D, int F,
                          float inv_keep, cudaStream_t s) {
  constexpr int kBytes = msfa_wg::hidden_smem_bytes();
  const cudaError_t err = msfa_wg::allow_bytes(ffw_ln_hidden_wg_kernel, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + msfa_wg::kWgColsF - 1) / msfa_wg::kWgColsF, (N + kRowsF - 1) / kRowsF);
  ffw_ln_hidden_wg_kernel<<<grid, msfa_wg::WgFProduct::kThreads, kBytes, s>>>(
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

// The bf16 forward: the wgmma hidden, then y = hd W2 and the LayerNorm on
// 128 whole rows (the backward's LN product)
template <int D>
int launch_fwd(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
               const float* gamma, const float* beta, const unsigned char* fmask,
               const unsigned char* rmask, bf16* out, bf16* hd, int N, int Dv, int F,
               float inv_keep, float eps, cudaStream_t s) {
  constexpr int kBytes = msfa_wg::y_rows_smem_bytes<D>();
  MSFA_TRY(msfa_wg::allow_bytes(ffw_ln_fwd_wg_kernel<D>, kBytes));
  MSFA_TRY(launch_hidden(x, w1, b1, fmask, hd, N, D, F, inv_keep, s));
  ffw_ln_fwd_wg_kernel<D><<<(N + msfa_wg::kWgRowsD - 1) / msfa_wg::kWgRowsD,
                            msfa_wg::WgLnProduct<D>::kThreads, kBytes, s>>>(
      hd, w2, b2, x, gamma, beta, rmask, out, N, F, Dv, inv_keep, eps);
  MSFA_TRY(cudaGetLastError());
  return 0;
}

// The f32 backward: dr is dx itself (dx_tile adds to it in place)
template <int D>
int launch_bwd(const float* x, const float* w1, const float* b1, const float* w2,
               const float* b2, const float* gamma, const unsigned char* fmask,
               const unsigned char* rmask, const float* dout, float* dx, float* dw1, float* db1,
               float* dw2, float* sums, float* hd, float* dpre, float* dy, float* dr,
               float* ln_part, float* db1_part, float* dw_part, int N, int Dv, int F, int splits,
               float inv_keep, float eps, cudaStream_t s) {
  using PH = DhdProduct;
  using PX = DxProduct<D>;
  using PG = GradProduct;
  constexpr int kLnFloats = ln_smem_floats<D>();
  MSFA_TRY(allow_smem(ffw_ln_bwd_ln_kernel<D>, kLnFloats));
  MSFA_TRY(allow_smem(ffw_ln_bwd_dpre_kernel, PH::kSmemFloats));
  MSFA_TRY(allow_smem(ffw_ln_bwd_dx_kernel<D>, PX::kSmemFloats));
  MSFA_TRY(allow_smem(ffw_ln_bwd_dw_kernel, PG::kSmemFloats));
  const int row_tiles_f = (N + kRowsF - 1) / kRowsF, row_tiles_d = (N + kRowsD - 1) / kRowsD;
  const dim3 grid_f(F / kColsF, row_tiles_f);
  const int fb = (int)sizeof(float);

  MSFA_TRY(launch_hidden(x, w1, b1, fmask, hd, N, D, F, inv_keep, s));
  ffw_ln_bwd_ln_kernel<D><<<row_tiles_d, LnProduct<D>::kThreads, kLnFloats * fb, s>>>(
      hd, w2, b2, x, gamma, rmask, dout, dr, dy, ln_part, N, F, Dv, inv_keep, eps);
  MSFA_TRY(cudaGetLastError());
  ffw_ln_bwd_dpre_kernel<<<grid_f, PH::kThreads, PH::kSmemFloats * fb, s>>>(
      dy, w2, hd, fmask, dpre, db1_part, N, D, F, inv_keep);
  MSFA_TRY(cudaGetLastError());
  ffw_ln_bwd_dx_kernel<D><<<row_tiles_d, PX::kThreads, PX::kSmemFloats * fb, s>>>(
      dpre, w1, dr, dx, N, F);
  MSFA_TRY(cudaGetLastError());

  const int per_split = rows_per_split(N, splits);
  const int dw_bytes = PG::kSmemFloats * fb;
  ffw_ln_bwd_dw_kernel<<<dim3((F + kGradM - 1) / kGradM, (D + kGradO - 1) / kGradO, splits),
                         PG::kThreads, dw_bytes, s>>>(hd, F, dy, D, dw_part, N,
                                                      per_split);  // dW2 = hd^T dy
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum_splits(dw_part, dw2, splits, (long)F * D, s));
  ffw_ln_bwd_dw_kernel<<<dim3((D + kGradM - 1) / kGradM, (F + kGradO - 1) / kGradO, splits),
                         PG::kThreads, dw_bytes, s>>>(x, D, dpre, F, dw_part, N,
                                                      per_split);  // dW1 = x^T dpre
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum_splits(dw_part, dw1, splits, (long)D * F, s));
  MSFA_TRY(sum_splits(ln_part, sums, row_tiles_d, 3L * D, s));
  MSFA_TRY(sum_splits(db1_part, db1, row_tiles_f, F, s));
  return 0;
}

// The bf16 backward: the same six launches on wgmma (wgmma_ffw.cuh), the LN
// product, then launch_bwd_products on dy and dr; dr is its own f32 scratch,
// a weight-gradient split a whole number of 64-row chunks
template <int D>
int launch_bwd(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
               const float* gamma, const unsigned char* fmask, const unsigned char* rmask,
               const bf16* dout, bf16* dx, bf16* dw1, float* db1, bf16* dw2, float* sums,
               bf16* hd, bf16* dpre, bf16* dy, float* dr, float* ln_part, float* db1_part,
               float* dw_part, int N, int Dv, int F, int splits, float inv_keep, float eps,
               cudaStream_t s) {
  using msfa_wg::WgLnProduct;
  constexpr int kLnBytes = msfa_wg::ln_bwd_smem_bytes<D>();
  MSFA_TRY(msfa_wg::allow_bytes(ffw_ln_bwd_ln_wg_kernel<D>, kLnBytes));
  const int row_tiles_d = (N + msfa_wg::kWgRowsD - 1) / msfa_wg::kWgRowsD;

  MSFA_TRY(launch_hidden(x, w1, b1, fmask, hd, N, D, F, inv_keep, s));
  ffw_ln_bwd_ln_wg_kernel<D><<<row_tiles_d, WgLnProduct<D>::kThreads, kLnBytes, s>>>(
      hd, w2, b2, x, gamma, rmask, dout, dr, dy, ln_part, N, F, Dv, inv_keep, eps);
  MSFA_TRY(cudaGetLastError());
  const msfa_wg::WgBwdKernels k{ffw_ln_bwd_dpre_wg_kernel, ffw_ln_bwd_dx_wg_kernel<D>,
                                ffw_ln_bwd_dw_wg_kernel<D, false>,
                                ffw_ln_bwd_dw_wg_kernel<D, true>};
  const auto sum = [s](const float* part, auto* out, int n, long width) {
    return sum_splits(part, out, n, width, s);
  };
  const int err = msfa_wg::launch_bwd_products<D>(k, x, w1, w2, fmask, dy, dr, hd, dx, dw1, db1,
                                                  dw2, dpre, db1_part, dw_part, N, F, splits,
                                                  inv_keep, s, sum);
  if (err) return err;
  MSFA_TRY(sum(ln_part, sums, row_tiles_d, 3L * D));
  return 0;
}

template <typename T>
int fwd_entry(const T* x, const T* w1, const float* b1, const T* w2, const float* b2,
              const float* gamma, const float* beta, const unsigned char* fmask,
              const unsigned char* rmask, T* out, T* hd, int N, int D, int Dv, int F,
              float inv_keep, float eps, void* stream) {
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

template <typename T>
int bwd_entry(const T* x, const T* w1, const float* b1, const T* w2, const float* b2,
              const float* gamma, const unsigned char* fmask, const unsigned char* rmask,
              const T* dout, T* dx, T* dw1, float* db1, T* dw2, float* sums, T* hd, T* dpre,
              T* dy, float* dr, float* ln_part, float* db1_part, float* dw_part, int N, int D,
              int Dv, int F, int splits, float inv_keep, float eps, void* stream) {
  if (N <= 0 || F <= 0 || F % kColsF != 0 || splits <= 0 || Dv <= 0 || Dv > D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_FFW_BWD(W)                                                                    \
  launch_bwd<W>(x, w1, b1, w2, b2, gamma, fmask, rmask, dout, dx, dw1, db1, dw2, sums, hd, \
                dpre, dy, dr, ln_part, db1_part, dw_part, N, Dv, F, splits, inv_keep, eps, s)
  switch (D) {
    case 32: return MSFA_FFW_BWD(32);
    case 64: return MSFA_FFW_BWD(64);
    case 128: return MSFA_FFW_BWD(128);
    case 256: return MSFA_FFW_BWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSFA_FFW_BWD
}

// the f32 entries' six kernels
int smem_bytes(int D, int* bytes) {
  const int fb = (int)sizeof(float);
  bytes[0] = HiddenProduct::kSmemFloats * fb;
  bytes[3] = DhdProduct::kSmemFloats * fb;
  bytes[5] = GradProduct::kSmemFloats * fb;
  switch (D) {
#define MSFA_FFW_SMEM(W)                               \
  case W:                                              \
    bytes[1] = bytes[2] = ln_smem_floats<W>() * fb;    \
    bytes[4] = DxProduct<W>::kSmemFloats * fb;         \
    return 0;
    MSFA_FFW_SMEM(32)
    MSFA_FFW_SMEM(64)
    MSFA_FFW_SMEM(128)
    MSFA_FFW_SMEM(256)
#undef MSFA_FFW_SMEM
    default: return (int)cudaErrorInvalidValue;
  }
}

// the bf16 entries' six kernels, all on wgmma
int smem_bytes_wg(int D, int* bytes) {
  using msfa_wg::ring_smem_bytes;
  bytes[0] = msfa_wg::hidden_smem_bytes();
  bytes[3] = msfa_wg::dpre_smem_bytes();
  switch (D) {
#define MSFA_FFW_SMEM(W)                                         \
  case W:                                                        \
    bytes[1] = msfa_wg::y_rows_smem_bytes<W>();                  \
    bytes[2] = msfa_wg::ln_bwd_smem_bytes<W>();                  \
    bytes[4] = ring_smem_bytes<msfa_wg::WgDxProduct<W>>();       \
    bytes[5] = ring_smem_bytes<msfa_wg::WgGradProduct<W>>();     \
    return 0;
    MSFA_FFW_SMEM(32)
    MSFA_FFW_SMEM(64)
    MSFA_FFW_SMEM(128)
    MSFA_FFW_SMEM(256)
#undef MSFA_FFW_SMEM
    default: return (int)cudaErrorInvalidValue;
  }
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
  return fwd_entry(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, out, hd, N, D, Dv, F,
                   inv_keep, eps, stream);
}

// The bf16 entry: x, w1, w2, out and the hidden's scratch hd bf16.
int msfa_ffw_ln_fwd_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                         const float* b2, const float* gamma, const float* beta,
                         const unsigned char* fmask, const unsigned char* rmask, bf16* out,
                         bf16* hd, int N, int D, int Dv, int F, float inv_keep, float eps,
                         void* stream) {
  return fwd_entry(x, w1, b1, w2, b2, gamma, beta, fmask, rmask, out, hd, N, D, Dv, F,
                   inv_keep, eps, stream);
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
  return bwd_entry(x, w1, b1, w2, b2, gamma, fmask, rmask, dout, dx, dw1, db1, dw2, sums, hd,
                   dpre, dy, dx, ln_part, db1_part, dw_part, N, D, Dv, F, splits, inv_keep,
                   eps, stream);
}

// The bf16 entry: x, w1, w2, dout, dx, dw1, dw2 and the scratch hd, dpre, dy
// bf16; dr [N, D] an f32 scratch.
int msfa_ffw_ln_bwd_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                         const float* b2, const float* gamma, const unsigned char* fmask,
                         const unsigned char* rmask, const bf16* dout, bf16* dx, bf16* dw1,
                         float* db1, bf16* dw2, float* sums, bf16* hd, bf16* dpre, bf16* dy,
                         float* dr, float* ln_part, float* db1_part, float* dw_part, int N,
                         int D, int Dv, int F, int splits, float inv_keep, float eps,
                         void* stream) {
  return bwd_entry(x, w1, b1, w2, b2, gamma, fmask, rmask, dout, dx, dw1, db1, dw2, sums, hd,
                   dpre, dy, dr, ln_part, db1_part, dw_part, N, D, Dv, F, splits, inv_keep,
                   eps, stream);
}

// Dynamic shared memory per block of the six product kernels (hidden, fwd,
// ln, dpre, dx, dw) at width D, into bytes[0..5]; the bf16 entries' beside it.
int msfa_ffw_ln_smem_bytes(int D, int* bytes) { return smem_bytes(D, bytes); }
int msfa_ffw_ln_bf16_smem_bytes(int D, int* bytes) { return smem_bytes_wg(D, bytes); }

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
