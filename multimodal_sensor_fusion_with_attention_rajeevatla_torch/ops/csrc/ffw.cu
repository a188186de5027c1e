// Fused feed-forward block, forward and backward, f32 and bf16 operands, for
// Hopper (sm_90a).
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
// Backward, from dout: recompute hd, then
//   dpre = (hd > 0) * (dout W2^T) * mask * inv_keep,
//   dx = dpre W1^T,  dW1 = x^T dpre,  db1 = sum dpre,  dW2 = hd^T dout.
//   db2 = sum dout is a column sum the wrapper takes outside, as the TPU
//   version does.
//
// What bounds it on the H100: operations. At the training shape (N = 16384,
// D = 256, F = 2048) the forward does 4*N*D*F = 34.4 GFLOP and the backward
// 10*N*D*F = 85.9 GFLOP: 0.21 ms and 0.52 ms at 495/3 = 165 TFLOP/s as
// 3xTF32 on the tensor cores (0.51 ms and 1.28 ms on the CUDA cores), against
// ~71 MB of x, mask and output (0.02 ms).
//
// Design. ffw_ln.cu's chain without the LayerNorm: every product on the TF32
// tensor cores at f32 accuracy (3xTF32), a tile of tc_product.cuh's template
// with its own epilogue, the bodies shared with ffw_ln.cu (ffw_products.cuh,
// residual_ln.cuh). The hidden is an [N, F] operand in device memory (scratch
// the wrapper allocates), written once and read once by each direction, where
// the TPU kernel kept it on chip.
//   hidden:   hd = relu(x W1 + b1) * mask * inv_keep, 128-row x 64-column
//             tiles (hidden_tile): launched by both directions with the same
//             arguments, so the backward's hd, and with it every ReLU branch,
//             is the forward's bit for bit, and ffw_ln's on the same inputs
// Forward:
//   fwd:      out = hd W2 + b2 on 64 whole rows, b2 added to the accumulators
//             (the bf16 entry's on 128 rows, below)
// Backward:
//   dpre:     dpre = (hd > 0) * (dout W2^T) * mask * inv_keep, and per-block
//             partials of db1 (dpre_tile)
//   dx:       dx = dpre W1^T (dx_tile, overwriting)
//   dw:       dW2 = hd^T dout and dW1 = x^T dpre, per split of the rows
//             (grad_tile)
//   sum:      the splits and db1's partials, added in order (ordered_sum)
// Blocks run in no order, so every sum across blocks is partials added in a
// fixed order: no atomics, and a run repeats bit for bit. Rows past N load
// zeros, are never written and add nothing; inv_keep = 0 under a mask gives
// an exactly zero hidden, so out = b2.
//
// bf16 entries (msfa_ffw_fwd_bf16, msfa_ffw_bwd_bf16: mixed_precision with
// fused_mlp on and fused_mlp_ln off), the function of the reference's
// _fwd_kernel / _bwd_kernel when x is bf16 (their compute type is x's): x,
// W1, W2 and dout bf16; out, dx, dW1, dW2 bf16 (the reference returns the
// weights' gradients in their type); b1, b2 and db1 f32. pre sums exact bf16
// products in f32; the hidden is rounded to bf16 before W2's product and
// before dW2's (kept so in its scratch, half the bytes); dpre is rounded to
// bf16 before both dW1 = x^T dpre and dx = dpre W1^T, and db1 sums the
// unrounded f32 dpre. Every product takes two bf16 operands: the forward's
// 34.4 GFLOP and the backward's 85.9 bound at the bf16 tensor-core peak (989
// TFLOP/s): 0.035 ms and 0.087 ms at the training shape, against ~52 and ~64
// MB of bf16 activations, masks and weights.
//   Backward: on wgmma, the bodies of ffw_ln.cu's bf16 backward
//   (wgmma_ffw.cuh over wgmma_bf16.cuh's WgProduct, m64n64k16 bf16 from
//   128-byte-swizzled shared memory filled by cp.async) without its LN
//   product: the hidden (wg_hidden_tile, shared with the forward: the same
//   bits), dpre with dout in dy's place (wg_dpre_tile, k = D in one sum in
//   the unit, 128 x 128 tiles), dx = dpre W1^T with no dr (wg_dx_tile<D,
//   false>, 128 whole rows, 64-deep fresh accumulators added in f32), dW2 =
//   hd^T dout and dW1 = (dpre^T x)^T per split of whole 64-row chunks
//   (wg_grad_tile, mlp.py _wg_grad_splits), then the ordered sums.
//   Forward: the wgmma hidden, then out = hd W2 + b2 on 128 whole rows
//   (wgmma_ffw.cuh's wg_out_tile: ffw_ln.cu's bf16 y product, wg_y_rows,
//   64-deep fresh accumulators added in f32, staged in shared memory, then
//   b2 added and rounded to bf16 in 16-byte stores).

#include <cuda_runtime.h>
#include <math.h>

#include "ffw_products.cuh"
#include "residual_ln.cuh"
#include "wgmma_ffw.cuh"

namespace {

using namespace msfa_ffw;
using namespace msfa_ln;
using bf16 = __nv_bfloat16;

// hd = relu(x W1 + b1) * mask * inv_keep for a 128-row x 64-column tile
__global__ void __launch_bounds__(HiddenProduct::kThreads, 2)
fused_mlp_hidden_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                        const float* __restrict__ b1, const unsigned char* __restrict__ mask,
                        float* __restrict__ hd, int N, int D, int F, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  hidden_tile(x, w1, b1, mask, hd, N, D, F, inv_keep, smem);
}

// the bf16 hidden on wgmma: wgmma_ffw.cuh's wg_hidden_tile, the body of
// ffw_ln.cu's bf16 hidden kernel too (the same bits)
__global__ void __launch_bounds__(msfa_wg::WgFProduct::kThreads, 2)
fused_mlp_hidden_wg_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                           const float* __restrict__ b1, const unsigned char* __restrict__ mask,
                           bf16* __restrict__ hd, int N, int D, int F, float inv_keep) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  msfa_wg::wg_hidden_tile(x, w1, b1, mask, hd, N, D, F, inv_keep, msfa_wg::align1024(wg_smem));
}

// out = hd W2 + b2 for 64 whole rows
template <int D>
__global__ void __launch_bounds__(LnProduct<D>::kThreads)
fused_mlp_fwd_kernel(const float* __restrict__ hd, const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ out, int N, int F) {
  using P = LnProduct<D>;
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * kRowsD;
  const typename P::A a{hd + (long)n0 * F, F, N - n0, F};
  const typename P::B b{w2, D, D, F};
  typename P::Acc acc;
  P::run(a, b, F, smem, acc);
#pragma unroll
  for (int i = 0; i < P::kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + P::row(i, 2 * h);
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < P::kNT; ++j) {
        const int c = P::col(j, 0);
        msfa_tc::store2(out + (long)n * D + c, acc[i][j][2 * h] + b2[c],
                        acc[i][j][2 * h + 1] + b2[c + 1]);
      }
    }
}

// out = hd W2 + b2 for 128 whole rows, rounded to bf16 (wgmma_ffw.cuh's
// wg_out_tile: ffw_ln.cu's bf16 y product)
template <int D>
__global__ void __launch_bounds__(msfa_wg::WgLnProduct<D>::kThreads)
fused_mlp_fwd_wg_kernel(const bf16* __restrict__ hd, const bf16* __restrict__ w2,
                        const float* __restrict__ b2, bf16* __restrict__ out, int N, int F) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  msfa_wg::wg_out_tile<D>(hd, F, w2, b2, out, N, msfa_wg::align1024(wg_smem));
}

// dpre = (hd > 0) * (dout W2^T) * mask * inv_keep for a 128-row x 64-column
// tile, and the block's column sums of dpre (db1's partial)
__global__ void __launch_bounds__(DhdProduct::kThreads, 2)
fused_mlp_bwd_dpre_kernel(const float* __restrict__ dout, const float* __restrict__ w2,
                          const float* __restrict__ hd, const unsigned char* __restrict__ mask,
                          float* __restrict__ dpre, float* __restrict__ part, int N, int D,
                          int F, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  dpre_tile(dout, w2, hd, mask, dpre, part, N, D, F, inv_keep, smem);
}

// dx = dpre W1^T for 64 whole rows
template <int D>
__global__ void __launch_bounds__(DxProduct<D>::kThreads)
fused_mlp_bwd_dx_kernel(const float* __restrict__ dpre, const float* __restrict__ w1,
                        float* __restrict__ dx, int N, int F) {
  extern __shared__ __align__(16) float smem[];
  dx_tile<D, false>(dpre, F, w1, nullptr, dx, N, smem);
}

// part[split] = A[rows of split]^T B[rows of split] for a 128 x 64 tile of
// the [M, O] weight gradient (A [N, M], B [N, O] row-major)
__global__ void __launch_bounds__(GradProduct::kThreads, 2)
fused_mlp_bwd_dw_kernel(const float* __restrict__ A, int M, const float* __restrict__ B, int O,
                        float* __restrict__ part, int N, int rows_per_split) {
  extern __shared__ __align__(16) float smem[];
  grad_tile(A, M, B, O, part, N, rows_per_split, smem);
}

// The bf16 backward's kernels on wgmma (wgmma_ffw.cuh's bodies)
__global__ void __launch_bounds__(msfa_wg::WgDpreProduct::kThreads, 2)
fused_mlp_bwd_dpre_wg_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ w2,
                             const bf16* __restrict__ hd, const unsigned char* __restrict__ mask,
                             bf16* __restrict__ dpre, float* __restrict__ part, int N, int D,
                             int F, float inv_keep) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  msfa_wg::wg_dpre_tile(dout, w2, hd, mask, dpre, part, N, D, F, inv_keep,
                        msfa_wg::align1024(wg_smem));
}

template <int D>
__global__ void __launch_bounds__(msfa_wg::WgDxProduct<D>::kThreads)
fused_mlp_bwd_dx_wg_kernel(const bf16* __restrict__ dpre, const bf16* __restrict__ w1,
                           const float* __restrict__ dr, bf16* __restrict__ dx, int N, int F) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];  // dr: none (nullptr), not read
  msfa_wg::wg_dx_tile<D, false>(dpre, F, w1, dr, dx, N, msfa_wg::align1024(wg_smem));
}

template <int D, bool kTransposed>
__global__ void __launch_bounds__(msfa_wg::WgGradProduct<D>::kThreads)
fused_mlp_bwd_dw_wg_kernel(const bf16* __restrict__ A, int M, const bf16* __restrict__ B,
                           float* __restrict__ part, int N, int rows_per_split) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  msfa_wg::wg_grad_tile<D, kTransposed>(A, M, B, part, N, rows_per_split,
                                        msfa_wg::align1024(wg_smem));
}

// out[e] = sum over s of part[s][e], s in order (rounded to bf16 for a bf16 out)
template <typename Out>
__global__ void __launch_bounds__(256)
fused_mlp_bwd_sum_kernel(const float* __restrict__ part, Out* __restrict__ out, int splits,
                         long width) {
  ordered_sum(part, out, splits, width);
}

template <typename Out>
cudaError_t sum_splits(const float* part, Out* out, int splits, long width, cudaStream_t s) {
  fused_mlp_bwd_sum_kernel<Out><<<(unsigned)((width + 255) / 256), 256, 0, s>>>(
      part, out, splits, width);
  return cudaGetLastError();
}

// the hidden, as both directions take it
cudaError_t launch_hidden(const float* x, const float* w1, const float* b1,
                          const unsigned char* mask, float* hd, int N, int D, int F,
                          float inv_keep, cudaStream_t s) {
  using P = HiddenProduct;
  const cudaError_t err = allow_smem(fused_mlp_hidden_kernel, P::kSmemFloats);
  if (err != cudaSuccess) return err;
  const dim3 grid(F / kColsF, (N + kRowsF - 1) / kRowsF);
  fused_mlp_hidden_kernel<<<grid, P::kThreads, P::kSmemFloats * (int)sizeof(float), s>>>(
      x, w1, b1, mask, hd, N, D, F, inv_keep);
  return cudaGetLastError();
}

// the bf16 hidden, on wgmma
cudaError_t launch_hidden(const bf16* x, const bf16* w1, const float* b1,
                          const unsigned char* mask, bf16* hd, int N, int D, int F,
                          float inv_keep, cudaStream_t s) {
  constexpr int kBytes = msfa_wg::hidden_smem_bytes();
  const cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_hidden_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + msfa_wg::kWgColsF - 1) / msfa_wg::kWgColsF, (N + kRowsF - 1) / kRowsF);
  fused_mlp_hidden_wg_kernel<<<grid, msfa_wg::WgFProduct::kThreads, kBytes, s>>>(
      x, w1, b1, mask, hd, N, D, F, inv_keep);
  return cudaGetLastError();
}

template <int D>
int launch_fwd(const float* x, const float* w1, const float* b1, const float* w2,
               const float* b2, const unsigned char* mask, float* out, float* hd, int N, int F,
               float inv_keep, cudaStream_t s) {
  using P = LnProduct<D>;
  MSFA_TRY(allow_smem(fused_mlp_fwd_kernel<D>, P::kSmemFloats));
  MSFA_TRY(launch_hidden(x, w1, b1, mask, hd, N, D, F, inv_keep, s));
  fused_mlp_fwd_kernel<D><<<(N + kRowsD - 1) / kRowsD, P::kThreads,
                            P::kSmemFloats * (int)sizeof(float), s>>>(hd, w2, b2, out, N, F);
  MSFA_TRY(cudaGetLastError());
  return 0;
}

// The bf16 forward: the wgmma hidden, then out = hd W2 + b2 on 128 whole rows
template <int D>
int launch_fwd(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
               const unsigned char* mask, bf16* out, bf16* hd, int N, int F, float inv_keep,
               cudaStream_t s) {
  constexpr int kBytes = msfa_wg::y_rows_smem_bytes<D>();
  MSFA_TRY(msfa_wg::allow_bytes(fused_mlp_fwd_wg_kernel<D>, kBytes));
  MSFA_TRY(launch_hidden(x, w1, b1, mask, hd, N, D, F, inv_keep, s));
  fused_mlp_fwd_wg_kernel<D><<<(N + msfa_wg::kWgRowsD - 1) / msfa_wg::kWgRowsD,
                               msfa_wg::WgLnProduct<D>::kThreads, kBytes, s>>>(hd, w2, b2, out,
                                                                               N, F);
  MSFA_TRY(cudaGetLastError());
  return 0;
}

// The f32 backward
template <int D>
int launch_bwd(const float* x, const float* w1, const float* b1, const float* w2,
               const unsigned char* mask, const float* dout, float* dx, float* dw1, float* db1,
               float* dw2, float* hd, float* dpre, float* db1_part, float* dw_part, int N, int F,
               int splits, float inv_keep, cudaStream_t s) {
  using PH = DhdProduct;
  using PX = DxProduct<D>;
  using PG = GradProduct;
  MSFA_TRY(allow_smem(fused_mlp_bwd_dpre_kernel, PH::kSmemFloats));
  MSFA_TRY(allow_smem(fused_mlp_bwd_dx_kernel<D>, PX::kSmemFloats));
  MSFA_TRY(allow_smem(fused_mlp_bwd_dw_kernel, PG::kSmemFloats));
  const int row_tiles_f = (N + kRowsF - 1) / kRowsF;
  const int fb = (int)sizeof(float);

  MSFA_TRY(launch_hidden(x, w1, b1, mask, hd, N, D, F, inv_keep, s));
  fused_mlp_bwd_dpre_kernel<<<dim3(F / kColsF, row_tiles_f), PH::kThreads, PH::kSmemFloats * fb,
                              s>>>(dout, w2, hd, mask, dpre, db1_part, N, D, F, inv_keep);
  MSFA_TRY(cudaGetLastError());
  fused_mlp_bwd_dx_kernel<D><<<(N + kRowsD - 1) / kRowsD, PX::kThreads, PX::kSmemFloats * fb,
                               s>>>(dpre, w1, dx, N, F);
  MSFA_TRY(cudaGetLastError());

  const int per_split = rows_per_split(N, splits);
  const int dw_bytes = PG::kSmemFloats * fb;
  fused_mlp_bwd_dw_kernel<<<dim3((F + kGradM - 1) / kGradM, (D + kGradO - 1) / kGradO, splits),
                            PG::kThreads, dw_bytes, s>>>(hd, F, dout, D, dw_part, N,
                                                         per_split);  // dW2 = hd^T dout
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum_splits(dw_part, dw2, splits, (long)F * D, s));
  fused_mlp_bwd_dw_kernel<<<dim3((D + kGradM - 1) / kGradM, (F + kGradO - 1) / kGradO, splits),
                            PG::kThreads, dw_bytes, s>>>(x, D, dpre, F, dw_part, N,
                                                         per_split);  // dW1 = x^T dpre
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum_splits(dw_part, dw1, splits, (long)D * F, s));
  MSFA_TRY(sum_splits(db1_part, db1, row_tiles_f, F, s));
  return 0;
}

// The bf16 backward on wgmma: the hidden, then wgmma_ffw.cuh's
// launch_bwd_products (ffw_ln.cu's bf16 backward without its LN product,
// dout in dy's place and no dr); a weight-gradient split a whole number of
// 64-row chunks
template <int D>
int launch_bwd(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
               const unsigned char* mask, const bf16* dout, bf16* dx, bf16* dw1, float* db1,
               bf16* dw2, bf16* hd, bf16* dpre, float* db1_part, float* dw_part, int N, int F,
               int splits, float inv_keep, cudaStream_t s) {
  MSFA_TRY(launch_hidden(x, w1, b1, mask, hd, N, D, F, inv_keep, s));
  const msfa_wg::WgBwdKernels k{fused_mlp_bwd_dpre_wg_kernel, fused_mlp_bwd_dx_wg_kernel<D>,
                                fused_mlp_bwd_dw_wg_kernel<D, false>,
                                fused_mlp_bwd_dw_wg_kernel<D, true>};
  return msfa_wg::launch_bwd_products<D>(
      k, x, w1, w2, mask, dout, nullptr, hd, dx, dw1, db1, dw2, dpre, db1_part, dw_part, N, F,
      splits, inv_keep, s, [s](const float* part, auto* out, int n, long width) {
        return sum_splits(part, out, n, width, s);
      });
}

template <typename T>
int fwd_entry(const T* x, const T* w1, const float* b1, const T* w2, const float* b2,
              const unsigned char* mask, T* out, T* hd, int N, int D, int F, float inv_keep,
              void* stream) {
  if (N <= 0 || F <= 0 || F % kColsF != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_FFW_FWD(W) launch_fwd<W>(x, w1, b1, w2, b2, mask, out, hd, N, F, inv_keep, s)
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
int bwd_entry(const T* x, const T* w1, const float* b1, const T* w2, const unsigned char* mask,
              const T* dout, T* dx, T* dw1, float* db1, T* dw2, T* hd, T* dpre, float* db1_part,
              float* dw_part, int N, int D, int F, int splits, float inv_keep, void* stream) {
  if (N <= 0 || F <= 0 || F % kColsF != 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_FFW_BWD(W)                                                                      \
  launch_bwd<W>(x, w1, b1, w2, mask, dout, dx, dw1, db1, dw2, hd, dpre, db1_part, dw_part, \
                N, F, splits, inv_keep, s)
  switch (D) {
    case 32: return MSFA_FFW_BWD(32);
    case 64: return MSFA_FFW_BWD(64);
    case 128: return MSFA_FFW_BWD(128);
    case 256: return MSFA_FFW_BWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSFA_FFW_BWD
}

// the f32 entries' five kernels
int smem_bytes(int D, int* bytes) {
  const int fb = (int)sizeof(float);
  bytes[0] = HiddenProduct::kSmemFloats * fb;
  bytes[2] = DhdProduct::kSmemFloats * fb;
  bytes[4] = GradProduct::kSmemFloats * fb;
  switch (D) {
#define MSFA_FFW_SMEM(W)                                  \
  case W:                                                 \
    bytes[1] = LnProduct<W>::kSmemFloats * fb;            \
    bytes[3] = DxProduct<W>::kSmemFloats * fb;            \
    return 0;
    MSFA_FFW_SMEM(32)
    MSFA_FFW_SMEM(64)
    MSFA_FFW_SMEM(128)
    MSFA_FFW_SMEM(256)
#undef MSFA_FFW_SMEM
    default: return (int)cudaErrorInvalidValue;
  }
}

// the bf16 entries' five, all on wgmma
int smem_bytes_wg(int D, int* bytes) {
  using msfa_wg::ring_smem_bytes;
  bytes[0] = msfa_wg::hidden_smem_bytes();
  bytes[2] = msfa_wg::dpre_smem_bytes();
  switch (D) {
#define MSFA_FFW_SMEM(W)                                         \
  case W:                                                        \
    bytes[1] = msfa_wg::y_rows_smem_bytes<W>();                  \
    bytes[3] = ring_smem_bytes<msfa_wg::WgDxProduct<W>>();       \
    bytes[4] = ring_smem_bytes<msfa_wg::WgGradProduct<W>>();     \
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

// Widths the kernels are instantiated for (D); F must be a multiple of 64.
// The wrapper checks both before calling. mask may be null (no dropout).
// Scratch: hd [N, F], which holds the hidden on return.
int msfa_ffw_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                 const float* b2, const unsigned char* mask, float* out, float* hd, int N, int D,
                 int F, float inv_keep, void* stream) {
  return fwd_entry(x, w1, b1, w2, b2, mask, out, hd, N, D, F, inv_keep, stream);
}

// The bf16 entry: x, w1, w2, out and the hidden's scratch hd bf16.
int msfa_ffw_fwd_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                      const float* b2, const unsigned char* mask, bf16* out, bf16* hd, int N,
                      int D, int F, float inv_keep, void* stream) {
  return fwd_entry(x, w1, b1, w2, b2, mask, out, hd, N, D, F, inv_keep, stream);
}

// Scratch: hd, dpre [N, F], db1_part [ceil(N/128), F], dw_part [splits, D * F];
// hd holds the hidden on return. The bf16 entry's splits are whole 64-row
// chunks (mlp.py _wg_grad_splits), the f32 entry's _grad_splits.
int msfa_ffw_bwd(const float* x, const float* w1, const float* b1, const float* w2,
                 const unsigned char* mask, const float* dout, float* dx, float* dw1,
                 float* db1, float* dw2, float* hd, float* dpre, float* db1_part,
                 float* dw_part, int N, int D, int F, int splits, float inv_keep, void* stream) {
  return bwd_entry(x, w1, b1, w2, mask, dout, dx, dw1, db1, dw2, hd, dpre, db1_part, dw_part,
                   N, D, F, splits, inv_keep, stream);
}

// The bf16 entry: x, w1, w2, dout, dx, dw1, dw2 and the scratch hd, dpre bf16;
// db1 and the partials f32.
int msfa_ffw_bwd_bf16(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                      const unsigned char* mask, const bf16* dout, bf16* dx, bf16* dw1,
                      float* db1, bf16* dw2, bf16* hd, bf16* dpre, float* db1_part,
                      float* dw_part, int N, int D, int F, int splits, float inv_keep,
                      void* stream) {
  return bwd_entry(x, w1, b1, w2, mask, dout, dx, dw1, db1, dw2, hd, dpre, db1_part, dw_part,
                   N, D, F, splits, inv_keep, stream);
}

// Dynamic shared memory per block of the five product kernels (hidden, fwd,
// dpre, dx, dw) at width D, into bytes[0..4]; the bf16 entries' beside it.
int msfa_ffw_smem_bytes(int D, int* bytes) { return smem_bytes(D, bytes); }
int msfa_ffw_bf16_smem_bytes(int D, int* bytes) { return smem_bytes_wg(D, bytes); }

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
