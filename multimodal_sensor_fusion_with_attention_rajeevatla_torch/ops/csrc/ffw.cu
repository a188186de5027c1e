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

#include <cuda_runtime.h>
#include <math.h>

#include "ffw_products.cuh"
#include "residual_ln.cuh"

namespace {

using namespace msfa_ffw;
using namespace msfa_ln;

// hd = relu(x W1 + b1) * mask * inv_keep for a 128-row x 64-column tile
__global__ void __launch_bounds__(HiddenProduct::kThreads, 2)
fused_mlp_hidden_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                        const float* __restrict__ b1, const unsigned char* __restrict__ mask,
                        float* __restrict__ hd, int N, int D, int F, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  hidden_tile(x, w1, b1, mask, hd, N, D, F, inv_keep, smem);
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
        *reinterpret_cast<float2*>(out + (long)n * D + c) =
            make_float2(acc[i][j][2 * h] + b2[c], acc[i][j][2 * h + 1] + b2[c + 1]);
      }
    }
}

// dpre = (hd > 0) * (dout W2^T) * mask * inv_keep for a 128-row x 64-column
// tile, and the block's column sums of dpre (db1's partial)
__global__ void __launch_bounds__(DhdProduct::kThreads, 2)
fused_mlp_bwd_dpre_kernel(const float* __restrict__ dout, const float* __restrict__ w2,
                          const float* __restrict__ hd, const unsigned char* __restrict__ mask,
                          float* __restrict__ dpre, float* __restrict__ part, int N, int D, int F,
                          float inv_keep) {
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

// out[e] = sum over s of part[s][e], s in order
__global__ void __launch_bounds__(256)
fused_mlp_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int splits,
                         long width) {
  ordered_sum(part, out, splits, width);
}

cudaError_t sum_splits(const float* part, float* out, int splits, long width, cudaStream_t s) {
  fused_mlp_bwd_sum_kernel<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(part, out, splits,
                                                                           width);
  return cudaGetLastError();
}

// the hidden, as both directions take it
cudaError_t launch_hidden(const float* x, const float* w1, const float* b1,
                          const unsigned char* mask, float* hd, int N, int D, int F,
                          float inv_keep, cudaStream_t s) {
  const cudaError_t err = allow_smem(fused_mlp_hidden_kernel, HiddenProduct::kSmemFloats);
  if (err != cudaSuccess) return err;
  const dim3 grid(F / kColsF, (N + kRowsF - 1) / kRowsF);
  fused_mlp_hidden_kernel<<<grid, HiddenProduct::kThreads,
                            HiddenProduct::kSmemFloats * (int)sizeof(float), s>>>(
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

template <int D>
int launch_bwd(const float* x, const float* w1, const float* b1, const float* w2,
               const unsigned char* mask, const float* dout, float* dx, float* dw1, float* db1,
               float* dw2, float* hd, float* dpre, float* db1_part, float* dw_part, int N,
               int F, int splits, float inv_keep, cudaStream_t s) {
  MSFA_TRY(allow_smem(fused_mlp_bwd_dpre_kernel, DhdProduct::kSmemFloats));
  MSFA_TRY(allow_smem(fused_mlp_bwd_dx_kernel<D>, DxProduct<D>::kSmemFloats));
  MSFA_TRY(allow_smem(fused_mlp_bwd_dw_kernel, GradProduct::kSmemFloats));
  const int row_tiles_f = (N + kRowsF - 1) / kRowsF;
  const int fb = (int)sizeof(float);

  MSFA_TRY(launch_hidden(x, w1, b1, mask, hd, N, D, F, inv_keep, s));
  fused_mlp_bwd_dpre_kernel<<<dim3(F / kColsF, row_tiles_f), DhdProduct::kThreads,
                              DhdProduct::kSmemFloats * fb, s>>>(dout, w2, hd, mask, dpre,
                                                                 db1_part, N, D, F, inv_keep);
  MSFA_TRY(cudaGetLastError());
  fused_mlp_bwd_dx_kernel<D><<<(N + kRowsD - 1) / kRowsD, DxProduct<D>::kThreads,
                               DxProduct<D>::kSmemFloats * fb, s>>>(dpre, w1, dx, N, F);
  MSFA_TRY(cudaGetLastError());

  const int per_split = rows_per_split(N, splits);
  const int dw_bytes = GradProduct::kSmemFloats * fb;
  fused_mlp_bwd_dw_kernel<<<dim3((F + kGradM - 1) / kGradM, (D + kGradO - 1) / kGradO, splits),
                            GradProduct::kThreads, dw_bytes, s>>>(hd, F, dout, D, dw_part, N,
                                                                  per_split);  // dW2 = hd^T dout
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum_splits(dw_part, dw2, splits, (long)F * D, s));
  fused_mlp_bwd_dw_kernel<<<dim3((D + kGradM - 1) / kGradM, (F + kGradO - 1) / kGradO, splits),
                            GradProduct::kThreads, dw_bytes, s>>>(x, D, dpre, F, dw_part, N,
                                                                  per_split);  // dW1 = x^T dpre
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum_splits(dw_part, dw1, splits, (long)D * F, s));
  MSFA_TRY(sum_splits(db1_part, db1, row_tiles_f, F, s));
  return 0;
}

}  // namespace

extern "C" {

// Widths the kernels are instantiated for (D); F must be a multiple of 64.
// The wrapper checks both before calling. mask may be null (no dropout).
// Scratch: hd [N, F], which holds the hidden on return.
int msfa_ffw_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                 const float* b2, const unsigned char* mask, float* out, float* hd, int N, int D,
                 int F, float inv_keep, void* stream) {
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

// Scratch: hd, dpre [N, F], db1_part [ceil(N/128), F], dw_part [splits, D * F];
// hd holds the hidden on return.
int msfa_ffw_bwd(const float* x, const float* w1, const float* b1, const float* w2,
                 const unsigned char* mask, const float* dout, float* dx, float* dw1,
                 float* db1, float* dw2, float* hd, float* dpre, float* db1_part,
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

// Dynamic shared memory per block of the five product kernels (hidden, fwd,
// dpre, dx, dw) at width D, into bytes[0..4].
int msfa_ffw_smem_bytes(int D, int* bytes) {
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

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
