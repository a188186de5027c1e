// The [N, d_ff] products that the FFW residual-LN kernels (ffw_ln.cu) and the
// feed-forward pair (ffw.cu) share, for Hopper (sm_90a), on tc_product.cuh's
// 3xTF32 template. Each kernel that calls a body below is a thin __global__
// of its own source, so a profile names the kernel it came from.
//
//   hidden_tile   hd = relu(x W1 + b1) * fmask * inv_keep for a 128-row x
//                 64-column tile. Both directions of both pairs launch it
//                 with the same arguments, so every backward's hd, and with it
//                 every ReLU branch, is its forward's bit for bit (the ReLU's
//                 derivative is a step: a backward that rounded pre otherwise
//                 would flip the units within rounding of zero)
//   dpre_tile     dpre = (hd > 0) * (g W2^T) * fmask * inv_keep for a 128 x 64
//                 tile, g = dy (ffw_ln) or dout (ffw), and the block's column
//                 sums of dpre (db1's partial). hd > 0 is pre > 0 wherever the
//                 mask keeps the unit; where it drops it, dpre is 0 either way.
//
// Both take f32 operands: the bf16 entries' products run on wgmma
// (wgmma_ffw.cuh's wg_hidden_tile and wg_dpre_tile).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tc_product.cuh"

namespace msfa_ffw {

namespace tc = msfa_tc;

// [N, F] products over k = D (hidden, dpre): 128 x 64 tiles, 8 warps
using HiddenProduct = tc::TcProduct<128, 64, 4, 2, false, true>;  // x [n][d] . W1 [d][f]
using DhdProduct = tc::TcProduct<128, 64, 4, 2, false, false>;  // g [n][d] . (W2 [f][d])^T

constexpr int kRowsF = 128;  // rows of a block in the [N, F] products
constexpr int kColsF = 64;   // hidden columns of a block in the [N, F] products

// the dropout scale of two neighbouring elements: mask * inv_keep, or 1 without a mask
__device__ __forceinline__ float2 keep_scale2(const unsigned char* __restrict__ mask, long at,
                                              float inv_keep) {
  if (!mask) return make_float2(1.f, 1.f);
  const uchar2 m = *reinterpret_cast<const uchar2*>(mask + at);
  return make_float2((float)m.x * inv_keep, (float)m.y * inv_keep);
}

// hd = relu(x W1 + b1) * fmask * inv_keep for the block's tile; blockIdx is
// (column tile, row tile)
__device__ __forceinline__ void hidden_tile(const float* __restrict__ x,
                                            const float* __restrict__ w1,
                                            const float* __restrict__ b1,
                                            const unsigned char* __restrict__ fmask,
                                            float* __restrict__ hd, int N, int D, int F,
                                            float inv_keep, float* smem) {
  using P = HiddenProduct;
  const int f0 = blockIdx.x * kColsF, n0 = blockIdx.y * kRowsF;
  const typename P::A a{x + (long)n0 * D, D, N - n0, D};
  const typename P::B b{w1 + f0, F, F - f0, D};
  typename P::Acc acc;
  P::run(a, b, D, smem, acc);
#pragma unroll
  for (int i = 0; i < P::kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m16 tile
      const int n = n0 + P::row(i, 2 * h);
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < P::kNT; ++j) {
        const int f = f0 + P::col(j, 0);
        const long at = (long)n * F + f;
        const float2 fs = keep_scale2(fmask, at, inv_keep);
        const float p0 = acc[i][j][2 * h] + b1[f], p1 = acc[i][j][2 * h + 1] + b1[f + 1];
        tc::store2(hd + at, fmaxf(p0, 0.f) * fs.x, fmaxf(p1, 0.f) * fs.y);
      }
    }
}

// dpre = (hd > 0) * (g W2^T) * fmask * inv_keep for the block's tile, and the
// block's column sums of dpre into part[blockIdx.y][F]
__device__ __forceinline__ void dpre_tile(const float* __restrict__ g,
                                          const float* __restrict__ w2,
                                          const float* __restrict__ hd,
                                          const unsigned char* __restrict__ fmask,
                                          float* __restrict__ dpre, float* __restrict__ part,
                                          int N, int D, int F, float inv_keep, float* smem) {
  using P = DhdProduct;
  const int f0 = blockIdx.x * kColsF, n0 = blockIdx.y * kRowsF;
  const typename P::A a{g + (long)n0 * D, D, N - n0, D};
  const typename P::B b{w2 + (long)f0 * D, D, F - f0, D};  // (W2^T)(d, f) = W2[f][d]
  typename P::Acc acc;
  P::run(a, b, D, smem, acc);
  float cs[P::kNT][2];
#pragma unroll
  for (int j = 0; j < P::kNT; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
  for (int i = 0; i < P::kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + P::row(i, 2 * h);
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < P::kNT; ++j) {
        const long at = (long)n * F + f0 + P::col(j, 0);
        const float2 fs = keep_scale2(fmask, at, inv_keep);
        const float2 h2 = tc::load2(hd + at);
        const float d0 = h2.x > 0.f ? acc[i][j][2 * h] * fs.x : 0.f;
        const float d1 = h2.y > 0.f ? acc[i][j][2 * h + 1] * fs.y : 0.f;
        tc::store2(dpre + at, d0, d1);
        cs[j][0] += d0;
        cs[j][1] += d1;
      }
    }
  // over the warp's rows (lanes of one t), then over the 4 warps of a column, in order
#pragma unroll
  for (int j = 0; j < P::kNT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        cs[j][e] += __shfl_xor_sync(0xffffffffu, cs[j][e], off);
  float* Red = smem;  // [4][64]
  if ((threadIdx.x & 31) < 4) {
#pragma unroll
    for (int j = 0; j < P::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) Red[P::warp_row0() / 32 * kColsF + P::col(j, e)] = cs[j][e];
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < kColsF && f0 + c < F) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kRowsF / 32; ++w) s += Red[w * kColsF + c];
    part[(long)blockIdx.y * F + f0 + c] = s;
  }
}

}  // namespace msfa_ffw
