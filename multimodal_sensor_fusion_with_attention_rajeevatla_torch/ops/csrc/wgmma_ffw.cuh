// The bf16 entries' FFW products on wgmma (wgmma_bf16.cuh's WgProduct), for
// Hopper (sm_90a): every product of both bf16 FFW pairs, the FFW residual-LN
// pair (ffw_ln.cu, msfa_ffw_ln_fwd_bf16 and msfa_ffw_ln_bwd_bf16) and the
// feed-forward pair (ffw.cu, msfa_ffw_fwd_bf16 and msfa_ffw_bwd_bf16: the
// backward the same bodies with dout in dy's place and no dr). Each body is
// its 3xTF32 counterpart's function with its epilogue (ffw_products.cuh's
// hidden_tile and dpre_tile, residual_ln.cuh's ln_fwd_rows, ln_bwd_tile,
// dx_tile and grad_tile) on a wgmma product; the f32 entries keep those.
// Each kernel that calls a body below is a thin __global__ of its own
// source; launch_bwd_products (at the end) is both bf16 backwards' launch
// sequence after the hidden.
//
//   wg_hidden_tile   hd = relu(x W1 + b1) * fmask * inv_keep, rounded to
//                    bf16, for 128 rows x 128 columns (two warpgroups)
//   wg_y_rows        y = hd W2 for 128 whole rows (a warpgroup each 64),
//                    staged in shared memory: the one product of the three
//                    bodies below, so the LN forward and its backward
//                    normalise the same y bits
//   wg_ln_fwd_tile   then the residual and the LayerNorm (ln_fwd_rows), out
//                    rounded to bf16
//   wg_out_tile      then out = y + b2, rounded to bf16, 16-byte stores
//   wg_ln_bwd_tile   then the LayerNorm backward: dr (f32), dy (bf16), the
//                    block's sums of dout * xhat | dout | dy
//   wg_dpre_tile     dpre = (hd > 0) * (g W2^T) * fmask * inv_keep, g = dy
//                    (ffw_ln) or dout (ffw), rounded to bf16, for 128 x 128,
//                    and the block's column sums of dpre
//   wg_dx_tile       dx = dr + dpre W1^T (ffw_ln) or dpre W1^T (ffw) for 128
//                    whole rows, rounded to bf16
//   wg_grad_tile     one row split's A^T B for 128 rows of d_ff by the whole
//                    D of a weight gradient (dW2 = hd^T dy, and dW1 = x^T
//                    dpre as (dpre^T x)^T, written transposed)
// W1^T, W2^T, hd^T and dpre^T are MN-major operands, read where they lie.
// The [N, F] products' blocks are 128 rows, as the 3xTF32 kernels' (db1's
// partials keep their shape); the [N, D] products' 128 rows (the LN
// backward's partials a block each); a weight-gradient split is a whole
// number of 64-row chunks (mlp.py _wg_grad_splits), the splits and the
// partials summed in order by residual_ln.cuh's ordered_sum. Sums over k:
// exact bf16 products, over k = D <= 256 in one sum in the unit, over d_ff
// and the rows in 64-deep chunks, each in a fresh accumulator added in FP32.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "ffw_products.cuh"
#include "residual_ln.cuh"
#include "wgmma_bf16.cuh"

namespace msfa_wg {

// the [N, F] products over k = D <= 256: 128 x 128 tiles, the whole k in the
// unit, a two-stage ring (two blocks an SM beside the epilogue's tiles)
using WgFProduct = WgProduct<2, 128, false, true, false, 2>;     // x [n][d] . W1 [d][f]
using WgDpreProduct = WgProduct<2, 128, false, false, false, 2>;  // dy [n][d] . (W2 [f][d])^T
// the [N, D] products over k = d_ff: 128 whole rows, a warpgroup each 64 of
// them (D = 32 runs on 64 columns, zero past D), 64-deep fresh chunks over
// two 64-column pieces at a time (one block an SM): half the re-reads of the
// weight that 64-row blocks make
template <int D>
constexpr int kLnTileN = D < 64 ? 64 : D;
template <int D>
constexpr int kLnPartNB = kLnTileN<D> / 64 < 2 ? 1 : 2;
template <int D>  // hd . W2
using WgLnProduct = WgProduct<2, kLnTileN<D>, false, true, true, 3, kLnPartNB<D>>;
template <int D>  // dpre . W1^T
using WgDxProduct = WgProduct<2, kLnTileN<D>, false, false, true, 3, kLnPartNB<D>>;
// the weight gradients over a split's rows, [d_ff, D] = A^T B (A [n][d_ff],
// B [n][D]): 128 of d_ff by the whole D a block, so the [N, d_ff] operand is
// read once; 64-deep fresh chunks over two 64-column pieces at a time
template <int D>
using WgGradProduct = WgProduct<2, kLnTileN<D>, true, true, true, 3, kLnPartNB<D>>;

using msfa_ffw::kRowsF;
constexpr int kWgGradM = 128;  // d_ff rows of a weight-gradient block (mlp.py WG_GRAD_ROWS)
static_assert(WgGradProduct<256>::kBM == kWgGradM, "the dW tile");
constexpr int kWgColsF = WgFProduct::kBN;  // hidden columns of a block in the [N, F] products
constexpr int kWgRowsD = 128;              // rows of a block in the [N, D] products
static_assert(WgLnProduct<256>::kBM == kWgRowsD && WgDxProduct<32>::kBM == kWgRowsD, "rows");
static_assert(WgFProduct::kBM == kRowsF && WgDpreProduct::kBM == kRowsF, "db1's row blocks");

template <int D>
constexpr int y_rows_smem_bytes() {  // the ring, then y [128][D + 4]
  return msfa_ln::cmax(WgLnProduct<D>::kRingBytes, 4 * kWgRowsD * (D + msfa_tc::kPad)) +
         kAlignSlack;
}
template <int D>
constexpr int ln_bwd_smem_bytes() {  // the ring, then y [128][D + 4] and the warps' partials
  return msfa_ln::cmax(WgLnProduct<D>::kRingBytes,
                       4 * (kWgRowsD * (D + msfa_tc::kPad) +
                            WgLnProduct<D>::kThreads / 32 * 3 * D)) +
         kAlignSlack;
}
template <class P>
constexpr int ring_smem_bytes() {
  return P::kRingBytes + kAlignSlack;
}

// An [N, F] block's 128 x 128 tiles in shared memory, rows padded by 16
// bytes (a warp's reads of 2 or 4 bytes at rows g, columns 8 j + 2 t then
// fall on distinct banks): the dropout mask (u8) and a bf16 tile (the
// backward's hd read, or an output staged for 16-byte stores).
constexpr int kMaskLd = kWgColsF + 16;
constexpr int kTileLd = 2 * kWgColsF + 16;
constexpr int kMaskTileBytes = 128 * kMaskLd, kBf16TileBytes = 128 * kTileLd;
static_assert(kBf16TileBytes + 8 * kWgColsF * 4 <= WgDpreProduct::kRingBytes, "staging fits");
constexpr int hidden_smem_bytes() { return WgFProduct::kRingBytes + kMaskTileBytes + kAlignSlack; }
constexpr int dpre_smem_bytes() { return WgDpreProduct::kRingBytes + kBf16TileBytes + kAlignSlack; }

// let `kernel` take `bytes` of dynamic shared memory (past 48 KB)
template <class Kernel>
cudaError_t allow_bytes(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// copy rows n0 .. n0 + 127, bytes [0, 16 kPieces) of a row-major matrix (row
// stride ld_src bytes; rows past `rows`, bytes past `bytes` zero) into
// shared rows of ld_dst bytes; asynchronous, the caller commits
template <int kPieces>
__device__ __forceinline__ void prefetch_rows(unsigned char* dst, int ld_dst,
                                              const unsigned char* src, long ld_src, int rows,
                                              int bytes) {
  for (int i = threadIdx.x; i < 128 * kPieces; i += WgFProduct::kThreads) {
    const int r = i / kPieces, c = 16 * (i % kPieces);
    const bool ok = r < rows && c < bytes;
    msfa_tc::cp_async16(dst + r * ld_dst + c, ok ? src + r * ld_src + c : src, ok);
  }
}

// write a staged 128 x 128 bf16 tile (rows of kTileLd bytes) to out[n0.., f0..]
// in 16-byte stores, rows past N and columns past F skipped
__device__ __forceinline__ void store_tile(const unsigned char* tile, bf16* __restrict__ out,
                                           int n0, int f0, int N, int F) {
  constexpr int kPieces = 2 * kWgColsF / 16;
  for (int i = threadIdx.x; i < 128 * kPieces; i += WgFProduct::kThreads) {
    const int r = i / kPieces, c = 8 * (i % kPieces);
    if (n0 + r < N && f0 + c < F)
      *reinterpret_cast<uint4*>(out + (long)(n0 + r) * F + f0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * kTileLd + 2 * c);
  }
}

// rows of a weight-gradient split: a whole number of 64-row chunks
inline int wg_rows_per_split(int N, int splits) {
  return ((N + splits - 1) / splits + kChunk - 1) / kChunk * kChunk;
}

// hd = relu(x W1 + b1) * fmask * inv_keep for the block's 128 x 128 tile
// (columns past F, a multiple of 64, skipped), rounded to bf16; blockIdx is
// (column tile, row tile). The mask tile comes in beside the product; the
// tile goes out through shared memory.
__device__ __forceinline__ void wg_hidden_tile(const bf16* __restrict__ x,
                                               const bf16* __restrict__ w1,
                                               const float* __restrict__ b1,
                                               const unsigned char* __restrict__ fmask,
                                               bf16* __restrict__ hd, int N, int D, int F,
                                               float inv_keep, unsigned char* smem) {
  using P = WgFProduct;
  const int f0 = blockIdx.x * kWgColsF, n0 = blockIdx.y * kRowsF;
  unsigned char* Ms = smem + P::kRingBytes;  // the mask tile [128][kMaskLd]
  if (fmask)
    prefetch_rows<kWgColsF / 16>(Ms, kMaskLd, fmask + (long)n0 * F + f0, F, N - n0, F - f0);
  msfa_tc::cp_async_commit();  // a group of its own, ahead of the ring's
  const Operand a{x + (long)n0 * D, D, N - n0, D};
  const Operand b{w1 + f0, F, F - f0, D};  // (k = d, f) at W1[d][f]
  P::Acc acc;
  P::run(a, b, D, smem, acc);
  unsigned char* Hs = smem;  // the output tile [128][kTileLd], in the ring's room
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the warp's 16
    const int r = P::row(2 * h);
#pragma unroll
    for (int nb = 0; nb < P::kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = P::col(nb, j, 0);
        float2 fs = make_float2(1.f, 1.f);
        if (fmask) {
          const uchar2 m = *reinterpret_cast<const uchar2*>(Ms + r * kMaskLd + c);
          fs = make_float2((float)m.x * inv_keep, (float)m.y * inv_keep);
        }
        const int f = f0 + c < F ? f0 + c : F - 2;  // a column past F: any b1, never stored
        const float p0 = acc[nb][4 * j + 2 * h] + b1[f];
        const float p1 = acc[nb][4 * j + 2 * h + 1] + b1[f + 1];
        msfa_tc::store2(reinterpret_cast<bf16*>(Hs + r * kTileLd) + c, fmaxf(p0, 0.f) * fs.x,
                        fmaxf(p1, 0.f) * fs.y);
      }
  }
  __syncthreads();
  store_tile(Hs, hd, n0, f0, N, F);
}

// dpre = (hd > 0) * (dy W2^T) * fmask * inv_keep for the block's 128 x 128
// tile, rounded to bf16, and the block's column sums of the f32 dpre into
// part[blockIdx.y][F]. The hd tile comes in beside the product; the tile
// goes out through shared memory.
__device__ __forceinline__ void wg_dpre_tile(const bf16* __restrict__ dy,
                                             const bf16* __restrict__ w2,
                                             const bf16* __restrict__ hd,
                                             const unsigned char* __restrict__ fmask,
                                             bf16* __restrict__ dpre, float* __restrict__ part,
                                             int N, int D, int F, float inv_keep,
                                             unsigned char* smem) {
  using P = WgDpreProduct;
  const int f0 = blockIdx.x * kWgColsF, n0 = blockIdx.y * kRowsF;
  unsigned char* Hp = smem + P::kRingBytes;  // hd's tile [128][kTileLd]
  prefetch_rows<2 * kWgColsF / 16>(Hp, kTileLd,
                                   reinterpret_cast<const unsigned char*>(hd + (long)n0 * F + f0),
                                   2L * F, N - n0, 2 * (F - f0));
  msfa_tc::cp_async_commit();  // a group of its own, ahead of the ring's
  const Operand a{dy + (long)n0 * D, D, N - n0, D};
  const Operand b{w2 + (long)f0 * D, D, F - f0, D};  // (W2^T)(d, f) = W2[f][d]
  P::Acc acc;
  P::run(a, b, D, smem, acc);
  unsigned char* Ds = smem;  // the output tile [128][kTileLd], in the ring's room
  float cs[P::kNB][8][2];
#pragma unroll
  for (int nb = 0; nb < P::kNB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[nb][j][0] = cs[nb][j][1] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = P::row(2 * h), n = n0 + r;
#pragma unroll
    for (int nb = 0; nb < P::kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = P::col(nb, j, 0);
        const bool in = n < N && f0 + c < F;
        const float2 fs = in ? msfa_ffw::keep_scale2(fmask, (long)n * F + f0 + c, inv_keep)
                             : make_float2(0.f, 0.f);
        const float2 h2 = msfa_tc::load2(reinterpret_cast<const bf16*>(Hp + r * kTileLd) + c);
        const float d0 = h2.x > 0.f ? acc[nb][4 * j + 2 * h] * fs.x : 0.f;
        const float d1 = h2.y > 0.f ? acc[nb][4 * j + 2 * h + 1] * fs.y : 0.f;
        msfa_tc::store2(reinterpret_cast<bf16*>(Ds + r * kTileLd) + c, d0, d1);
        cs[nb][j][0] += d0;
        cs[nb][j][1] += d1;
      }
  }
  // over the warp's 16 rows (lanes of one t), then over the block's 8 warps, in order
#pragma unroll
  for (int nb = 0; nb < P::kNB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          cs[nb][j][e] += __shfl_xor_sync(0xffffffffu, cs[nb][j][e], off);
  float* Red = reinterpret_cast<float*>(smem + kBf16TileBytes);  // [8][128]
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) < 4) {
#pragma unroll
    for (int nb = 0; nb < P::kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) Red[warp * kWgColsF + P::col(nb, j, e)] = cs[nb][j][e];
  }
  __syncthreads();
  store_tile(Ds, dpre, n0, f0, N, F);
  const int c = threadIdx.x;
  if (c < kWgColsF && f0 + c < F) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < P::kThreads / 32; ++w) sum += Red[w * kWgColsF + c];
    part[(long)blockIdx.y * F + f0 + c] = sum;
  }
}

// y = hd W2 for the block's 128 rows (blockIdx.x) into Ys [128][D + 4] f32,
// the ring's room (columns past D, D = 32's zero half, not kept); every
// thread may read Ys when it returns. Rows past N hold zeros.
template <int D>
__device__ __forceinline__ float* wg_y_rows(const bf16* __restrict__ hd, int F,
                                            const bf16* __restrict__ w2, int N,
                                            unsigned char* smem) {
  using P = WgLnProduct<D>;
  constexpr int kLdY = D + msfa_tc::kPad;
  const int n0 = blockIdx.x * kWgRowsD;
  const Operand a{hd + (long)n0 * F, F, N - n0, F};
  const Operand b{w2, D, D, F};  // (k = f, d) at W2[f][d]
  typename P::Acc acc;
  P::run(a, b, F, smem, acc);
  float* Ys = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nb = 0; nb < P::kNB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = P::col(nb, j, 0);
        if (c < D)
          *reinterpret_cast<float2*>(Ys + P::row(2 * h) * kLdY + c) =
              make_float2(acc[nb][4 * j + 2 * h], acc[nb][4 * j + 2 * h + 1]);
      }
  __syncthreads();
  return Ys;
}

// y = hd W2 for the block's 128 rows, then the residual and the LayerNorm
// (residual_ln.cuh's ln_fwd_rows, ln_fwd_tile's epilogue): out =
// LayerNorm(x + (y + b2) * rmask * inv_keep) over the first Dv columns,
// rounded to bf16
template <int D>
__device__ __forceinline__ void wg_ln_fwd_tile(const bf16* __restrict__ hd, int F,
                                               const bf16* __restrict__ w2,
                                               const float* __restrict__ b2,
                                               const bf16* __restrict__ x,
                                               const float* __restrict__ gamma,
                                               const float* __restrict__ beta,
                                               const unsigned char* __restrict__ rmask,
                                               bf16* __restrict__ out, int N, float inv_keep,
                                               float eps, int Dv, unsigned char* smem) {
  const float* Ys = wg_y_rows<D>(hd, F, w2, N, smem);
  msfa_ln::ln_fwd_rows<D, kWgRowsD, WgLnProduct<D>::kThreads>(
      Ys, blockIdx.x * kWgRowsD, b2, x, gamma, beta, rmask, out, N, inv_keep, eps, Dv);
}

// y = hd W2 for the block's 128 rows, then out = y + b2 rounded to bf16,
// eight columns a thread in 16-byte stores, rows past N skipped
template <int D>
__device__ __forceinline__ void wg_out_tile(const bf16* __restrict__ hd, int F,
                                            const bf16* __restrict__ w2,
                                            const float* __restrict__ b2,
                                            bf16* __restrict__ out, int N,
                                            unsigned char* smem) {
  constexpr int kLdY = D + msfa_tc::kPad, kPieces = D / 8;
  const float* Ys = wg_y_rows<D>(hd, F, w2, N, smem);
  const int n0 = blockIdx.x * kWgRowsD;
  for (int i = threadIdx.x; i < kWgRowsD * kPieces; i += WgLnProduct<D>::kThreads) {
    const int r = i / kPieces, c = 8 * (i % kPieces);
    if (n0 + r >= N) break;  // i only grows: every later row is past N too
    const float4 y0 = *reinterpret_cast<const float4*>(Ys + r * kLdY + c);
    const float4 y1 = *reinterpret_cast<const float4*>(Ys + r * kLdY + c + 4);
    *reinterpret_cast<uint4*>(out + (long)(n0 + r) * D + c) =
        make_uint4(pack_bf16(y0.x + b2[c], y0.y + b2[c + 1]),
                   pack_bf16(y0.z + b2[c + 2], y0.w + b2[c + 3]),
                   pack_bf16(y1.x + b2[c + 4], y1.y + b2[c + 5]),
                   pack_bf16(y1.z + b2[c + 6], y1.w + b2[c + 7]));
  }
}

// y = hd W2 for the block's 128 rows, then the LayerNorm backward
// (residual_ln.cuh's ln_bwd_tile's epilogue): dr (f32; 0 past Dv), dy
// (bf16), and the block's sums over its rows of dout * xhat | dout | dy into
// part [blocks][3][D]
template <int D>
__device__ __forceinline__ void wg_ln_bwd_tile(const bf16* __restrict__ hd, int F,
                                               const bf16* __restrict__ w2,
                                               const float* __restrict__ b2,
                                               const bf16* __restrict__ x,
                                               const float* __restrict__ gamma,
                                               const unsigned char* __restrict__ rmask,
                                               const bf16* __restrict__ dout,
                                               float* __restrict__ dr_out,
                                               bf16* __restrict__ dy_out,
                                               float* __restrict__ part, int N, float inv_keep,
                                               float eps, int Dv, unsigned char* smem) {
  using P = WgLnProduct<D>;
  constexpr int DJ = D / 32, kWarps = P::kThreads / 32, kLdY = D + msfa_tc::kPad;
  const int n0 = blockIdx.x * kWgRowsD;
  float* Ys = wg_y_rows<D>(hd, F, w2, N, smem);
  float* Red = Ys + kWgRowsD * kLdY;  // the warps' partials, [warps][3][D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float pg[DJ], pb[DJ], po[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) pg[j] = pb[j] = po[j] = 0.f;
  for (int row = warp; row < kWgRowsD; row += kWarps) {  // warp-uniform
    const long n = n0 + row;
    if (n >= N) break;
    float r[DJ], rs[DJ], mu, inv;
    msfa_ln::residual_row<D>(Ys + row * kLdY, b2, x, rmask, n, inv_keep, eps, Dv, r, rs, mu,
                             inv);
    float xh[DJ], gd[DJ], g[DJ], sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      xh[j] = (r[j] - mu) * inv;
      g[j] = msfa_tc::load1(dout + n * D + c);
      gd[j] = g[j] * gamma[c];
      sg += gd[j];
      sgx += gd[j] * xh[j];
    }
    const float inv_d = 1.f / (float)Dv;  // gd is 0 past Dv (gamma is)
    const float mean_g = msfa_ln::warp_sum(sg) * inv_d;
    const float mean_gx = msfa_ln::warp_sum(sgx) * inv_d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      const float dr = c < Dv ? (gd[j] - mean_g - xh[j] * mean_gx) * inv : 0.f;
      const float dyv = rmask ? dr * rs[j] : dr;
      dr_out[n * D + c] = dr;
      msfa_tc::store1(dy_out + n * D + c, dyv);
      pg[j] += g[j] * xh[j];
      pb[j] += g[j];
      po[j] += dyv;
    }
  }
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    const int c = lane + 32 * j;
    Red[(warp * 3 + 0) * D + c] = pg[j];
    Red[(warp * 3 + 1) * D + c] = pb[j];
    Red[(warp * 3 + 2) * D + c] = po[j];
  }
  __syncthreads();
  for (int e = tid; e < 3 * D; e += P::kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += Red[w * 3 * D + e];
    part[(long)blockIdx.x * 3 * D + e] = s;
  }
}

// dx = dr + dpre W1^T for the block's 128 rows, rounded to bf16 (dr f32;
// without kAddDr, dx = dpre W1^T and dr is not read: the feed-forward pair's)
template <int D, bool kAddDr>
__device__ __forceinline__ void wg_dx_tile(const bf16* __restrict__ dpre, int F,
                                           const bf16* __restrict__ w1,
                                           const float* __restrict__ dr, bf16* __restrict__ dx,
                                           int N, unsigned char* smem) {
  using P = WgDxProduct<D>;
  const int n0 = blockIdx.x * kWgRowsD;
  const Operand a{dpre + (long)n0 * F, F, N - n0, F};
  const Operand b{w1, F, D, F};  // (W1^T)(f, d) = W1[d][f]
  typename P::Acc acc;
  P::run(a, b, F, smem, acc);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + P::row(2 * h);
    if (n >= N) continue;
#pragma unroll
    for (int nb = 0; nb < P::kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = P::col(nb, j, 0);
        if (c >= D) continue;
        const long at = (long)n * D + c;
        float2 v = make_float2(acc[nb][4 * j + 2 * h], acc[nb][4 * j + 2 * h + 1]);
        if constexpr (kAddDr) {
          const float2 was = *reinterpret_cast<const float2*>(dr + at);
          v = make_float2(was.x + v.x, was.y + v.y);
        }
        msfa_tc::store2(dx + at, v.x, v.y);
      }
  }
}

// part[split] = A[rows of split]^T B[rows of split] for the block's 128 rows
// of the [M, D] product (A [N, M], B [N, D] row-major; M = d_ff), stored
// [M][D], or [D][M] with kTransposed (dW1 = x^T dpre as (dpre^T x)^T);
// blockIdx is (m tile, -, split)
template <int D, bool kTransposed>
__device__ __forceinline__ void wg_grad_tile(const bf16* __restrict__ A, int M,
                                             const bf16* __restrict__ B,
                                             float* __restrict__ part, int N, int rows_per_split,
                                             unsigned char* smem) {
  using P = WgGradProduct<D>;
  const int m0 = blockIdx.x * kWgGradM, split = blockIdx.z;
  const int r0 = split * rows_per_split;
  const int rows = max(0, min(N - r0, rows_per_split));
  const long first = rows > 0 ? r0 : 0;  // an empty split reads nothing
  const Operand a{A + first * M + m0, M, M - m0, rows};
  const Operand b{B + first * D, D, D, rows};
  typename P::Acc acc;
  P::run(a, b, rows, smem, acc);
  float* out = part + (long)split * M * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + P::row(2 * h);
    if (m >= M) continue;
#pragma unroll
    for (int nb = 0; nb < P::kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = P::col(nb, j, 0);
        if (o >= D) continue;
        const float v0 = acc[nb][4 * j + 2 * h], v1 = acc[nb][4 * j + 2 * h + 1];
        if constexpr (kTransposed) {
          out[(long)o * M + m] = v0;
          out[(long)(o + 1) * M + m] = v1;
        } else {
          *reinterpret_cast<float2*>(out + (long)m * D + o) = make_float2(v0, v1);
        }
      }
  }
}

// The kernels a bf16 FFW backward launches after its hidden: each source's
// own thin __global__ wrappers of the bodies above, so each entry keeps its
// kernels' names
struct WgBwdKernels {
  void (*dpre)(const bf16*, const bf16*, const bf16*, const unsigned char*, bf16*, float*, int,
               int, int, float);
  void (*dx)(const bf16*, const bf16*, const float*, bf16*, int, int);
  void (*dw)(const bf16*, int, const bf16*, float*, int, int);    // A^T B
  void (*dw_t)(const bf16*, int, const bf16*, float*, int, int);  // (A^T B)^T
};

// Both bf16 FFW backwards' launches after the hidden hd (and, in ffw_ln.cu,
// the LN product): dpre on g (ffw_ln's dy, or ffw's dout), dx = dr + dpre
// W1^T (ffw_ln) or dpre W1^T (ffw, dr unused), dW2 = hd^T g, dW1 = (dpre^T
// x)^T, then the ordered sums of dW2, dW1 and db1 by `sum(part, out,
// splits, width)`, the caller's ordered_sum launch
template <int D, class Sum>
int launch_bwd_products(const WgBwdKernels& k, const bf16* x, const bf16* w1, const bf16* w2,
                        const unsigned char* fmask, const bf16* g, const float* dr,
                        const bf16* hd, bf16* dx, bf16* dw1, float* db1, bf16* dw2, bf16* dpre,
                        float* db1_part, float* dw_part, int N, int F, int splits,
                        float inv_keep, cudaStream_t s, Sum sum) {
  constexpr int kDpreBytes = dpre_smem_bytes();
  constexpr int kDxBytes = ring_smem_bytes<WgDxProduct<D>>();
  constexpr int kDwBytes = ring_smem_bytes<WgGradProduct<D>>();
  const auto dpre_k = k.dpre;
  const auto dx_k = k.dx;
  const auto dw_k = k.dw;
  const auto dw_t_k = k.dw_t;
  MSFA_TRY(allow_bytes(dpre_k, kDpreBytes));
  MSFA_TRY(allow_bytes(dx_k, kDxBytes));
  MSFA_TRY(allow_bytes(dw_k, kDwBytes));
  MSFA_TRY(allow_bytes(dw_t_k, kDwBytes));
  const int row_tiles_f = (N + kRowsF - 1) / kRowsF;
  const int row_tiles_d = (N + kWgRowsD - 1) / kWgRowsD;

  const dim3 grid_f((F + kWgColsF - 1) / kWgColsF, row_tiles_f);
  dpre_k<<<grid_f, WgDpreProduct::kThreads, kDpreBytes, s>>>(g, w2, hd, fmask, dpre, db1_part,
                                                              N, D, F, inv_keep);
  MSFA_TRY(cudaGetLastError());
  dx_k<<<row_tiles_d, WgDxProduct<D>::kThreads, kDxBytes, s>>>(dpre, w1, dr, dx, N, F);
  MSFA_TRY(cudaGetLastError());

  const int per_split = wg_rows_per_split(N, splits);
  const dim3 grid_w((F + kWgGradM - 1) / kWgGradM, 1, splits);
  dw_k<<<grid_w, WgGradProduct<D>::kThreads, kDwBytes, s>>>(hd, F, g, dw_part, N,
                                                             per_split);  // dW2 = hd^T g
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum(dw_part, dw2, splits, (long)F * D));
  dw_t_k<<<grid_w, WgGradProduct<D>::kThreads, kDwBytes, s>>>(dpre, F, x, dw_part, N,
                                                               per_split);  // dW1 = (dpre^T x)^T
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum(dw_part, dw1, splits, (long)D * F));
  MSFA_TRY(sum(db1_part, db1, row_tiles_f, (long)F));
  return 0;
}

}  // namespace msfa_wg
