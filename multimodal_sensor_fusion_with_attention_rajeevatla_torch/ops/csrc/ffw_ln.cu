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
// backward does 12*N*D*F = 103 GFLOP (1.54 ms on the CUDA cores, 0.62 ms at
// 495/3 = 165 TFLOP/s as 3xTF32 on the tensor cores).
//
// Forward (the row-tile walk itself is in ffw_tile.cuh, shared with ffw.cu):
// one block of 256 threads owns 32 whole rows and keeps them in shared
// memory; it walks d_ff in 64-wide chunks: pre for the chunk (W1 streaming in
// 32-row slices), ReLU and the hidden mask, then y += h W2[chunk] into a
// [32, D] accumulator held in registers (4 rows x D/32 columns per thread).
// The [N, F] hidden never reaches device memory, as on the TPU; the LayerNorm
// is the epilogue (each warp owns 4 whole rows). f32 on the CUDA cores.
//
// Backward: a chain of six products on the TF32 tensor cores at f32 accuracy
// (3xTF32), each a tile of tc_product.cuh's template with its own epilogue.
// The weight gradients need the hidden and its gradient as [N, F] operands
// (scratch the wrapper allocates), so the chain writes each once and reads
// it where a product needs it:
//   1. hidden:  hd = relu(x W1 + b1) * fmask * inv_keep, taking the forward
//               kernel's ReLU branch (below)
//   2. ln:      y = hd W2 + b2 on 64 whole rows; its epilogue is the
//               LayerNorm backward: dr (the start of dx), dy, and per-block
//               partials of dgamma, dbeta and db2
//   3. dpre:    dpre = (hd > 0) * (dy W2^T) * fmask * inv_keep, and per-block
//               partials of db1 (hd > 0 is pre > 0 wherever the mask keeps
//               the unit; where it drops it, dpre is 0 either way)
//   4. dx:      dx = dr + dpre W1^T
//   5. dw:      dW2 = hd^T dy and dW1 = x^T dpre, per split of the rows
//   6. sum:     the splits and the per-block partials, added in order
// The ReLU's derivative is a step, so the backward must take the branch the
// forward took. The forward kernel's pre is one f32 FMA chain in k order,
// within D * 2^-24 * S of the exact sum (S = sum over k of |x_k w_k|); the
// 3xTF32 pre is within (16 + D / 64) * 2^-23 * S (each product's dropped
// terms, the tensor core's cut sums, the FP32 adds). Their gap is below the
// band (D + 64) * 2^-23 * |x_n| |W1[:, f]|, since S <= |x_n| |W1[:, f]|
// (Cauchy-Schwarz), so wherever the 3xTF32 pre lies within that band of zero
// the hidden kernel takes pre again by the forward's own chain (a few units
// per block at the training shape, each staged by one warp and summed by one
// lane); then every sign agrees with the forward's. Without it a unit that
// rounds across zero moves one row of dx and one entry of dW1 and db1 by
// ~1e-2 of their largest magnitude.
// The TPU kernel summed dW1, dW2 and the bias/LN gradients across its
// sequential grid; here every sum across blocks is per-block partials that
// the last kernel adds in a fixed order: deterministic, no atomics. Rows past
// N load zeros, are never written and add nothing.

#include <cuda_runtime.h>
#include <math.h>

#include "ffw_tile.cuh"
#include "reduce.cuh"
#include "tc_product.cuh"

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

// ---------------------------------------------------------------- backward ----

namespace tc = msfa_tc;

// [N, F] products over k = D (steps 1 and 3) and the weight gradients over
// the rows of a split (step 5): 128 x 64 tiles, 8 warps
using HiddenProduct = tc::TcProduct<128, 64, 4, 2, false, true>;  // x [n][d] . W1 [d][f]
using DhdProduct = tc::TcProduct<128, 64, 4, 2, false, false>;    // dy [n][d] . (W2 [f][d])^T
using GradProduct = tc::TcProduct<128, 64, 4, 2, true, true>;     // (A [n][m])^T . B [n][o]
// [N, D] products over k = F (steps 2 and 4): 64 whole rows, 2 * D threads
template <int D>
using LnProduct = tc::TcProduct<64, D, 2, D / 32, false, true>;  // hd [n][f] . W2 [f][d]
template <int D>
using DxProduct = tc::TcProduct<64, D, 2, D / 32, false, false>;  // dpre [n][f] . (W1 [d][f])^T

constexpr int kRowsF = 128;  // rows of a block in steps 1 and 3
constexpr int kRowsD = 64;   // rows of a block in steps 2 and 4
constexpr int kColsF = 64;   // hidden columns of a block in steps 1 and 3
// the hidden kernel's list of units to settle and its warps' staged rows
// (D <= 256) fit in the ring it no longer needs
static_assert(kRowsF * kColsF + HiddenProduct::kThreads / 32 * (1 + 2 * 256) <=
                  HiddenProduct::kSmemFloats,
              "hidden kernel's settle list");

template <int D>
constexpr int ln_smem_floats() {
  // the ring, then y [64][D + 4] and the warps' LayerNorm partials [warps][3][D]
  return cmax(LnProduct<D>::kSmemFloats,
              kRowsD * (D + tc::kPad) + LnProduct<D>::kThreads / 32 * 3 * D);
}

// the dropout scale of two neighbouring elements: mask * inv_keep, or 1 without a mask
__device__ __forceinline__ float2 keep_scale2(const unsigned char* __restrict__ mask, long at,
                                              float inv_keep) {
  if (!mask) return make_float2(1.f, 1.f);
  const uchar2 m = *reinterpret_cast<const uchar2*>(mask + at);
  return make_float2((float)m.x * inv_keep, (float)m.y * inv_keep);
}

// 0. |x_n| for every row and |W1[:, f]| for every column: the hidden kernel's
// band around zero. Blocks below row_blocks take 8 rows (a warp each), the
// rest 256 columns (a thread each).
__global__ void __launch_bounds__(256)
ffw_ln_bwd_norms_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                        float* __restrict__ x_norm, float* __restrict__ w1_norm, int N, int D,
                        int F, int row_blocks) {
  if ((int)blockIdx.x < row_blocks) {
    const int n = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    if (n >= N) return;  // warp-uniform
    float s = 0.f;
    for (int k = lane; k < D; k += 32) s = fmaf(x[(long)n * D + k], x[(long)n * D + k], s);
    s = msfa::warp_sum(s);
    if (lane == 0) x_norm[n] = sqrtf(s);
  } else {
    const int f = (blockIdx.x - row_blocks) * 256 + threadIdx.x;
    if (f >= F) return;
    float s = 0.f;
    for (int k = 0; k < D; ++k) s = fmaf(w1[(long)k * F + f], w1[(long)k * F + f], s);
    w1_norm[f] = sqrtf(s);
  }
}

// 1. hd = relu(x W1 + b1) * fmask * inv_keep for a 128-row x 64-column tile
__global__ void __launch_bounds__(HiddenProduct::kThreads, 2)
ffw_ln_bwd_hidden_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                         const float* __restrict__ b1, const unsigned char* __restrict__ fmask,
                         const float* __restrict__ x_norm, const float* __restrict__ w1_norm,
                         float* __restrict__ hd, int N, int D, int F, float inv_keep) {
  using P = HiddenProduct;
  extern __shared__ __align__(16) float smem[];
  const int f0 = blockIdx.x * kColsF, n0 = blockIdx.y * kRowsF;
  const P::A a{x + (long)n0 * D, D, N - n0, D};
  const P::B b{w1 + f0, F, F - f0, D};
  P::Acc acc;
  P::run(a, b, D, smem, acc);
  const float band = (float)(D + 64) * 0x1p-23f;  // |3xTF32 pre - forward's| < band |x_n| |W1[:, f]|
  unsigned listed = 0;  // this thread's units within the band: bit 16 i + 8 h + 2 j + e
#pragma unroll
  for (int i = 0; i < P::kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m16 tile
      const int n = n0 + P::row(i, 2 * h);
      if (n >= N) continue;
      const float near = band * x_norm[n];
#pragma unroll
      for (int j = 0; j < P::kNT; ++j) {
        const int f = f0 + P::col(j, 0);
        const long at = (long)n * F + f;
        const float2 fs = keep_scale2(fmask, at, inv_keep);
        const float p0 = acc[i][j][2 * h] + b1[f], p1 = acc[i][j][2 * h + 1] + b1[f + 1];
        const int bit = 16 * i + 8 * h + 2 * j;
        if (fs.x != 0.f && fabsf(p0) < near * w1_norm[f]) listed |= 1u << bit;
        if (fs.y != 0.f && fabsf(p1) < near * w1_norm[f + 1]) listed |= 1u << (bit + 1);
        *reinterpret_cast<float2*>(hd + at) =
            make_float2(fmaxf(p0, 0.f) * fs.x, fmaxf(p1, 0.f) * fs.y);
      }
    }

  // The listed units in thread order (an exclusive scan of the counts over
  // the block), then each taken again by one warp: its x row and W1 column
  // staged in shared memory, the forward's FMA chain run by one lane.
  constexpr int kWarps = P::kThreads / 32;
  int* list = reinterpret_cast<int*>(smem);     // tile-local units, row * 64 + column
  int* warp_total = list + kRowsF * kColsF;     // [warps]
  float* staged = reinterpret_cast<float*>(warp_total + kWarps) + (threadIdx.x >> 5) * 2 * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int count = __popc(listed);
  int upto = count;  // inclusive scan over the warp's lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, upto, off);
    if (lane >= off) upto += v;
  }
  if (lane == 31) warp_total[warp] = upto;
  __syncthreads();
  int next = upto - count, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    next += w < warp ? warp_total[w] : 0;
    total += warp_total[w];
  }
  for (unsigned m = listed; m; m &= m - 1) {
    const int bit = __ffs(m) - 1;
    list[next++] = P::row(bit >> 4, 2 * ((bit >> 3) & 1)) * kColsF + P::col((bit >> 1) & 3, bit & 1);
  }
  __syncthreads();
  for (int u = warp; u < total; u += kWarps) {
    const int n = n0 + list[u] / kColsF, f = f0 + list[u] % kColsF;
    for (int k = lane; k < D; k += 32) {
      staged[k] = x[(long)n * D + k];
      staged[D + k] = w1[(long)k * F + f];
    }
    __syncwarp();
    if (lane == 0) {  // ffw_tile.cuh's chunk_pre: one FMA chain over k in order, then + b1
      float pre = 0.f;
#pragma unroll 16
      for (int k = 0; k < D; ++k) pre = fmaf(staged[k], staged[D + k], pre);
      const long at = (long)n * F + f;
      const float fs = fmask ? (float)fmask[at] * inv_keep : 1.f;
      hd[at] = fmaxf(pre + b1[f], 0.f) * fs;  // after the barrier: replaces the 3xTF32 value
    }
    __syncwarp();
  }
}

// 2. y = hd W2 for 64 whole rows, then the LayerNorm backward: dr (into dx),
// dy, and the block's sums over its rows of dout * xhat | dout | dy
template <int D>
__global__ void __launch_bounds__(LnProduct<D>::kThreads)
ffw_ln_bwd_ln_kernel(const float* __restrict__ hd, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ x,
                     const float* __restrict__ gamma, const unsigned char* __restrict__ rmask,
                     const float* __restrict__ dout, float* __restrict__ dr_out,
                     float* __restrict__ dy_out, float* __restrict__ part, int N, int F,
                     float inv_keep, float eps) {
  using P = LnProduct<D>;
  constexpr int DJ = D / 32, kWarps = P::kThreads / 32, kLdY = D + tc::kPad;
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * kRowsD;
  const typename P::A a{hd + (long)n0 * F, F, N - n0, F};
  const typename P::B b{w2, D, D, F};
  typename P::Acc acc;
  P::run(a, b, F, smem, acc);

  float* Ys = smem;                    // y before bias and dropout, [64][D + 4]
  float* Red = smem + kRowsD * kLdY;   // the warps' partials, [warps][3][D]
#pragma unroll
  for (int i = 0; i < P::kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < P::kNT; ++j)
        *reinterpret_cast<float2*>(Ys + P::row(i, 2 * h) * kLdY + P::col(j, 0)) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float pg[DJ], pb[DJ], po[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) pg[j] = pb[j] = po[j] = 0.f;
  for (int row = warp; row < kRowsD; row += kWarps) {  // warp-uniform
    const int n = n0 + row;
    if (n >= N) break;
    float r[DJ], rs[DJ], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      float y = Ys[row * kLdY + c] + b2[c];
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
      dr_out[(long)n * D + c] = dr;
      dy_out[(long)n * D + c] = dy;
      pg[j] += g[j] * xh[j];
      pb[j] += g[j];
      po[j] += dy;
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

// 3. dpre = (hd > 0) * (dy W2^T) * fmask * inv_keep for a 128-row x 64-column
// tile, and the block's column sums of dpre (db1's partial)
__global__ void __launch_bounds__(DhdProduct::kThreads, 2)
ffw_ln_bwd_dpre_kernel(const float* __restrict__ dy, const float* __restrict__ w2,
                       const float* __restrict__ hd, const unsigned char* __restrict__ fmask,
                       float* __restrict__ dpre, float* __restrict__ part, int N, int D, int F,
                       float inv_keep) {
  using P = DhdProduct;
  extern __shared__ __align__(16) float smem[];
  const int f0 = blockIdx.x * kColsF, n0 = blockIdx.y * kRowsF;
  const P::A a{dy + (long)n0 * D, D, N - n0, D};
  const P::B b{w2 + (long)f0 * D, D, F - f0, D};  // (W2^T)(d, f) = W2[f][d]
  P::Acc acc;
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
        const float2 h2 = *reinterpret_cast<const float2*>(hd + at);
        const float d0 = h2.x > 0.f ? acc[i][j][2 * h] * fs.x : 0.f;
        const float d1 = h2.y > 0.f ? acc[i][j][2 * h + 1] * fs.y : 0.f;
        *reinterpret_cast<float2*>(dpre + at) = make_float2(d0, d1);
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

// 4. dx = dr + dpre W1^T for 64 whole rows (dx holds dr on entry)
template <int D>
__global__ void __launch_bounds__(DxProduct<D>::kThreads)
ffw_ln_bwd_dx_kernel(const float* __restrict__ dpre, const float* __restrict__ w1,
                     float* __restrict__ dx, int N, int F) {
  using P = DxProduct<D>;
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * kRowsD;
  const typename P::A a{dpre + (long)n0 * F, F, N - n0, F};
  const typename P::B b{w1, F, D, F};  // (W1^T)(f, d) = W1[d][f]
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
        float2* p = reinterpret_cast<float2*>(dx + (long)n * D + P::col(j, 0));
        const float2 dr = *p;
        *p = make_float2(dr.x + acc[i][j][2 * h], dr.y + acc[i][j][2 * h + 1]);
      }
    }
}

// 5. part[split] = A[rows of split]^T B[rows of split] for a 128 x 64 tile of
// the [M, O] weight gradient (A [N, M], B [N, O] row-major)
__global__ void __launch_bounds__(GradProduct::kThreads, 2)
ffw_ln_bwd_dw_kernel(const float* __restrict__ A, int M, const float* __restrict__ B, int O,
                     float* __restrict__ part, int N, int rows_per_split) {
  using P = GradProduct;
  extern __shared__ __align__(16) float smem[];
  const int m0 = blockIdx.x * 128, o0 = blockIdx.y * 64, split = blockIdx.z;
  const int r0 = split * rows_per_split;
  const int rows = max(0, min(N - r0, rows_per_split));
  const long first = rows > 0 ? r0 : 0;  // an empty split reads nothing
  const P::A a{A + first * M + m0, M, M - m0, rows};
  const P::B b{B + first * O + o0, O, O - o0, rows};
  P::Acc acc;
  P::run(a, b, rows, smem, acc);
  float* out = part + (long)split * M * O;
#pragma unroll
  for (int i = 0; i < P::kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + P::row(i, 2 * h);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < P::kNT; ++j) {
        const int o = o0 + P::col(j, 0);
        if (o < O)
          *reinterpret_cast<float2*>(out + (long)m * O + o) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// 6. out[e] = sum over s of part[s][e], s in order
__global__ void __launch_bounds__(256)
ffw_ln_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int splits,
                      long width) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= width) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(long)k * width + e];
  out[e] = s;
}

cudaError_t sum_splits(const float* part, float* out, int splits, long width, cudaStream_t s) {
  ffw_ln_bwd_sum_kernel<<<(unsigned)((width + 255) / 256), 256, 0, s>>>(part, out, splits, width);
  return cudaGetLastError();
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

#define MSFA_TRY(call)                      \
  do {                                      \
    const cudaError_t e_ = (call);          \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

template <int D>
int launch_bwd(const float* x, const float* w1, const float* b1, const float* w2,
               const float* b2, const float* gamma, const unsigned char* fmask,
               const unsigned char* rmask, const float* dout, float* dx, float* dw1,
               float* db1, float* dw2, float* sums, float* hd, float* dpre, float* dy,
               float* ln_part, float* db1_part, float* dw_part, float* norms, int N, int F,
               int splits, float inv_keep, float eps, cudaStream_t s) {
  constexpr int kLnFloats = ln_smem_floats<D>();
  MSFA_TRY(allow_smem(ffw_ln_bwd_hidden_kernel, HiddenProduct::kSmemFloats));
  MSFA_TRY(allow_smem(ffw_ln_bwd_ln_kernel<D>, kLnFloats));
  MSFA_TRY(allow_smem(ffw_ln_bwd_dpre_kernel, DhdProduct::kSmemFloats));
  MSFA_TRY(allow_smem(ffw_ln_bwd_dx_kernel<D>, DxProduct<D>::kSmemFloats));
  MSFA_TRY(allow_smem(ffw_ln_bwd_dw_kernel, GradProduct::kSmemFloats));
  const int row_tiles_f = (N + kRowsF - 1) / kRowsF, row_tiles_d = (N + kRowsD - 1) / kRowsD;
  const dim3 grid_f(F / kColsF, row_tiles_f);
  const int fb = (int)sizeof(float);

  const int norm_row_blocks = (N + 7) / 8;
  ffw_ln_bwd_norms_kernel<<<norm_row_blocks + (F + 255) / 256, 256, 0, s>>>(
      x, w1, norms, norms + N, N, D, F, norm_row_blocks);
  MSFA_TRY(cudaGetLastError());
  ffw_ln_bwd_hidden_kernel<<<grid_f, HiddenProduct::kThreads, HiddenProduct::kSmemFloats * fb,
                             s>>>(x, w1, b1, fmask, norms, norms + N, hd, N, D, F, inv_keep);
  MSFA_TRY(cudaGetLastError());
  ffw_ln_bwd_ln_kernel<D><<<row_tiles_d, LnProduct<D>::kThreads, kLnFloats * fb, s>>>(
      hd, w2, b2, x, gamma, rmask, dout, dx, dy, ln_part, N, F, inv_keep, eps);
  MSFA_TRY(cudaGetLastError());
  ffw_ln_bwd_dpre_kernel<<<grid_f, DhdProduct::kThreads, DhdProduct::kSmemFloats * fb, s>>>(
      dy, w2, hd, fmask, dpre, db1_part, N, D, F, inv_keep);
  MSFA_TRY(cudaGetLastError());
  ffw_ln_bwd_dx_kernel<D><<<row_tiles_d, DxProduct<D>::kThreads,
                            DxProduct<D>::kSmemFloats * fb, s>>>(dpre, w1, dx, N, F);
  MSFA_TRY(cudaGetLastError());

  // each split a whole number of 32-row chunks
  const int rows_per_split =
      ((N + splits - 1) / splits + tc::kProdK - 1) / tc::kProdK * tc::kProdK;
  const int dw_bytes = GradProduct::kSmemFloats * fb;
  ffw_ln_bwd_dw_kernel<<<dim3((F + 127) / 128, (D + 63) / 64, splits), GradProduct::kThreads,
                         dw_bytes, s>>>(hd, F, dy, D, dw_part, N, rows_per_split);  // dW2 = hd^T dy
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum_splits(dw_part, dw2, splits, (long)F * D, s));
  ffw_ln_bwd_dw_kernel<<<dim3((D + 127) / 128, (F + 63) / 64, splits), GradProduct::kThreads,
                         dw_bytes, s>>>(x, D, dpre, F, dw_part, N, rows_per_split);  // dW1 = x^T dpre
  MSFA_TRY(cudaGetLastError());
  MSFA_TRY(sum_splits(dw_part, dw1, splits, (long)D * F, s));
  MSFA_TRY(sum_splits(ln_part, sums, row_tiles_d, 3L * D, s));
  MSFA_TRY(sum_splits(db1_part, db1, row_tiles_f, F, s));
  return 0;
}

#undef MSFA_TRY

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
// ln_part [ceil(N/64), 3, D], db1_part [ceil(N/128), F], dw_part [splits, D * F],
// norms [N + F].
int msfa_ffw_ln_bwd(const float* x, const float* w1, const float* b1, const float* w2,
                    const float* b2, const float* gamma, const unsigned char* fmask,
                    const unsigned char* rmask, const float* dout, float* dx, float* dw1,
                    float* db1, float* dw2, float* sums, float* hd, float* dpre, float* dy,
                    float* ln_part, float* db1_part, float* dw_part, float* norms, int N,
                    int D, int F, int splits, float inv_keep, float eps, void* stream) {
  if (N <= 0 || F <= 0 || F % kFC != 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_FFW_BWD(W)                                                                  \
  launch_bwd<W>(x, w1, b1, w2, b2, gamma, fmask, rmask, dout, dx, dw1, db1, dw2, sums,  \
                hd, dpre, dy, ln_part, db1_part, dw_part, norms, N, F, splits, inv_keep,  \
                eps, s)
  switch (D) {
    case 32: return MSFA_FFW_BWD(32);
    case 64: return MSFA_FFW_BWD(64);
    case 128: return MSFA_FFW_BWD(128);
    case 256: return MSFA_FFW_BWD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSFA_FFW_BWD
}

// Dynamic shared memory per block of the backward's five product kernels
// (hidden, ln, dpre, dx, dw) at width D, into bytes[0..4].
int msfa_ffw_ln_bwd_smem_bytes(int D, int* bytes) {
  const int fb = (int)sizeof(float);
  bytes[0] = HiddenProduct::kSmemFloats * fb;
  bytes[2] = DhdProduct::kSmemFloats * fb;
  bytes[4] = GradProduct::kSmemFloats * fb;
  switch (D) {
#define MSFA_FFW_SMEM(W)                                  \
  case W:                                                 \
    bytes[1] = ln_smem_floats<W>() * fb;                  \
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
