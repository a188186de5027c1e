// The tensor-core pieces that the residual-LayerNorm kernels share (ffw_ln.cu,
// proj_ln.cu), for Hopper (sm_90a). Every product is a tile of
// tc_product.cuh's 3xTF32 template; each kernel that calls a body below is a
// thin __global__ of its own source, so a profile names the kernel it came
// from.
//
//   ln_fwd_tile   y = A B for 64 whole rows (B [K, D], K = d_ff or D); its
//                 epilogue (ln_fwd_rows, also the bf16 FFW forward's on
//                 wgmma) is the residual and the LayerNorm:
//                 out = LayerNorm(x + (y + bias) * rmask * inv_keep)
//                 over the first Dv <= D columns
//   ln_bwd_tile   the same product, recomputing y and the row statistics; its
//                 epilogue is the LayerNorm backward: dr, dy = dr * rmask *
//                 inv_keep, and the block's sums over its rows of
//                 dout * xhat | dout | dy (dgamma, dbeta, dbias partials)
//   dx_tile       out (=|+=) A B^T for 64 whole rows (B stored [D][K])
//   grad_tile     one row split's A^T B for a 128 x 64 tile of a weight
//                 gradient (A [N, M], B [N, O])
//   ordered_sum   out[e] = sum over s of part[s][e], s in order
//
// Blocks on Hopper run in parallel and in no order, so every sum across
// blocks (the weight gradients, dgamma, dbeta, the biases) is per-block or
// per-split partials added in a fixed order by ordered_sum: deterministic, no
// atomics. Rows past N load zeros, are never written and add nothing.
//
// A model width Dv that is not one of the instantiated D runs at the next D
// with zero columns past Dv in x, B, the bias, gamma and beta (the caller
// pads): those columns of the residual are exact zeros, so the row sums are
// the Dv columns' sums, and the LayerNorm scales them by 1 / Dv (at Dv = D,
// a power of two, the same bits as the constant). The backward writes dr = 0
// past Dv, so no padded column carries a cotangent.
//
// The activation type T is a template parameter: float, or __nv_bfloat16 for
// the bf16 entries (mixed_precision). With bf16, x, the products' operands
// and the outputs are bf16 in device memory: every product takes two bf16
// operands (one TF32 product a k-step), y, the residual, the LayerNorm and its
// backward run in f32, out is rounded to bf16, dy is written rounded (both of
// its products take it so, as the reference's kernel casts it), the sums over
// rows (dgamma, dbeta, the biases) take the f32 values, and a weight
// gradient's ordered sum writes it rounded. dr goes out in its own type
// (dr_out): f32 where dx's product adds to it, bf16 where it is dx.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tc_product.cuh"

namespace msfa_ln {

namespace tc = msfa_tc;

constexpr int kRowsD = 64;  // rows of a block in the [N, D] products
constexpr int kGradM = 128, kGradO = 64;  // a weight-gradient block's tile

// [N, D] products over k: 64 whole rows, 2 * D threads
template <int D, typename T = float>
using LnProduct = tc::TcProduct<64, D, 2, D / 32, false, true, T, T>;  // A [n][k] . B [k][d]
template <int D, typename T = float>
using DxProduct = tc::TcProduct<64, D, 2, D / 32, false, false, T, T>;  // A [n][k] . (B [d][k])^T
// the weight gradients over the rows of a split: (A [n][m])^T . B [n][o]
template <typename T = float>
using GradProductOf = tc::TcProduct<kGradM, kGradO, 4, 2, true, true, T, T>;
using GradProduct = GradProductOf<>;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int D, typename T = float>
constexpr int ln_smem_floats() {
  // the ring, then y [64][D + 4] and the warps' LayerNorm partials [warps][3][D]
  return cmax(LnProduct<D, T>::kSmemFloats,
              kRowsD * (D + tc::kPad) + LnProduct<D, T>::kThreads / 32 * 3 * D);
}

// rows of a weight-gradient split: a whole number of 32-row chunks
inline int rows_per_split(int N, int splits) {
  return ((N + splits - 1) / splits + tc::kProdK - 1) / tc::kProdK * tc::kProdK;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// y = A B for the block's 64 rows into Ys [64][D + 4] (the ring's memory);
// every thread may read Ys when it returns
template <int D, typename T>
__device__ __forceinline__ void product_rows(const T* __restrict__ A, int K,
                                             const T* __restrict__ B, int N, float* smem) {
  using P = LnProduct<D, T>;
  constexpr int kLdY = D + tc::kPad;
  const int n0 = blockIdx.x * kRowsD;
  const typename P::A a{A + (long)n0 * K, K, N - n0, K};
  const typename P::B b{B, D, D, K};
  typename P::Acc acc;
  P::run(a, b, K, smem, acc);
#pragma unroll
  for (int i = 0; i < P::kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < P::kNT; ++j)
        *reinterpret_cast<float2*>(smem + P::row(i, 2 * h) * kLdY + P::col(j, 0)) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
}

// One row's residual and statistics, a warp per row, lane + 32 j its columns:
// r = x + (y + bias) * rmask * inv_keep, mu, inv = 1 / sqrt(var + eps) (flax's
// fast variance over the Dv valid columns; r is zero past them), and each
// column's dropout scale rs.
template <int D, typename T>
__device__ __forceinline__ void residual_row(const float* Yrow, const float* __restrict__ bias,
                                             const T* __restrict__ x,
                                             const unsigned char* __restrict__ rmask, long n,
                                             float inv_keep, float eps, int Dv,
                                             float (&r)[D / 32], float (&rs)[D / 32], float& mu,
                                             float& inv) {
  const int lane = threadIdx.x & 31;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    const int c = lane + 32 * j;
    float y = Yrow[c] + bias[c];
    rs[j] = rmask ? (float)rmask[n * D + c] * inv_keep : 1.f;
    if (rmask) y *= rs[j];
    r[j] = tc::load1(x + n * D + c) + y;
    s1 += r[j];
    s2 += r[j] * r[j];
  }
  const float inv_d = 1.f / (float)Dv;
  mu = warp_sum(s1) * inv_d;
  const float var = fmaxf(warp_sum(s2) * inv_d - mu * mu, 0.f);
  inv = 1.f / sqrtf(var + eps);
}

// The LayerNorm forward's epilogue, a warp per row: out = LayerNorm(x + (y +
// bias) * rmask * inv_keep) for rows n0 .. n0 + kRows - 1 of a block of
// kThreads threads, y staged in Ys [kRows][D + 4], its statistics over the
// first Dv columns (ln_fwd_tile's, and the bf16 entry's wgmma_ffw.cuh
// wg_ln_fwd_tile's)
template <int D, int kRows, int kThreads, typename T>
__device__ __forceinline__ void ln_fwd_rows(const float* Ys, int n0,
                                            const float* __restrict__ bias,
                                            const T* __restrict__ x,
                                            const float* __restrict__ gamma,
                                            const float* __restrict__ beta,
                                            const unsigned char* __restrict__ rmask,
                                            T* __restrict__ out, int N, float inv_keep,
                                            float eps, int Dv) {
  constexpr int DJ = D / 32, kWarps = kThreads / 32, kLdY = D + tc::kPad;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = warp; row < kRows; row += kWarps) {  // warp-uniform
    const long n = n0 + row;
    if (n >= N) break;
    float r[DJ], rs[DJ], mu, inv;
    residual_row<D>(Ys + row * kLdY, bias, x, rmask, n, inv_keep, eps, Dv, r, rs, mu, inv);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      tc::store1(out + n * D + c, (r[j] - mu) * inv * gamma[c] + beta[c]);
    }
  }
}

// out = LayerNorm(x + (A B + bias) * rmask * inv_keep) for the block's 64
// rows, its statistics over the first Dv columns
template <int D, typename T>
__device__ __forceinline__ void ln_fwd_tile(const T* __restrict__ A, int K,
                                            const T* __restrict__ B,
                                            const float* __restrict__ bias,
                                            const T* __restrict__ x,
                                            const float* __restrict__ gamma,
                                            const float* __restrict__ beta,
                                            const unsigned char* __restrict__ rmask,
                                            T* __restrict__ out, int N, float inv_keep,
                                            float eps, int Dv, float* smem) {
  product_rows<D>(A, K, B, N, smem);
  ln_fwd_rows<D, kRowsD, LnProduct<D, T>::kThreads>(smem, blockIdx.x * kRowsD, bias, x, gamma,
                                                    beta, rmask, out, N, inv_keep, eps, Dv);
}

// The same product, then the LayerNorm backward: dr (into dr_out; 0 past
// Dv), dy, and the block's sums over its rows of dout * xhat | dout | dy into
// part [blocks][3][D]
template <int D, typename T, typename R>
__device__ __forceinline__ void ln_bwd_tile(const T* __restrict__ A, int K,
                                            const T* __restrict__ B,
                                            const float* __restrict__ bias,
                                            const T* __restrict__ x,
                                            const float* __restrict__ gamma,
                                            const unsigned char* __restrict__ rmask,
                                            const T* __restrict__ dout,
                                            R* __restrict__ dr_out,
                                            T* __restrict__ dy_out, float* __restrict__ part,
                                            int N, float inv_keep, float eps, int Dv,
                                            float* smem) {
  constexpr int DJ = D / 32, kThreads = LnProduct<D, T>::kThreads, kWarps = kThreads / 32;
  constexpr int kLdY = D + tc::kPad;
  product_rows<D>(A, K, B, N, smem);
  float* Red = smem + kRowsD * kLdY;  // the warps' partials, [warps][3][D]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kRowsD;
  float pg[DJ], pb[DJ], po[DJ];
#pragma unroll
  for (int j = 0; j < DJ; ++j) pg[j] = pb[j] = po[j] = 0.f;
  for (int row = warp; row < kRowsD; row += kWarps) {  // warp-uniform
    const long n = n0 + row;
    if (n >= N) break;
    float r[DJ], rs[DJ], mu, inv;
    residual_row<D>(smem + row * kLdY, bias, x, rmask, n, inv_keep, eps, Dv, r, rs, mu, inv);
    float xh[DJ], gd[DJ], g[DJ], sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      xh[j] = (r[j] - mu) * inv;
      g[j] = tc::load1(dout + n * D + c);
      gd[j] = g[j] * gamma[c];
      sg += gd[j];
      sgx += gd[j] * xh[j];
    }
    const float inv_d = 1.f / (float)Dv;  // gd is 0 past Dv (gamma is)
    const float mean_g = warp_sum(sg) * inv_d;
    const float mean_gx = warp_sum(sgx) * inv_d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = lane + 32 * j;
      const float dr = c < Dv ? (gd[j] - mean_g - xh[j] * mean_gx) * inv : 0.f;
      const float dy = rmask ? dr * rs[j] : dr;
      tc::store1(dr_out + n * D + c, dr);
      tc::store1(dy_out + n * D + c, dy);
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
  for (int e = tid; e < 3 * D; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += Red[w * 3 * D + e];
    part[(long)blockIdx.x * 3 * D + e] = s;
  }
}

// out = A B^T (kAdd: out = base + A B^T, base f32 and possibly out itself)
// for the block's 64 rows, A [N, K], B [D][K]
template <int D, bool kAdd, typename T, typename Out>
__device__ __forceinline__ void dx_tile(const T* __restrict__ A, int K,
                                        const T* __restrict__ B, const float* base, Out* out,
                                        int N, float* smem) {
  using P = DxProduct<D, T>;
  const int n0 = blockIdx.x * kRowsD;
  const typename P::A a{A + (long)n0 * K, K, N - n0, K};
  const typename P::B b{B, K, D, K};  // (B^T)(k, d) = B[d][k]
  typename P::Acc acc;
  P::run(a, b, K, smem, acc);
#pragma unroll
  for (int i = 0; i < P::kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + P::row(i, 2 * h);
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < P::kNT; ++j) {
        const long at = (long)n * D + P::col(j, 0);
        float2 v = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        if (kAdd) {
          const float2 was = *reinterpret_cast<const float2*>(base + at);
          v = make_float2(was.x + v.x, was.y + v.y);
        }
        tc::store2(out + at, v.x, v.y);
      }
    }
}

// part[split] = A[rows of split]^T B[rows of split] for the block's 128 x 64
// tile of the [M, O] weight gradient (A [N, M], B [N, O] row-major); blockIdx
// is (m tile, o tile, split)
template <typename T>
__device__ __forceinline__ void grad_tile(const T* __restrict__ A, int M,
                                          const T* __restrict__ B, int O,
                                          float* __restrict__ part, int N, int rows_per_split,
                                          float* smem) {
  using P = GradProductOf<T>;
  const int m0 = blockIdx.x * kGradM, o0 = blockIdx.y * kGradO, split = blockIdx.z;
  const int r0 = split * rows_per_split;
  const int rows = max(0, min(N - r0, rows_per_split));
  const long first = rows > 0 ? r0 : 0;  // an empty split reads nothing
  const typename P::A a{A + first * M + m0, M, M - m0, rows};
  const typename P::B b{B + first * O + o0, O, O - o0, rows};
  typename P::Acc acc;
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

// out[e] = sum over s of part[s][e], s in order; one thread per e (Out: f32,
// or bf16 rounded to nearest even)
template <typename Out>
__device__ __forceinline__ void ordered_sum(const float* __restrict__ part,
                                            Out* __restrict__ out, int splits, long width) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= width) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(long)k * width + e];
  tc::store1(out + e, s);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

}  // namespace msfa_ln

#define MSFA_TRY(call)                      \
  do {                                      \
    const cudaError_t e_ = (call);          \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)
