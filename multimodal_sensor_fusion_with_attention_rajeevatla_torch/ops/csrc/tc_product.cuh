// One block's tile of a matrix product on the TF32 tensor cores at f32
// accuracy (3xTF32, tf32_mma.cuh), for Hopper (sm_90a): the template every
// product of the residual-LN kernels (ffw_ln.cu, proj_ln.cu's backward,
// residual_ln.cuh) is built from.
//
//   acc[m][n] = sum over k < k_len of A(m, k) B(k, n)
//
// for the block's BM x BN tile. Each operand lies in device memory row-major
// in one of two ways, chosen per operand at compile time:
//   k along the row  ([x][k]: x rows of k contiguous floats), or
//   k down a column  ([k][x]: k rows of x contiguous floats),
// so a product of transposes (dy W2^T, x^T dpre) needs no copy.
//
// Design. 8 or 16 warps, each owning a 32 x 32 piece of the tile (2 x 4
// m16n8k8 accumulators). The operands stream through a three-stage ring of
// 32-deep chunks in shared memory, copied by cp.async (16 bytes a copy,
// zero-filled past the valid rows and columns), so two chunks are in flight
// while one is multiplied. Each chunk's products go into a fresh accumulator
// that is then added to the running sum in FP32: the tensor core cuts the sums
// it accumulates toward zero, and over K = 2,048 or 16,384 those cuts add up
// (as they did in the attention kernels' P.V sum), where the FP32 add rounds
// to nearest. The order of every sum is fixed by the tile, so a product repeats
// bit for bit.
//
// Fragment order: the logical k = t of a k-step is physical k0 + 2t and
// k = t + 4 is k0 + 2t + 1 for both operands (any order A and B share gives
// the same product). Then an operand stored k along the row gives each lane
// two neighbouring floats: one 8-byte load per fragment row, and a row stride
// of 32 + 8 floats keeps a half-warp's loads on 32 distinct banks; an operand
// stored k down a column is read as tf32_mma.cuh's load_a_colk / load_b_colk,
// with a row stride of columns + 4 floats.

#pragma once

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace msfa_tc {

constexpr int kProdK = 32;      // depth of one staged chunk: 4 k-steps of 8
constexpr int kProdStages = 3;  // chunks in the ring
constexpr int kRowKPad = 8;     // padding of a k-along-the-row tile's rows

// One operand of a block's product: X of its rows or columns (the m or n
// side) over a 32-deep chunk of k, elements of type E. `base` points at the
// block's element (x = 0, k = 0); `ld` is the row stride in device memory, in
// elements; x at or past x_valid and k at or past k_valid read as zero (both
// multiples of 16 / sizeof(E)).
template <int X, bool kKDown, typename E = float>
struct TileOperand {
  static constexpr int kPer = 16 / (int)sizeof(E);  // elements of one 16-byte copy
  static constexpr int kLd = kKDown ? X + kPadOf<E> : kProdK + kRowKPad;  // in elements
  static constexpr int kElems = kKDown ? kProdK * kLd : X * kLd;
  static constexpr int kFloats = kElems * (int)sizeof(E) / 4;  // its room, in floats
  const E* base;
  long ld;
  int x_valid;
  int k_valid;

  // copy the chunk at depth k0 into dst (asynchronously; the caller commits)
  __device__ __forceinline__ void stage(float* dst_f, int k0, int tid, int nthreads) const {
    E* dst = reinterpret_cast<E*>(dst_f);
    if constexpr (kKDown) {  // [k][x]: 32 rows of X elements
      constexpr int kChunks = X / kPer;
      for (int i = tid; i < kProdK * kChunks; i += nthreads) {
        const int r = i / kChunks, c = (i % kChunks) * kPer;
        const bool ok = k0 + r < k_valid && c < x_valid;
        cp_async16(dst + r * kLd + c, ok ? base + (long)(k0 + r) * ld + c : base, ok);
      }
    } else {  // [x][k]: X rows of 32 elements
      constexpr int kChunks = kProdK / kPer;
      for (int i = tid; i < X * kChunks; i += nthreads) {
        const int r = i / kChunks, c = (i % kChunks) * kPer;
        const bool ok = r < x_valid && k0 + c < k_valid;
        cp_async16(dst + r * kLd + c, ok ? base + (long)r * ld + k0 + c : base, ok);
      }
    }
  }
};

// A fragment (rows m0 .. m0+15, k-step k0) of a staged A chunk.
template <bool kKDown, typename E>
__device__ __forceinline__ FragA load_a(const E* s, int ld, int m0, int k0, int g, int t) {
  if constexpr (kKDown) {
    return load_a_colk(s, ld, m0, k0, g, t);
  } else if constexpr (kHasLo<E>) {
    const E* p = s + (m0 + g) * ld + k0 + 2 * t;
    const float2 u = *reinterpret_cast<const float2*>(p);
    const float2 w = *reinterpret_cast<const float2*>(p + 8 * ld);
    return split_a(u.x, w.x, u.y, w.y);
  } else {  // bf16: one 32-bit word holds k0 + 2t (low half) and k0 + 2t + 1
    const E* p = s + (m0 + g) * ld + k0 + 2 * t;
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
    FragA f;
    f.hi[0] = bf16_lo_half(u), f.hi[1] = bf16_lo_half(w);
    f.hi[2] = bf16_hi_half(u), f.hi[3] = bf16_hi_half(w);
    f.lo[0] = f.lo[1] = f.lo[2] = f.lo[3] = 0u;
    return f;
  }
}

// A B fragment (columns n0 .. n0+7, k-step k0) of a staged B chunk.
template <bool kKDown, typename E>
__device__ __forceinline__ FragB load_b(const E* s, int ld, int n0, int k0, int g, int t) {
  if constexpr (kKDown) {
    return load_b_colk(s, ld, k0, n0, g, t);
  } else if constexpr (kHasLo<E>) {
    const float2 u = *reinterpret_cast<const float2*>(s + (n0 + g) * ld + k0 + 2 * t);
    return split_b(u.x, u.y);
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(s + (n0 + g) * ld + k0 + 2 * t);
    FragB f;
    f.hi[0] = bf16_lo_half(u), f.hi[1] = bf16_hi_half(u);
    f.lo[0] = f.lo[1] = 0u;
    return f;
  }
}

// The block's BM x BN tile over WARPS_M x WARPS_N warps of 32 x 32 each.
// kAKDown / kBKDown: A stored [k][m] / B stored [k][n] (else [m][k] / [n][k]);
// EA / EB: the operands' element types.
template <int BM, int BN, int WARPS_M, int WARPS_N, bool kAKDown, bool kBKDown,
          typename EA = float, typename EB = float>
struct TcProduct {
  static_assert(BM == 32 * WARPS_M && BN == 32 * WARPS_N, "warp tiles are 32 x 32");
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int kMT = 2, kNT = 4;  // m16 and n8 accumulators per warp
  using A = TileOperand<BM, kAKDown, EA>;
  using B = TileOperand<BN, kBKDown, EB>;
  static constexpr int kStageFloats = A::kFloats + B::kFloats;
  static constexpr int kSmemFloats = kProdStages * kStageFloats;
  using Acc = float[kMT][kNT][4];

  // Where acc[i][j][e] lies in the tile: row row(i, e), column col(j, e).
  __device__ static __forceinline__ int warp_row0() { return (threadIdx.x >> 5) / WARPS_N * 32; }
  __device__ static __forceinline__ int warp_col0() { return (threadIdx.x >> 5) % WARPS_N * 32; }
  __device__ static __forceinline__ int row(int i, int e) {
    return warp_row0() + 16 * i + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
  }
  __device__ static __forceinline__ int col(int j, int e) {
    return warp_col0() + 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
  }

  // acc = A B over k < k_len. Shared memory is free again when it returns.
  __device__ static void run(const A& a, const B& b, int k_len, float* smem, Acc& acc) {
    const int tid = threadIdx.x, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int m_base = warp_row0(), n_base = warp_col0();
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const int chunks = (k_len + kProdK - 1) / kProdK;
#pragma unroll
    for (int s = 0; s < kProdStages - 1; ++s) {
      if (s < chunks) {
        a.stage(smem + s * kStageFloats, s * kProdK, tid, kThreads);
        b.stage(smem + s * kStageFloats + A::kFloats, s * kProdK, tid, kThreads);
      }
      cp_async_commit();  // one group per chunk, empty or not: the count stays uniform
    }
    for (int kc = 0; kc < chunks; ++kc) {
      cp_async_wait<kProdStages - 2>();  // chunk kc has landed for this thread ...
      __syncthreads();                    // ... for every thread; chunk kc-1's slot is free
      const int next = kc + kProdStages - 1;
      if (next < chunks) {
        float* slot = smem + (next % kProdStages) * kStageFloats;
        a.stage(slot, next * kProdK, tid, kThreads);
        b.stage(slot + A::kFloats, next * kProdK, tid, kThreads);
      }
      cp_async_commit();
      const EA* As = reinterpret_cast<const EA*>(smem + (kc % kProdStages) * kStageFloats);
      const EB* Bs = reinterpret_cast<const EB*>(smem + (kc % kProdStages) * kStageFloats +
                                                 A::kFloats);
      float part[kMT][kNT][4];
#pragma unroll
      for (int kk = 0; kk < kProdK; kk += 8) {
        FragA fa[kMT];
#pragma unroll
        for (int i = 0; i < kMT; ++i) fa[i] = load_a<kAKDown>(As, A::kLd, m_base + 16 * i, kk, g, t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const FragB fb = load_b<kBKDown>(Bs, B::kLd, n_base + 8 * j, kk, g, t);
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            if (kk == 0) {
              mma_n<kHasLo<EA>, kHasLo<EB>, true>(part[i][j], fa[i], fb);
            } else {
              mma_n<kHasLo<EA>, kHasLo<EB>>(part[i][j], fa[i], fb);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
    cp_async_wait<0>();
    __syncthreads();
  }
};

}  // namespace msfa_tc
