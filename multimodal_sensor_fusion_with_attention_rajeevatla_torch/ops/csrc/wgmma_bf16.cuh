// bf16 products on Hopper's warpgroup tensor-core instruction (wgmma), for
// sm_90a: the main loop of the bf16 entries' redesigned kernels (the packed
// attention forward's, packed_attention.cu, and the FFW residual-LN
// backward's and the feed-forward hidden's, wgmma_ffw.cuh). Only the bf16
// entries reach this header; the f32 entries keep tf32_mma.cuh's 3xTF32
// mma.sync products.
//
// wgmma.mma_async m64n64k16 .f32.bf16.bf16: four warps (a warpgroup) issue
// one asynchronous product of a 64 x 16 A by a 16 x 64 B into 64 x 64 f32
// accumulators, 32 a thread; B, and A unless it comes from registers, read
// from shared memory through a descriptor. It is the instruction that reaches
// the card's bf16 tensor-core rate (989 TFLOP/s dense). Each product of two
// bf16 values is exact in f32; the unit sums them and truncates its sums
// toward zero, so every product below keeps a 64-deep chunk's sum in a fresh
// accumulator and adds the chunks in FP32, rounding to nearest.
//
// Layout in shared memory. Every staged tile is made of panels of 128-byte
// rows (64 bf16) with the 128-byte swizzle (Swizzle<3,4,3>: the 16-byte
// piece c of row r lies at piece c ^ (r & 7)), panels 1024-byte aligned. An
// operand whose k runs along a row in device memory ("K-major": x rows of
// k) is staged as X rows of one 64-deep chunk; one whose k runs down the
// columns ("MN-major": k rows of x, a transposed operand such as W2^T or
// hd^T) as 64 k rows of X, a panel for each 64 columns. wgmma reads both
// (its transpose bits), so no operand is copied or transposed. One
// descriptor points at a 64 (x) x 16 (k) piece:
//   K-major:  tile + 128 x0 + 32 s        (stride between 8-row groups 1024)
//   MN-major: tile + 8192 x0/64 + 2048 s  (stride between 8-k-row groups 1024)
// for rows x0 .. x0 + 63 (x0 a multiple of 64) and k-step s of the chunk.
// Pieces are copied by cp.async (16 bytes a thread, zero-filled past the
// valid rows and columns); neighbouring threads read neighbouring pieces of
// one row and write them to 8 distinct bank groups.
//
// Accumulator of m64n64 (thread = 32 w + 4 g + t within the warpgroup):
//   d[4 j + e] at row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1)
// A from registers (m64k16, bf16 pairs, low half the lower column):
//   a0 (16 w + g, 2t | 2t+1), a1 (16 w + g + 8, 2t | 2t+1),
//   a2 (16 w + g, 2t+8 | 2t+9), a3 (16 w + g + 8, 2t+8 | 2t+9)
// so an accumulator's columns 16 c .. 16 c + 15 are the A operand of k-step c
// with no shuffle (attention's P).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace msfa_wg {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;         // depth of one staged chunk and of one fresh accumulator
constexpr int kPanelBytes = 8192;  // 64 rows of 128 bytes
constexpr int kAlignSlack = 1024;  // dynamic shared memory is aligned up to 1024 bytes by hand

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = smem_u32(p);
  return p + ((1024u - (s & 1023u)) & 1023u);
}

// byte offset of 16-byte piece c (0..7) of row r in a 128-byte-swizzled panel
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// A shared-memory matrix descriptor with the 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// The descriptor of the 64 (x) x 16 (k) piece at rows x0 .. x0 + 63 and
// k-step s of a staged tile (K-major: kKDown false; MN-major: true). Within
// an MN-major piece both offsets are the stride between groups of 8 k rows.
template <bool kKDown>
__device__ __forceinline__ uint64_t piece_desc(uint32_t tile, int x0, int s) {
  if constexpr (kKDown) {
    return make_desc(tile + (uint32_t)((x0 >> 6) * kPanelBytes + s * 2048), 1024, 1024);
  } else {
    return make_desc(tile + (uint32_t)(x0 * 128 + s * 32), 16, 1024);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async writes shared memory through the generic proxy, wgmma reads it
// through the async proxy: each thread fences its landed copies before the
// barrier that precedes the product
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Registers an in-flight wgmma reads or writes: an empty asm that "uses and
// sets" each keeps the compiler from moving their accesses across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (=|+=) A B, A and B from shared memory (kTransA / kTransB: MN-major)
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"((int)accumulate), "n"(kTransA), "n"(kTransB)
      : "memory");
}

// d (=|+=) A B, A from registers (four bf16 pairs), B from shared memory
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"((int)accumulate), "n"(kTransB)
      : "memory");
}

// Copy kRows rows of kCols bf16 (a multiple of 8) into 128-byte-swizzled
// panels of kRows rows, a panel for each 64 columns: element (r, c) from
// src[r * ld + c], zero for r >= r_valid or c >= c_valid (c_valid a multiple
// of 8). `safe` is any readable address, handed to the copies that read
// nothing. Asynchronous; the caller commits.
template <int kRows, int kCols>
__device__ __forceinline__ void stage_panels(unsigned char* dst, const bf16* src, long ld,
                                             int r_valid, int c_valid, const bf16* safe, int tid,
                                             int nthreads) {
  constexpr int kPieces = kCols / 8;  // 16-byte pieces of a row
#pragma unroll 4
  for (int i = tid; i < kRows * kPieces; i += nthreads) {
    const int r = i / kPieces, c = i % kPieces;
    const bool ok = r < r_valid && 8 * c < c_valid;
    msfa_tc::cp_async16(dst + (c >> 3) * (kRows * 128) + swz(r, c & 7),
                        ok ? src + (long)r * ld + 8 * c : safe, ok);
  }
}

// One operand of a block's product, from the block's element (x = 0, k = 0):
// K-major: (x, k) at base[x * ld + k]; MN-major: (x, k) at base[k * ld + x].
// x at or past x_valid and k at or past k_valid read as zero.
struct Operand {
  const bf16* base;
  long ld;
  int x_valid;
  int k_valid;
};

// stage the 64-deep chunk at depth k0 of an operand with X rows or columns
template <int X, bool kKDown>
__device__ __forceinline__ void stage_chunk(unsigned char* dst, const Operand& op, int k0,
                                            int tid, int nthreads) {
  if constexpr (kKDown) {
    stage_panels<kChunk, X>(dst, op.base + (long)k0 * op.ld, op.ld, op.k_valid - k0, op.x_valid,
                            op.base, tid, nthreads);
  } else {
    stage_panels<X, kChunk>(dst, op.base + k0, op.ld, op.x_valid, op.k_valid - k0, op.base, tid,
                            nthreads);
  }
}

// A block's tile of acc = A B over k < k_len on wgmma: kWgM warpgroups, each
// owning 64 rows x the tile's kTileN columns (a multiple of 64, kTileN / 64
// m64n64 accumulators a thread). The operands stream through a ring of
// kStages 64-deep chunks (cp.async by every thread, kStages - 1 chunks in
// flight while one is multiplied). With kFresh each chunk's four k-steps go
// into a fresh accumulator that is added to acc in FP32 (a long k, where the
// unit's truncated sums would add up); without it the whole k accumulates in
// the unit (a short k: K = d_model <= 256, half the registers, so twice the
// columns a warpgroup). A fresh accumulator covers kPartNB of the
// warpgroup's 64-column pieces at a time (fewer registers than acc). The
// order of every sum is fixed by the tile, so a product repeats bit for bit.
template <int kWgM, int kTileN, bool kAKDown, bool kBKDown, bool kFresh = true,
          int kStages_ = 3, int kPartNB = kTileN / 64>
struct WgProduct {
  static_assert(kTileN % 64 == 0, "a warpgroup owns whole 64-column pieces");
  static_assert((kTileN / 64) % kPartNB == 0, "fresh accumulators of whole pieces");
  static constexpr int kBM = 64 * kWgM, kBN = kTileN;
  static constexpr int kThreads = 128 * kWgM;
  static constexpr int kNB = kTileN / 64;
  static constexpr int kABytes = kBM * 128, kBBytes = kBN * 128;  // one chunk of each
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kStages_;
  static constexpr int kRingBytes = kStages * kStageBytes;
  using Acc = float[kNB][32];

  __device__ static __forceinline__ int wg() { return threadIdx.x >> 7; }
  // where acc[nb][4 j + e] lies in the block's tile
  __device__ static __forceinline__ int row(int e) {
    return 64 * wg() + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
  }
  __device__ static __forceinline__ int col(int nb, int j, int e) {
    return 64 * nb + 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
  }

  // acc = A B over k < k_len; smem (1024-byte aligned) is free again on return
  __device__ static void run(const Operand& a, const Operand& b, int k_len, unsigned char* smem,
                             Acc& acc) {
    const int tid = threadIdx.x;
    const int x0a = 64 * wg();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
    const int chunks = (k_len + kChunk - 1) / kChunk;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < chunks) {
        stage_chunk<kBM, kAKDown>(smem + s * kStageBytes, a, s * kChunk, tid, kThreads);
        stage_chunk<kBN, kBKDown>(smem + s * kStageBytes + kABytes, b, s * kChunk, tid,
                                  kThreads);
      }
      msfa_tc::cp_async_commit();  // one group a chunk, empty or not
    }
    for (int kc = 0; kc < chunks; ++kc) {
      msfa_tc::cp_async_wait<kStages - 2>();  // chunk kc has landed for this thread ...
      fence_proxy_async();
      __syncthreads();  // ... for every thread; chunk kc - 1's slot is free
      const int next = kc + kStages - 1;
      if (next < chunks) {
        unsigned char* slot = smem + (next % kStages) * kStageBytes;
        stage_chunk<kBM, kAKDown>(slot, a, next * kChunk, tid, kThreads);
        stage_chunk<kBN, kBKDown>(slot + kABytes, b, next * kChunk, tid, kThreads);
      }
      msfa_tc::cp_async_commit();
      const uint32_t as = smem_u32(smem + (kc % kStages) * kStageBytes), bs = as + kABytes;
      if constexpr (kFresh) {
#pragma unroll
        for (int g0 = 0; g0 < kNB; g0 += kPartNB) {
          float part[kPartNB][32];
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < kChunk / 16; ++s) {
            const uint64_t da = piece_desc<kAKDown>(as, x0a, s);
#pragma unroll
            for (int nb = 0; nb < kPartNB; ++nb)
              wgmma_ss<kAKDown, kBKDown>(
                  part[nb], da, piece_desc<kBKDown>(bs, 64 * (g0 + nb), s), s > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int nb = 0; nb < kPartNB; ++nb) {
            fence_regs(part[nb]);
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[g0 + nb][i] += part[nb][i];
          }
        }
      } else {
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kChunk / 16; ++s) {
          const uint64_t da = piece_desc<kAKDown>(as, x0a, s);
#pragma unroll
          for (int nb = 0; nb < kNB; ++nb)
            wgmma_ss<kAKDown, kBKDown>(acc[nb], da, piece_desc<kBKDown>(bs, 64 * nb, s), true);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb) fence_regs(acc[nb]);
      }
    }
    msfa_tc::cp_async_wait<0>();
    __syncthreads();
  }
};

// ---- the packed attention forward's bf16 tile -------------------------------

// Terms of the bf16 split of P: p = hi + lo + lo2, each rounded to bf16, so
// P.V is three exact bf16 x bf16 products whose sum misses p v by ~2^-26 of
// it; one term (the TPU kernel's bf16 P) misses f32's 1e-5 limit by two
// orders, two reach 0.45 of it on a 5-key row at T = 512 (the CPU emulation
// in tests/test_torch_port_bf16.py).
constexpr int kPTerms = 3;
// warpgroups a block, each owning 64 query rows; they share the K and V tiles
constexpr int kAttnWgs = 2;

template <int D>
struct AttnWg {
  static constexpr int kDp = D < 64 ? 64 : D;  // the head dim in whole 64-wide panels
  static constexpr int kPanels = kDp / 64;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // 64 rows of kDp
  static constexpr int kRows = 64 * kAttnWgs;               // query rows a block
  static constexpr int kThreads = 128 * kAttnWgs;
  // Q (kRows rows), then two stages of (K, V)
  static constexpr int kSmemBytes = (kAttnWgs + 4) * kTileBytes + kAlignSlack;
};

// 2^x on the special-function unit (flushes a subnormal result to zero:
// p < 2^-126, nothing beside a row's max of 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// stage 64 rows of a (b, h) row's q, k or v (kDp columns, zero past D and past `valid` rows)
template <int D>
__device__ __forceinline__ void stage_rows64(unsigned char* dst, const bf16* src, long ld,
                                             int valid, const bf16* safe) {
  using A = AttnWg<D>;
  stage_panels<64, A::kDp>(dst, src, ld, valid, D, safe, threadIdx.x, A::kThreads);
}

// For query rows q0 .. q0 + 64 kAttnWgs - 1 of one (b, h) row with `len` valid
// keys: s = (q k^T) * sm_scale, out = softmax(s) v, lse; rows of q, k, v at
// q/k/v + t * ld (bf16), of out at out + t * ld_out, lse at lse + t * ld_lse.
// Query rows past T are neither read nor written; a row with no valid key
// gets exact zeros and lse -1e30. The softmax runs in base 2 on the unscaled
// scores: p = 2^(s c - m c), c = sm_scale log2(e), the same ratio p / sum p.
template <int D>
__device__ __forceinline__ void attention_fwd_wg(const bf16* __restrict__ q,
                                                 const bf16* __restrict__ k,
                                                 const bf16* __restrict__ v, long ld,
                                                 float* __restrict__ out, long ld_out,
                                                 float* __restrict__ lse, long ld_lse, int T,
                                                 int len, int q0, float sm_scale,
                                                 unsigned char* smem) {
  using A = AttnWg<D>;
  constexpr int kSteps = A::kDp / 16;  // k-steps of Q.K^T
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (len + 63) / 64;  // tiles at or past the length: skipped
  const float c2 = sm_scale * 1.4426950408889634f;  // log2(e)
  unsigned char* stages = smem + kAttnWgs * A::kTileBytes;
  const uint32_t qs = smem_u32(smem + wg * A::kTileBytes);

#pragma unroll
  for (int w = 0; w < kAttnWgs; ++w)
    stage_rows64<D>(smem + w * A::kTileBytes, q + (long)(q0 + 64 * w) * ld, ld,
                          T - q0 - 64 * w, q);
  if (n_tiles > 0) {
    stage_rows64<D>(stages, k, ld, T, k);
    stage_rows64<D>(stages + A::kTileBytes, v, ld, T, v);
  }
  msfa_tc::cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY};  // the running max of the unscaled scores
  float l[2] = {0.f, 0.f};
  float o[A::kPanels][32];
#pragma unroll
  for (int p = 0; p < A::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const uint32_t ks = smem_u32(stages + 2 * A::kTileBytes * (kt & 1)), vs = ks + A::kTileBytes;
    msfa_tc::cp_async_wait<0>();  // this tile's K and V (and Q) have landed for this thread ...
    fence_proxy_async();
    __syncthreads();  // ... for every thread; and tile kt - 1's stage is free
    if (kt + 1 < n_tiles) {  // the next tile's copies fly while this one is multiplied
      unsigned char* next = stages + 2 * A::kTileBytes * ((kt + 1) & 1);
      const int k1 = (kt + 1) * 64;
      stage_rows64<D>(next, k + (long)k1 * ld, ld, T - k1, k);
      stage_rows64<D>(next + A::kTileBytes, v + (long)k1 * ld, ld, T - k1, v);
      msfa_tc::cp_async_commit();
    }

    // S = Q K^T over the (padded) head dim: K is the B operand, k along its rows
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
      wgmma_ss<0, 0>(s, piece_desc<false>(qs + (st >> 2) * kPanelBytes, 0, st & 3),
                     piece_desc<false>(ks + (st >> 2) * kPanelBytes, 0, st & 3), st > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax: one rescale per tile; the tile holds a valid key, so the new max is finite
    const int k0 = kt * 64;
    if (k0 + 64 > len) {  // the row's last tile: keys past the length masked
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) >= len) s[4 * j + e] = -INFINITY;
    }
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mc[r] = mx * c2;
      const float rescale = ex2(m[r] * c2 - mc[r]);  // 0 on the first tile
      m[r] = mx;
      l[r] *= rescale;
#pragma unroll
      for (int p = 0; p < A::kPanels; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[p][4 * j + 2 * r] *= rescale;
          o[p][4 * j + 2 * r + 1] *= rescale;
        }
    }
    // P, and its split into bf16 terms as the A operand of P.V's k-steps
    uint32_t pa[kPTerms][4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g (h 0) and g + 8 (h 1), keys 8j + 2t, + 1
        float r0 = ex2(fmaf(s[4 * j + 2 * h], c2, -mc[h]));  // masked: 2^-inf = 0
        float r1 = ex2(fmaf(s[4 * j + 2 * h + 1], c2, -mc[h]));
        l[h] += r0 + r1;
#pragma unroll
        for (int term = 0; term < kPTerms; ++term) {
          const uint32_t w = pack_bf16(r0, r1);
          pa[term][j >> 1][2 * (j & 1) + h] = w;
          r0 -= __uint_as_float(w << 16);
          r1 -= __uint_as_float(w & 0xffff0000u);
        }
      }

    // O += P V: V is the B operand with k (the keys) down its columns. The
    // tile's terms, smallest first, go into a fresh accumulator that is then
    // added to O in FP32.
    float part[A::kPanels][32];
    wgmma_fence();
#pragma unroll
    for (int term = kPTerms - 1; term >= 0; --term)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int p = 0; p < A::kPanels; ++p)
          wgmma_rs<1>(part[p], pa[term][c], piece_desc<true>(vs, 64 * p, c),
                      term != kPTerms - 1 || c > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int term = 0; term < kPTerms; ++term)
#pragma unroll
      for (int c = 0; c < 4; ++c) fence_regs(pa[term][c]);
#pragma unroll
    for (int p = 0; p < A::kPanels; ++p) {
      fence_regs(part[p]);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] += part[p][i];
    }
  }
  msfa_tc::cp_async_wait<0>();  // Q's copies, where no tile ran

  const int row0 = q0 + 64 * wg + 16 * warp + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qr = row0 + 8 * r;
    if (qr >= T) continue;
    const bool any = l[r] > 0.f;  // no valid key: exact zeros, lse = -1e30
    const float inv = any ? 1.f / l[r] : 0.f;
    float* orow = out + (long)qr * ld_out;
#pragma unroll
    for (int p = 0; p < A::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * p + 8 * j + 2 * t;
        if (c >= D) continue;
        const float2 val = any ? make_float2(o[p][4 * j + 2 * r] * inv,
                                             o[p][4 * j + 2 * r + 1] * inv)
                               : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(orow + c) = val;
      }
    if (t == 0) lse[(long)qr * ld_lse] = any ? m[r] * sm_scale + logf(l[r]) : -1e30f;
  }
}

}  // namespace msfa_wg
