// The packed attention backward's bf16 entry on wgmma (wgmma_bf16.cuh's
// primitives), for Hopper (sm_90a): the bodies of packed_attention_bwd.cu's
// three bf16 kernels. The f32 entries keep attention_bwd.cuh's 3xTF32
// mma.sync body.
//
// The function is the f32 backward on the bf16 values of q, k and v, dq, dk
// and dv each rounded to bf16 once from f32 sums (attention.py
// packed_attention_bwd_bf16_reference). Every product runs as m64n64k16 bf16
// wgmma from 128-byte-swizzled shared memory: a product of two bf16 values
// is exact in f32, and each f32 operand is carried as a sum of bf16 terms
// (x = hi + lo + lo2, each the bf16 rounding of what the terms before it
// left, so the three miss x by ~2^-27 of it):
//   dout  kDoutTerms planes, split once by bwd_prep_tile (below), which also
//         takes delta = rowsum(dout * out) from the same read and marks
//         each 64-row query tile of each (b, h) whose lo planes are all
//         zero: a bf16 cotangent (the model's, whose attention output is
//         cast to bf16) has one plane, and the products skip the zero
//         planes, whose terms add exact zeros. The plane count is a
//         template parameter of a tile's products, chosen once a tile:
//         the wgmma of one group then run with no branch between them
//         (ptxas serializes wgmma that a runtime branch separates)
//   P, dS kBwdPTerms / kDsTerms register terms, split where they are computed
// Three terms each keep dqkv within one bf16 step of the f32 entry's sums
// in all but 4e-5 to 4e-4 of its entries (the gate of chip_smoke.py and the
// tests); with two, the CPU emulation (tests/test_torch_port_bf16.py) misses
// it on an f32 cotangent by up to 3.9 steps and 6.3e-3 of the entries. A
// product of an f32 by an f32 (P^T dO) takes the term pairs whose orders
// add up to at most two (six with three dout planes, three with one). A product's terms go
// smallest first into one fresh accumulator, which is added in FP32 to the
// running sum (the unit truncates the sums it accumulates; the FP32 add
// rounds to nearest).
//
//   attention_dkv_wg  dk and dv for 64 keys a block: K and V stay in
//                     shared memory while the block walks every 64-row
//                     query tile (Q, the dout planes, lse, delta by cp.async
//                     into a two-stage ring): S^T = K Q^T and dP^T = V dO^T,
//                     P^T and dS^T = P^T (dP^T - delta) in registers, split
//                     into bf16 terms that are the A operands of dv += P^T dO
//                     and dk += dS^T Q (Q and dO MN-major, read as they lie)
//   attention_dq_wg   dq for 64 queries a block: Q and the dout planes
//                     stay in shared memory while the block walks the key
//                     tiles below the length: S = Q K^T and dP = dO V^T
//                     again, P and dS in registers, dq += dS K (K MN-major),
//                     each key tile's product added in key-tile order, and
//                     sm_scale on last
// dq is thus a pass of its own that computes S and dP a second time (2 of
// the 13 products a (query, key) tile pair takes with a bf16 cotangent),
// where the f32 body writes a [B, ceil(T/64), T, F] f32 partial a key tile
// and sums them in a third launch. No atomics: every sum has a fixed order,
// and a run repeats bit for bit. Key tiles at or past the length give
// exact-zero dk and dv and add nothing to dq; query rows are not masked.
// Head dims 16 and 32 run on 64 columns, zero past D.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

namespace msfa_wg {

constexpr int kDoutTerms = 3;  // bf16 planes of the f32 cotangent
constexpr int kBwdPTerms = 3;  // bf16 terms of P in P^T dO
constexpr int kDsTerms = 3;    // bf16 terms of dS in dS^T Q and dS K
// a block is one warpgroup and takes 64 keys (dk, dv) or 64 queries (dq),
// so that three dq blocks fit an SM
constexpr int kBwdTileRows = 64;
constexpr float kBwdNegInf = -1e30f;

template <int D>
struct AttnBwdWg {
  static constexpr int kDp = D < 64 ? 64 : D;  // the head dim in whole 64-wide panels
  static constexpr int kPanels = kDp / 64;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // 64 rows of kDp bf16
  static constexpr int kThreads = 128;
  // dkv: K, V, then two stages of (Q, the dout planes, lse [64], delta [64]
  // in a 1024-byte slot)
  static constexpr int kQStageBytes = (1 + kDoutTerms) * kTileBytes + 1024;
  static constexpr int kDkvSmemBytes = 2 * kTileBytes + 2 * kQStageBytes + kAlignSlack;
  // dq: Q and the dout planes, then two stages of (K, V)
  static constexpr int kDqSmemBytes = (1 + kDoutTerms) * kTileBytes + 4 * kTileBytes + kAlignSlack;
};

// p = e^(s sm_scale - lse) as 2^(s sm_scale log2(e) - lse log2(e)) on the
// special-function unit (ex2.approx, ~2^-22 of p; flushes p < 2^-126 to
// zero): expf's accurate range reduction took 27-28% of the entry's time on
// an H100 (scripts/wgmma_bf16_variants.py)
__device__ __forceinline__ float softmax_p(float s, float sm_scale, float lse) {
  constexpr float kLog2e = 1.4426950408889634f;
  return ex2(fmaf(s, sm_scale * kLog2e, -lse * kLog2e));
}

// x as `n` bf16 terms, each the rounding of what the ones before it left
template <int n>
__device__ __forceinline__ void bf16_terms(float x, float y, uint32_t (&w)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) {
    w[i] = pack_bf16(x, y);
    x -= __uint_as_float(w[i] << 16);
    y -= __uint_as_float(w[i] & 0xffff0000u);
  }
}

// An m64n64 accumulator (rows of the warpgroup's 64, columns 64 wide) as
// n bf16 terms of the A operand of a product over its columns:
// a[term][c] is k-step c (columns 16 c .. 16 c + 15)
template <int n>
__device__ __forceinline__ void acc_terms(const float (&d)[32], uint32_t (&a)[n][4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g (h 0) and g + 8 (h 1), columns 8j + 2t, + 1
      uint32_t w[n];
      bf16_terms<n>(d[4 * j + 2 * h], d[4 * j + 2 * h + 1], w);
#pragma unroll
      for (int term = 0; term < n; ++term) a[term][j >> 1][2 * (j & 1) + h] = w[term];
    }
}

// d = A B over k = the head dim (kDp / 16 k-steps), A and B K-major 64-row
// tiles of kDp columns in panels; accumulate onto d when `onto`
template <int D>
__device__ __forceinline__ void head_dim_product(float (&d)[32], uint32_t a, uint32_t b,
                                                 bool onto) {
#pragma unroll
  for (int st = 0; st < AttnBwdWg<D>::kDp / 16; ++st)
    wgmma_ss<0, 0>(d, piece_desc<false>(a + (st >> 2) * kPanelBytes, 0, st & 3),
                   piece_desc<false>(b + (st >> 2) * kPanelBytes, 0, st & 3), onto || st > 0);
}

// d = A B^T with B's rows the planes of dout (kDoutIsA: A's rows): the
// first kPlanes planes' products, the smallest first, into a fresh
// accumulator
template <int D, bool kDoutIsA, int kPlanes>
__device__ __forceinline__ void dout_product(float (&d)[32], uint32_t other, uint32_t planes) {
  wgmma_fence();
#pragma unroll
  for (int j = kPlanes - 1; j >= 0; --j) {
    const uint32_t plane = planes + j * AttnBwdWg<D>::kTileBytes;
    if constexpr (kDoutIsA) {
      head_dim_product<D>(d, plane, other, j != kPlanes - 1);
    } else {
      head_dim_product<D>(d, other, plane, j != kPlanes - 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
}

// acc[p] += (sum over terms of A_term) B, B the first kNb of 64 (k) x kDp
// MN-major tiles: the pairs of (A term i, B tile jb) with i + jb < kOrder,
// the smallest orders first, in one fresh accumulator per 64-column panel
template <int D, int kTerms, int kOrder, int kNb>
__device__ __forceinline__ void terms_product(float (&acc)[AttnBwdWg<D>::kPanels][32],
                                              uint32_t (&a)[kTerms][4][4], uint32_t b_tiles) {
#pragma unroll
  for (int p = 0; p < AttnBwdWg<D>::kPanels; ++p) {
    float part[32];
    wgmma_fence();
#pragma unroll
    for (int order = kOrder - 1; order >= 0; --order)
#pragma unroll
      for (int jb = 0; jb <= order; ++jb) {
        const int i = order - jb;
        if (i < kTerms && jb < kNb) {  // folded at compile time
#pragma unroll
          for (int c = 0; c < 4; ++c)
            wgmma_rs<1>(part, a[i][c],
                        piece_desc<true>(b_tiles + jb * AttnBwdWg<D>::kTileBytes, 64 * p, c),
                        !(order == kOrder - 1 && jb == 0 && c == 0));
        }
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] += part[i];
  }
#pragma unroll
  for (int i = 0; i < kTerms; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(a[i][c]);
}

// stage 64 rows of a (b, h) row's operand (kDp columns, zero past D and past
// `valid` rows), by all the block's threads
template <int D>
__device__ __forceinline__ void stage_tile(unsigned char* dst, const bf16* src, long ld, int valid,
                                           const bf16* safe) {
  using A = AttnBwdWg<D>;
  stage_panels<64, A::kDp>(dst, src, ld, valid, D, safe, threadIdx.x, A::kThreads);
}

// write an m64 x kDp accumulator set (times `scale`) into rows r0 .. r0 + 63
// of out (row stride ld), rows past T and columns past D skipped
template <int D, typename Out>
__device__ __forceinline__ void store_rows(const float (&acc)[AttnBwdWg<D>::kPanels][32],
                                           Out* __restrict__ out, long ld, int r0, int T,
                                           float scale) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + g + 8 * h;
    if (r >= T) continue;
#pragma unroll
    for (int p = 0; p < AttnBwdWg<D>::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * p + 8 * j + 2 * t;
        if (c < D)
          msfa_tc::store2(out + (long)r * ld + c, acc[p][4 * j + 2 * h] * scale,
                          acc[p][4 * j + 2 * h + 1] * scale);
      }
  }
}

// One (b, h) row's views: row t of q, k, v at q/k/v + t * ld (bf16), of
// dout plane j at planes + j * plane_stride + t * ld_do, lse and delta at
// lse/delta + t * ld_stat, the dout planes each 64-row query tile needs at
// nterms[tile]; dq, dk, dv rows at dq/dk/dv + t * ld.
template <typename Out>
struct BwdWgRow {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long ld;
  const bf16* planes;
  long plane_stride;
  long ld_do;
  const float* lse;
  const float* delta;
  long ld_stat;
  const int* nterms;
  Out* dq;
  Out* dk;
  Out* dv;
};

// delta, the dout planes and their count for one 64-row query tile of one
// (b, h) row: rows t0 .. t0 + 63 (those below T) of out and dout [.., F] at
// out/dout + t * ld_f, delta at delta + t * ld_stat, plane j at planes + j *
// plane_stride + t * ld_f. 256 threads; the D / 4 lanes of a row each take
// four floats and add their part of delta by shuffles, in order. The tile
// needs one plane where every entry is a bf16 value, else all three, which
// are then written.
template <int D>
__device__ __forceinline__ void bwd_prep_tile(const float* __restrict__ out,
                                              const float* __restrict__ dout, long ld_f,
                                              float* __restrict__ delta, long ld_stat,
                                              bf16* __restrict__ planes, long plane_stride,
                                              int* __restrict__ nterms, int t0, int T) {
  constexpr int kLanes = D / 4;               // 4, 8, 16 or 32: a row never straddles two warps
  constexpr int kRowsAPass = 256 / kLanes;    // 64, 32, 16 or 8
  constexpr int kPasses = kBwdTileRows / kRowsAPass;
  const int lane = threadIdx.x % kLanes, r0 = threadIdx.x / kLanes;
  float rest[kPasses][4];  // what the first plane leaves
  bool more = false;
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int t = t0 + r0 + kRowsAPass * i;
    const bool ok = t < T;
    const long at = (long)t * ld_f + 4 * lane;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f), g = o;
    if (ok) {
      o = *reinterpret_cast<const float4*>(out + at);
      g = *reinterpret_cast<const float4*>(dout + at);
    }
    float s = g.x * o.x + g.y * o.y + g.z * o.z + g.w * o.w;
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const uint32_t w01 = pack_bf16(g.x, g.y), w23 = pack_bf16(g.z, g.w);
    rest[i][0] = g.x - __uint_as_float(w01 << 16);
    rest[i][1] = g.y - __uint_as_float(w01 & 0xffff0000u);
    rest[i][2] = g.z - __uint_as_float(w23 << 16);
    rest[i][3] = g.w - __uint_as_float(w23 & 0xffff0000u);
#pragma unroll
    for (int e = 0; e < 4; ++e) more = more || rest[i][e] != 0.f;
    if (ok) {
      if (lane == 0) delta[(long)t * ld_stat] = s;
      *reinterpret_cast<uint2*>(planes + at) = make_uint2(w01, w23);
    }
  }
  const int n = __syncthreads_or(more) ? kDoutTerms : 1;
  if (threadIdx.x == 0) *nterms = n;
  if (n == 1) return;
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int t = t0 + r0 + kRowsAPass * i;
    if (t >= T) continue;
    const long at = (long)t * ld_f + 4 * lane;
    uint32_t w[2][2];
    bf16_terms<2>(rest[i][0], rest[i][1], w[0]);
    bf16_terms<2>(rest[i][2], rest[i][3], w[1]);
    *reinterpret_cast<uint2*>(planes + plane_stride + at) = make_uint2(w[0][0], w[1][0]);
    *reinterpret_cast<uint2*>(planes + 2 * plane_stride + at) = make_uint2(w[0][1], w[1][1]);
  }
}

// One query tile's products for a warpgroup's 64 keys: S^T = K Q^T over the
// head dim and dP^T = V dO^T over kPlanes planes, P^T and dS^T in registers
// (row key (e < 2) or key + 8, column query q0 + 8j + 2t + (e & 1)), then
// dv += P^T dO and dk += dS^T Q (q unscaled; sm_scale goes on at the end)
template <int D, int kPlanes>
__device__ __forceinline__ void dkv_tile(float (&dk)[AttnBwdWg<D>::kPanels][32],
                                         float (&dv)[AttnBwdWg<D>::kPanels][32], uint32_t ks,
                                         uint32_t vs, uint32_t qs, const float* Ls,
                                         const float* Ds, const bool (&key_ok)[2], int q0, int T,
                                         float sm_scale) {
  using A = AttnBwdWg<D>;
  const int t = threadIdx.x & 3;
  const uint32_t planes = qs + A::kTileBytes;
  float s[32], dp[32];
  wgmma_fence();
  head_dim_product<D>(s, ks, qs, false);
  wgmma_commit();
  dout_product<D, false, kPlanes>(dp, vs, planes);  // waits for both
  fence_regs(s);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      const float l = Ls[c];
      const bool keep = key_ok[e >> 1] && q0 + c < T && l > kBwdNegInf / 2;
      const float p = keep ? softmax_p(s[4 * j + e], sm_scale, l) : 0.f;
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - Ds[c]);
    }
  {
    uint32_t pa[kBwdPTerms][4][4];
    acc_terms<kBwdPTerms>(s, pa);
    terms_product<D, kBwdPTerms, kBwdPTerms, kPlanes>(dv, pa, planes);
  }
  uint32_t da[kDsTerms][4][4];
  acc_terms<kDsTerms>(dp, da);
  terms_product<D, kDsTerms, kDsTerms, 1>(dk, da, qs);
}

// dk and dv for keys k0 .. k0 + 63 of one (b, h) row with `len` valid keys;
// dk = sm_scale dS^T q, dv = P^T dO
template <int D, typename Out>
__device__ __forceinline__ void attention_dkv_wg(const BwdWgRow<Out>& row, int T, int len, int k0,
                                                 float sm_scale, unsigned char* smem) {
  using A = AttnBwdWg<D>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int key = k0 + 16 * warp + (lane >> 2);  // this lane's rows: key, key + 8
  const bool key_ok[2] = {key < len, key + 8 < len};
  unsigned char* stages = smem + 2 * A::kTileBytes;
  const uint32_t ks = smem_u32(smem), vs = ks + A::kTileBytes;

  float dk[A::kPanels][32], dv[A::kPanels][32];
#pragma unroll
  for (int p = 0; p < A::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[p][i] = dv[p][i] = 0.f;

  const int n_q = (T + kBwdTileRows - 1) / kBwdTileRows;
  auto stage_query = [&](unsigned char* st, int i) {
    const int q0 = i * kBwdTileRows;
    const int n = row.nterms[i];
    stage_tile<D>(st, row.q + (long)q0 * row.ld, row.ld, T - q0, row.q);
    for (int j = 0; j < n; ++j)
      stage_tile<D>(st + (1 + j) * A::kTileBytes,
                    row.planes + j * row.plane_stride + (long)q0 * row.ld_do, row.ld_do, T - q0,
                    row.planes);
    if (tid < 2 * kBwdTileRows) {  // lse, then delta
      float* stat = reinterpret_cast<float*>(st + (1 + kDoutTerms) * A::kTileBytes);
      const int r = tid & (kBwdTileRows - 1);
      const float* src = tid < kBwdTileRows ? row.lse : row.delta;
      const bool ok = q0 + r < T;
      msfa_tc::cp_async4(stat + tid, ok ? src + (long)(q0 + r) * row.ld_stat : src, ok);
    }
  };

  if (k0 < len) {  // block-uniform: a block at or past the length writes zeros
    stage_tile<D>(smem, row.k + (long)k0 * row.ld, row.ld, T - k0, row.k);
    stage_tile<D>(smem + A::kTileBytes, row.v + (long)k0 * row.ld, row.ld, T - k0, row.v);
    stage_query(stages, 0);
    msfa_tc::cp_async_commit();
    for (int i = 0; i < n_q; ++i) {
      unsigned char* st = stages + (i & 1) * A::kQStageBytes;
      msfa_tc::cp_async_wait<0>();  // this query tile (and K, V) has landed for this thread ...
      fence_proxy_async();
      __syncthreads();  // ... for every thread; the other stage is free
      if (i + 1 < n_q) {  // the next tile's copies fly while this one is multiplied
        stage_query(stages + ((i + 1) & 1) * A::kQStageBytes, i + 1);
        msfa_tc::cp_async_commit();
      }
      const float* Ls = reinterpret_cast<const float*>(st + (1 + kDoutTerms) * A::kTileBytes);
      const uint32_t qs = smem_u32(st);
      if (row.nterms[i] == 1) {
        dkv_tile<D, 1>(dk, dv, ks, vs, qs, Ls, Ls + kBwdTileRows, key_ok, i * kBwdTileRows, T,
                       sm_scale);
      } else {
        dkv_tile<D, kDoutTerms>(dk, dv, ks, vs, qs, Ls, Ls + kBwdTileRows, key_ok,
                                i * kBwdTileRows, T, sm_scale);
      }
    }
  }
  store_rows<D>(dk, row.dk, row.ld, k0, T, sm_scale);
  store_rows<D>(dv, row.dv, row.ld, k0, T, 1.f);
}

// One key tile's products for a warpgroup's 64 queries: S = Q K^T over the
// head dim and dP = dO V^T over kPlanes planes, dS in registers (row r (e <
// 2) or r + 8, column key k0 + 8j + 2t + (e & 1)), then dq += dS K (K is the
// B operand with k, the keys, down its columns), in a fresh accumulator
template <int D, int kPlanes>
__device__ __forceinline__ void dq_tile(float (&dq)[AttnBwdWg<D>::kPanels][32], uint32_t ks,
                                        uint32_t vs, uint32_t qs, const float (&l)[2],
                                        const float (&dl)[2], const bool (&row_ok)[2], int k0,
                                        int len, float sm_scale) {
  using A = AttnBwdWg<D>;
  const int t = threadIdx.x & 3;
  float s[32], dp[32];
  wgmma_fence();
  head_dim_product<D>(s, qs, ks, false);
  wgmma_commit();
  dout_product<D, true, kPlanes>(dp, vs, qs + A::kTileBytes);
  fence_regs(s);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const bool keep = row_ok[h] && k0 + 8 * j + 2 * t + (e & 1) < len;
      const float p = keep ? softmax_p(s[4 * j + e], sm_scale, l[h]) : 0.f;
      dp[4 * j + e] = p * (dp[4 * j + e] - dl[h]);
    }
  uint32_t da[kDsTerms][4][4];
  acc_terms<kDsTerms>(dp, da);
  terms_product<D, kDsTerms, kDsTerms, 1>(dq, da, ks);
}

// dq for queries q0 .. q0 + 63 (q0 < T) of one (b, h) row with `len` valid
// keys: dq = sm_scale * (sum over the key tiles below the length, in order,
// of dS K)
template <int D, typename Out>
__device__ __forceinline__ void attention_dq_wg(const BwdWgRow<Out>& row, int T, int len, int q0,
                                                float sm_scale, unsigned char* smem) {
  using A = AttnBwdWg<D>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = row.nterms[q0 / kBwdTileRows];
  unsigned char* stages = smem + (1 + kDoutTerms) * A::kTileBytes;  // after Q and the planes
  const uint32_t qs = smem_u32(smem);

  // this lane's two query rows: their lse and delta
  float l[2], dl[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + (lane >> 2) + 8 * h;
    row_ok[h] = r < T;
    l[h] = row_ok[h] ? row.lse[(long)r * row.ld_stat] : kBwdNegInf;
    dl[h] = row_ok[h] ? row.delta[(long)r * row.ld_stat] : 0.f;
    row_ok[h] = row_ok[h] && l[h] > kBwdNegInf / 2;
  }

  float dq[A::kPanels][32];
#pragma unroll
  for (int p = 0; p < A::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[p][i] = 0.f;

  const int n_kt = (len + kBwdTileRows - 1) / kBwdTileRows;  // the key tiles below the length
  if (n_kt > 0) {  // block-uniform: a length-0 row writes zeros
    stage_tile<D>(smem, row.q + (long)q0 * row.ld, row.ld, T - q0, row.q);
    for (int j = 0; j < n; ++j)
      stage_tile<D>(smem + (1 + j) * A::kTileBytes,
                    row.planes + j * row.plane_stride + (long)q0 * row.ld_do, row.ld_do, T - q0,
                    row.planes);
    stage_tile<D>(stages, row.k, row.ld, T, row.k);
    stage_tile<D>(stages + A::kTileBytes, row.v, row.ld, T, row.v);
    msfa_tc::cp_async_commit();
    for (int kt = 0; kt < n_kt; ++kt) {
      const uint32_t ks = smem_u32(stages + 2 * A::kTileBytes * (kt & 1)), vs = ks + A::kTileBytes;
      msfa_tc::cp_async_wait<0>();  // this key tile (and Q, the planes) has landed ...
      fence_proxy_async();
      __syncthreads();  // ... for every thread; the other stage is free
      if (kt + 1 < n_kt) {
        unsigned char* next = stages + 2 * A::kTileBytes * ((kt + 1) & 1);
        const int k1 = (kt + 1) * kBwdTileRows;
        stage_tile<D>(next, row.k + (long)k1 * row.ld, row.ld, T - k1, row.k);
        stage_tile<D>(next + A::kTileBytes, row.v + (long)k1 * row.ld, row.ld, T - k1, row.v);
        msfa_tc::cp_async_commit();
      }
      if (n == 1) {
        dq_tile<D, 1>(dq, ks, vs, qs, l, dl, row_ok, kt * kBwdTileRows, len, sm_scale);
      } else {
        dq_tile<D, kDoutTerms>(dq, ks, vs, qs, l, dl, row_ok, kt * kBwdTileRows, len, sm_scale);
      }
    }
  }
  store_rows<D>(dq, row.dq, row.ld, q0, T, sm_scale);
}

}  // namespace msfa_wg
