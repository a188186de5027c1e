// One 64-key tile of the softmax-attention backward on the TF32 tensor cores
// at f32 accuracy (3xTF32, tf32_mma.cuh), for Hopper (sm_90a), the ordered
// sum of its dq partials, and one 64-query tile of dq alone. The body of
// bwd_kernel (packed_attention_bwd.cu, the packed [B, T, 3F] layout) and of
// flash_bwd_fused_kernel and flash_dkv_kernel (flash_attention_bwd.cu, the
// [B*H, T, D] layout): each is a thin __global__ entry point that finds its
// (b, h) row's strided views and calls attention_bwd_tile (the dkv entry
// with kWithDq = false); likewise dq_reduce_kernel and
// flash_bwd_fused_dq_reduce call dq_reduce, and flash_dq_kernel calls
// attention_dq_tile.
//
// For keys k0 .. k0 + 63 of one (b, h) row with `len` valid keys, from the
// forward's lse, delta = rowsum(dout * out) and the cotangent dout:
//   p  = exp((q * sm_scale) k^T - lse)     key columns >= len -> 0,
//                                          rows with lse = -1e30 -> 0
//   ds = p * (dout v^T - delta)
//   dv = p^T dout,  dk = ds^T (q * sm_scale)       for the tile's keys
//   dq_part = ds k                                 over the tile's keys, every query
// and dq = sm_scale * (sum of the partials of the tiles below len, in key-tile
// order). These are the TPU kernels' five products, each taken once. Query
// rows are not masked; a tile at or past the length writes exact-zero dk and
// dv and no partial (dq_reduce never reads it), so a length-0 row gets three
// exact zeros and evaluates no exp. Any T: rows past T are zero-filled when
// staged and never written.
//
// Design: K and V of the tile stay in shared memory while the block (4 warps)
// walks the 64-row query tiles, which arrive by cp.async (q, dout, lse,
// delta) into a two-stage ring, read straight from the strided rows. Warp w
// owns keys k0 + 16w .. k0 + 16w + 15 and computes S^T = K q^T and dP^T =
// V dout^T, then P^T and dS^T in registers, and dv += P^T dout, dk += dS^T q
// from those registers (the accumulator is the next product's A operand).
// Each query tile's dv and dk products go into a fresh accumulator that is
// then added in FP32: the tensor core cuts the sums it accumulates toward
// zero, and over 16 query tiles (T = 1024) those cuts add up, where the FP32
// add rounds to nearest. dS^T goes to shared memory once (over the q rows
// the tile has used), where warp w reads it back as the rows of its 16
// queries for dq_part = dS K over the tile's 64 keys. With kWithDq = false
// (the split route's dk/dv) that store, its two barriers and the dq_part
// product are compiled out; dk and dv are the same instructions, so the
// same bits. No atomics: a run repeats bit for bit. 105 KB of shared memory
// per block at D = 64, so two blocks fit on an SM.
//
// attention_dq_tile (the split route's dq): the mirror image for one 64-row
// query tile. q, dout, lse and delta are staged once; K and V of the key
// tiles below the length arrive by cp.async, one tile at a time. Warp
// w owns queries q0 + 16w .. q0 + 16w + 15 and computes S = q K^T and dP =
// dout V^T, P and dS in registers, and dq += dS K with the dS accumulator
// as the A operand, so dS never goes through shared memory. Each key tile's
// product goes into a fresh accumulator added to dq in FP32, in key-tile
// order, and sm_scale goes on last: dq_reduce's order. One stage: 70 KB of
// shared memory at D = 64, so three blocks fit on an SM and the other
// blocks' products cover each block's copies; a two-stage ring (105 KB, two
// blocks) gave the same bits 5-6% slower on the H100. 136 KB at D = 128.
//
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace msfa_tc {

constexpr int kBwdTile = 64;      // keys per block, query rows per staged tile
constexpr int kBwdThreads = 128;  // 4 warps x 16 keys (dk, dv) or 16 queries (dq)
constexpr float kBwdNegInf = -1e30f;

// Shared layout, in floats: Ks, Vs [kBwdTile][D + kPad]; then per stage a q
// slot (q rows, later dS^T at stride kBwdTile + kPad, so it is sized for the
// larger), dout [kBwdTile][D + kPad], lse [kBwdTile], delta [kBwdTile].
template <int D>
struct BwdLayout {
  static constexpr int kLd = D + kPad;  // floats of a q, k, v or dout row
  static constexpr int kLdS = kBwdTile + kPad;
  static constexpr int kKV = kBwdTile * kLd;  // one K or V tile
  static constexpr int kDout = kBwdTile * kLd;
  static constexpr int kQSlot = kKV > kBwdTile * kLdS ? kKV : kBwdTile * kLdS;
  static constexpr int kStage = kQSlot + kDout + 2 * kBwdTile;
  static constexpr size_t kBytes = sizeof(float) * (2 * kKV + 2 * kStage);
};

// One (b, h) row's strided views: row t of q, k, v at q/k/v + t * ld_in, of
// dout at dout + t * ld_dout, its lse and delta at lse/delta + t * ld_stat,
// dk and dv rows at dk/dv + t * ld_dkv, and this key tile's dq partial row
// at dq_part + t * ld_part.
struct BwdRow {
  const float* q;
  const float* k;
  const float* v;
  long ld_in;
  const float* dout;
  long ld_dout;
  const float* lse;
  const float* delta;
  long ld_stat;
  float* dk;
  float* dv;
  long ld_dkv;
  float* dq_part;
  long ld_part;
};

// One query tile's q, dout, lse, delta into a stage; rows past T are zeros.
template <int D>
__device__ __forceinline__ void stage_query_tile(float* stage, const BwdRow& row, int q0, int T,
                                                 int tid) {
  using L = BwdLayout<D>;
  stage_rows<D>(stage, row.q + (long)q0 * row.ld_in, row.ld_in, kBwdTile, T - q0, row.q, tid,
                kBwdThreads);
  stage_rows<D>(stage + L::kQSlot, row.dout + (long)q0 * row.ld_dout, row.ld_dout, kBwdTile,
                T - q0, row.dout, tid, kBwdThreads);
  float* Ls = stage + L::kQSlot + L::kDout;
  const int r = tid & (kBwdTile - 1);
  const float* src = tid < kBwdTile ? row.lse : row.delta;
  const bool ok = q0 + r < T;
  cp_async4(Ls + (tid < kBwdTile ? 0 : kBwdTile) + r, ok ? src + (long)(q0 + r) * row.ld_stat : src,
            ok);
}

// The rows of key tile k0; rows past T are zeros.
template <int D>
__device__ __forceinline__ void stage_key_tile(float* Ks, float* Vs, const BwdRow& row, int k0,
                                               int T, int tid) {
  stage_rows<D>(Ks, row.k + (long)k0 * row.ld_in, row.ld_in, kBwdTile, T - k0, row.k, tid,
                kBwdThreads);
  stage_rows<D>(Vs, row.v + (long)k0 * row.ld_in, row.ld_in, kBwdTile, T - k0, row.v, tid,
                kBwdThreads);
}

template <int D, bool kWithDq = true>
__device__ __forceinline__ void attention_bwd_tile(const BwdRow& row, int T, int len, int k0,
                                                   float sm_scale, float* smem) {
  using L = BwdLayout<D>;
  constexpr int kSteps = D / 8;
  constexpr int kLd = L::kLd, kLdS = L::kLdS;
  float* Ks = smem;
  float* Vs = smem + L::kKV;
  float* stages = smem + 2 * L::kKV;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;  // this lane's two key rows

  float dk[kSteps][4], dv[kSteps][4];
#pragma unroll
  for (int nd = 0; nd < kSteps; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  if (k0 < len) {  // block-uniform: a tile at or past the length writes zeros
    stage_key_tile<D>(Ks, Vs, row, k0, T, tid);
    stage_query_tile<D>(stages, row, 0, T, tid);
    cp_async_commit();
    const int n_q = (T + kBwdTile - 1) / kBwdTile;
    const bool key_ok[2] = {key0 < len, key1 < len};
    for (int i = 0; i < n_q; ++i) {
      const int q0 = i * kBwdTile;
      float* Qslot = stages + (i & 1) * L::kStage;
      const float* Qs = Qslot;
      const float* dOs = Qslot + L::kQSlot;
      const float* Ls = dOs + L::kDout;
      const float* Ds = Ls + kBwdTile;
      cp_async_wait<0>();  // this tile (and, at i = 0, K and V) has landed
      __syncthreads();     // ... for every thread; the other stage is free
      if (i + 1 < n_q) {
        stage_query_tile<D>(stages + ((i + 1) & 1) * L::kStage, row, q0 + kBwdTile, T, tid);
        cp_async_commit();
      }

      // S^T = K q^T and dP^T = V dout^T: 16 keys x 64 queries per warp
      float st[8][4], dpt[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const FragA ak = load_a_rowk(Ks, kLd, warp * 16, 8 * kk, g, t);
        const FragA av = load_a_rowk(Vs, kLd, warp * 16, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mma3(st[j], ak, load_b_rowk(Qs, kLd, 8 * j, 8 * kk, g, t));
          mma3(dpt[j], av, load_b_rowk(dOs, kLd, 8 * j, 8 * kk, g, t));
        }
      }

      // P^T and dS^T in place: row key0 (e < 2) or key1, column query 8j + 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const float l = Ls[c];
          const bool keep = key_ok[e >> 1] && q0 + c < T && l > kBwdNegInf / 2;
          const float p = keep ? expf(st[j][e] * sm_scale - l) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - Ds[c]);
        }

      // dv += P^T dout, then dk += dS^T q (q unscaled; sm_scale goes on at
      // the end), each tile's products in a fresh accumulator added in FP32
      float part[kSteps][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const FragA ap = acc_as_a(st[j]);
#pragma unroll
        for (int nd = 0; nd < kSteps; ++nd) {
          const FragB b = load_b_colk(dOs, kLd, 8 * j, 8 * nd, g, t);
          if (j == 0) {
            mma3_zero(part[nd], ap, b);
          } else {
            mma3(part[nd], ap, b);
          }
        }
      }
#pragma unroll
      for (int nd = 0; nd < kSteps; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[nd][e] += part[nd][e];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const FragA ad = acc_as_a(dpt[j]);
#pragma unroll
        for (int nd = 0; nd < kSteps; ++nd) {
          const FragB b = load_b_colk(Qs, kLd, 8 * j, 8 * nd, g, t);
          if (j == 0) {
            mma3_zero(part[nd], ad, b);
          } else {
            mma3(part[nd], ad, b);
          }
        }
      }
#pragma unroll
      for (int nd = 0; nd < kSteps; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[nd][e] += part[nd][e];

      if constexpr (kWithDq) {
        __syncthreads();  // every warp is done with this stage's q rows
        float* dSs = Qslot;  // dS^T [key][query] over the q slot
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* at = dSs + (warp * 16 + g) * kLdS + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(at) = make_float2(dpt[j][0], dpt[j][1]);
          *reinterpret_cast<float2*>(at + 8 * kLdS) = make_float2(dpt[j][2], dpt[j][3]);
        }
        __syncthreads();

        // dq_part = dS K for queries q0 + 16w .. q0 + 16w + 15 over the tile's keys
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const FragA a = load_a_colk(dSs, kLdS, warp * 16, 8 * kk, g, t);
#pragma unroll
          for (int nd = 0; nd < kSteps; ++nd) {
            const FragB b = load_b_colk(Ks, kLd, 8 * kk, 8 * nd, g, t);
            if (kk == 0) {
              mma3_zero(part[nd], a, b);
            } else {
              mma3(part[nd], a, b);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = q0 + warp * 16 + g + 8 * r;
          if (q >= T) continue;
          float* dst = row.dq_part + (long)q * row.ld_part + 2 * t;
#pragma unroll
          for (int nd = 0; nd < kSteps; ++nd)
            *reinterpret_cast<float2*>(dst + 8 * nd) =
                make_float2(part[nd][2 * r], part[nd][2 * r + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r == 0 ? key0 : key1;
    if (key >= T) continue;
    const long at = (long)key * row.ld_dkv + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kSteps; ++nd) {
      store2(row.dk + at + 8 * nd, dk[nd][2 * r] * sm_scale, dk[nd][2 * r + 1] * sm_scale);
      store2(row.dv + at + 8 * nd, dv[nd][2 * r], dv[nd][2 * r + 1]);
    }
  }
}

// attention_dq_tile's shared layout in floats: one BwdLayout stage for the
// query tile (q, dout, lse, delta, as stage_query_tile writes it), then one
// key tile, Ks, Vs [kBwdTile][D + kPad].
template <int D>
struct DqLayout {
  static constexpr size_t kBytes =
      sizeof(float) * (BwdLayout<D>::kStage + 2 * BwdLayout<D>::kKV);
};

// dq of queries q0 .. q0 + 63 of one (b, h) row with `len` valid keys: the
// split route's dq, written at dq + t * ld_dq for t < T.
template <int D>
__device__ __forceinline__ void attention_dq_tile(const BwdRow& row, float* dq, long ld_dq,
                                                  int T, int len, int q0, float sm_scale,
                                                  float* smem) {
  using L = BwdLayout<D>;
  constexpr int kSteps = D / 8;
  constexpr int kLd = L::kLd;
  const float* Qs = smem;
  const float* dOs = Qs + L::kQSlot;
  const float* Ls = dOs + L::kDout;
  const float* Ds = Ls + kBwdTile;
  float* Ks = smem + L::kStage;
  float* Vs = Ks + L::kKV;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this lane's two query rows of the tile: r0, r0 + 8

  float acc[kSteps][4];
#pragma unroll
  for (int nd = 0; nd < kSteps; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int n_kt = (len + kBwdTile - 1) / kBwdTile;  // the key tiles below the length
  if (n_kt > 0) {  // block-uniform: a length-0 row writes zeros
    stage_query_tile<D>(smem, row, q0, T, tid);
    stage_key_tile<D>(Ks, Vs, row, 0, T, tid);
    cp_async_commit();
    for (int kt = 0; kt < n_kt; ++kt) {
      const int k0 = kt * kBwdTile;
      cp_async_wait<0>();  // this key tile (and, at kt = 0, the query tile) has landed
      __syncthreads();     // ... for every thread

      // S = q K^T and dP = dout V^T: 16 queries x 64 keys per warp
      float s[8][4], ds[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = ds[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const FragA aq = load_a_rowk(Qs, kLd, warp * 16, 8 * kk, g, t);
        const FragA ao = load_a_rowk(dOs, kLd, warp * 16, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mma3(s[j], aq, load_b_rowk(Ks, kLd, 8 * j, 8 * kk, g, t));
          mma3(ds[j], ao, load_b_rowk(Vs, kLd, 8 * j, 8 * kk, g, t));
        }
      }

      // P and dS in place: row r0 (e < 2) or r0 + 8, column key k0 + 8j + 2t + (e & 1)
      float l[2], dl[2];
      bool row_ok[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = Ls[r0 + 8 * r];
        dl[r] = Ds[r0 + 8 * r];
        row_ok[r] = q0 + r0 + 8 * r < T && l[r] > kBwdNegInf / 2;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool keep = row_ok[r] && k0 + 8 * j + 2 * t + (e & 1) < len;
          const float p = keep ? expf(s[j][e] * sm_scale - l[r]) : 0.f;
          ds[j][e] = p * (ds[j][e] - dl[r]);
        }

      // dq += dS K (sm_scale goes on at the end), the tile's product in a
      // fresh accumulator added in FP32
      float part[kSteps][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const FragA a = acc_as_a(ds[j]);
#pragma unroll
        for (int nd = 0; nd < kSteps; ++nd) {
          const FragB b = load_b_colk(Ks, kLd, 8 * j, 8 * nd, g, t);
          if (j == 0) {
            mma3_zero(part[nd], a, b);
          } else {
            mma3(part[nd], a, b);
          }
        }
      }
#pragma unroll
      for (int nd = 0; nd < kSteps; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] += part[nd][e];
      if (kt + 1 < n_kt) {
        __syncthreads();  // every warp is done with this key tile
        stage_key_tile<D>(Ks, Vs, row, k0 + kBwdTile, T, tid);
        cp_async_commit();
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + r0 + 8 * r;
    if (q >= T) continue;
    float* dst = dq + (long)q * ld_dq + 2 * t;
#pragma unroll
    for (int nd = 0; nd < kSteps; ++nd)
      *reinterpret_cast<float2*>(dst + 8 * nd) =
          make_float2(acc[nd][2 * r] * sm_scale, acc[nd][2 * r + 1] * sm_scale);
  }
}

// Four floats of dq, at flat index e = 4 * quad of the partials' [groups, T,
// W] view (a group is one batch row b of width W = F on the packed layout, or
// one row bh of width D): sm_scale * the sum over key tiles kt < ceil(len /
// 64) of dq_part[group, kt, t, f], in order, where len = lengths[group /
// len_div]; written at out + (group * T + t) * ld_out + f.
__device__ __forceinline__ void dq_reduce(const float* __restrict__ dq_part,
                                          const int* __restrict__ lengths, float* __restrict__ out,
                                          int T, int W, int n_kt, int len_div, long ld_out,
                                          float sm_scale, long quad) {
  const long per_group = (long)T * W;
  const long e = quad * 4;
  const long group = e / per_group;
  const long within = e - group * per_group;  // t * W + f
  int len = lengths[group / len_div];
  len = len < 0 ? 0 : (len > T ? T : len);
  const int n = (len + kBwdTile - 1) / kBwdTile;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* src = dq_part + group * n_kt * per_group + within;
  for (int kt = 0; kt < n; ++kt) {
    const float4 x = *reinterpret_cast<const float4*>(src + kt * per_group);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const long t = within / W, f = within % W;
  store4(out + (group * T + t) * ld_out + f,
         make_float4(acc.x * sm_scale, acc.y * sm_scale, acc.z * sm_scale, acc.w * sm_scale));
}

}  // namespace msfa_tc
