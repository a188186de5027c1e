// One 64-query tile of softmax attention on the TF32 tensor cores at f32
// accuracy (3xTF32, tf32_mma.cuh), for Hopper (sm_90a). The body of
// flash_fwd_single_kernel (flash_attention.cu, the [B*H, T, D] layout) and of
// packed_attention_fwd_kernel (packed_attention.cu, the packed [B, T, 3F]
// layout): each is a thin __global__ entry point that finds its (b, h) row's
// strided views and calls attention_fwd_tile.
//
// For query rows q0 .. q0 + 63 of one (b, h) row, with `len` valid keys:
//   s    = (q * sm_scale) k^T            key columns >= len masked
//   out  = softmax(s) v
//   lse  = rowmax(s) + log(rowsum(exp))
// Query rows are not masked. With no valid key a row gets exact zeros in out
// and -1e30 in lse. Any T; rows past T are neither read nor written.
//
// Design: an online softmax over 64-key tiles with one rescale per tile, in
// registers. 4 warps, warp w owning query rows q0 + 16w .. q0 + 16w + 15 and
// all D output columns; q is scaled once and held in registers; K and V tiles
// arrive by cp.async into a two-stage ring (the next tile's copies fly while
// this one is multiplied), read straight from the strided rows; P goes from
// the score accumulators to the P.V operand without leaving registers. Key
// tiles at or past the length are skipped, so every processed tile holds a
// valid key and the running max is finite after the first. 68 KB of shared
// memory at D = 64; registers hold an SM to two blocks. f32 operands only:
// the packed forward's bf16 entry runs its own tile on wgmma (wgmma_bf16.cuh).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace msfa_tc {

constexpr int kFwdTileQ = 64;     // query rows per block: 4 warps x 16
constexpr int kFwdTileK = 64;     // keys per staged tile
constexpr int kFwdThreads = 128;
constexpr float kFwdNegInf = -1e30f;

template <int D>
constexpr size_t fwd_smem_bytes() {
  // two stages x (K tile, V tile), each [kFwdTileK][D + kPad]
  return sizeof(float) * 2 * 2 * kFwdTileK * (D + kPad);
}

// One (b, h) row's strided views: row t of q, k, v at q/k/v + t * ld_in, of
// out at out + t * ld_out, its lse at lse + t * ld_lse.
struct FwdRow {
  const float* q;
  const float* k;
  const float* v;
  long ld_in;
  float* out;
  long ld_out;
  float* lse;
  long ld_lse;
};

template <int D>
__device__ __forceinline__ void attention_fwd_tile(const FwdRow& row, int T, int len, int q0,
                                                   float sm_scale, float* smem) {
  constexpr int kSteps = D / 8;  // k-steps of Q.K^T, output column tiles of P.V
  constexpr int kLd = D + kPad;
  constexpr int kTileFloats = kFwdTileK * kLd;
  const long ld = row.ld_in;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (len + kFwdTileK - 1) / kFwdTileK;  // tiles at or past the length: skipped

  if (n_tiles > 0) {  // the first K and V tiles fly while Q is read
    stage_rows<D>(smem, row.k, ld, kFwdTileK, T, row.k, tid, kFwdThreads);
    cp_async_commit();
    stage_rows<D>(smem + kTileFloats, row.v, ld, kFwdTileK, T, row.v, tid, kFwdThreads);
    cp_async_commit();
  }

  // this warp's 16 query rows, scaled, as A fragments (k along the row)
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float* qa = row.q + (long)row0 * ld;
  const float* qb = qa + 8 * ld;
  float qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int c = 8 * kk + t;
    qf[kk][0] = row0 < T ? qa[c] * sm_scale : 0.f;
    qf[kk][1] = row1 < T ? qb[c] * sm_scale : 0.f;
    qf[kk][2] = row0 < T ? qa[c + 4] * sm_scale : 0.f;
    qf[kk][3] = row1 < T ? qb[c + 4] * sm_scale : 0.f;
  }

  // running max and sum of rows g (index 0) and g + 8 (index 1); each lane
  // sums its own columns, the quad's four lanes are added at the end
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[kSteps][4];
#pragma unroll
  for (int nd = 0; nd < kSteps; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const float* Ks = smem + (kt & 1) * 2 * kTileFloats;
    const float* Vs = Ks + kTileFloats;
    cp_async_wait<1>();  // in flight: K[kt], V[kt] -> K[kt] has landed
    __syncthreads();     // ... for every thread; and tile kt-1's stage is free
    if (kt + 1 < n_tiles) {
      float* next = smem + ((kt + 1) & 1) * 2 * kTileFloats;
      const int k1 = (kt + 1) * kFwdTileK;
      stage_rows<D>(next, row.k + (long)k1 * ld, ld, kFwdTileK, T - k1, row.k, tid, kFwdThreads);
      cp_async_commit();
      stage_rows<D>(next + kTileFloats, row.v + (long)k1 * ld, ld, kFwdTileK, T - k1, row.v, tid,
                    kFwdThreads);
      cp_async_commit();
    }

    // S = (q * scale) K^T: 16 rows x 64 keys per warp, 8 column tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const FragA a = split_a(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma3(s[j], a, load_b_rowk(Ks, kLd, 8 * j, 8 * kk, g, t));
    }

    // online softmax: one rescale per tile; the tile holds a valid key, so the new max is finite
    const int k0 = kt * kFwdTileK;
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + 8 * j + 2 * t + (e & 1) >= len) s[j][e] = -INFINITY;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[j][e]);
      }
    float rescale[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = tile_max[r];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      rescale[r] = expf(m[r] - m_new);  // 0 on the first tile
      m[r] = m_new;
      l[r] *= rescale[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);  // masked: exp(-inf) = 0
        s[j][e] = p;
        l[e >> 1] += p;
      }

    if (kt + 1 < n_tiles) {
      cp_async_wait<2>();  // in flight: V[kt], K[kt+1], V[kt+1] -> V[kt] has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // O = O * rescale + P V: P straight from the score accumulators, V k down
    // the column. Each two 8-key steps' products go into a fresh accumulator
    // that is then added to O in FP32: the tensor core cuts the sums it
    // accumulates toward zero, and over a whole row of keys those cuts add up
    // (out off by ~5e-6 at T = 1024 with O accumulated in it, enough to move
    // gradients that rest on the softmax's cancelling rows), where the FP32
    // add rounds to nearest.
#pragma unroll
    for (int nd = 0; nd < kSteps; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= rescale[e >> 1];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const FragA a0 = acc_as_a(s[j]);
      const FragA a1 = acc_as_a(s[j + 1]);
#pragma unroll
      for (int nd = 0; nd < kSteps; ++nd) {
        float part[4];
        mma3_zero(part, a0, load_b_colk(Vs, kLd, 8 * j, 8 * nd, g, t));
        mma3(part, a1, load_b_colk(Vs, kLd, 8 * j + 8, 8 * nd, g, t));
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nd][e] += part[e];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int q = r == 0 ? row0 : row1;
    if (q >= T) continue;
    const bool any = l[r] > 0.f;  // no valid key: exact zeros, lse = -1e30
    const float inv = any ? 1.f / l[r] : 0.f;
    float* orow = row.out + (long)q * row.ld_out;
#pragma unroll
    for (int nd = 0; nd < kSteps; ++nd) {
      const float2 val = any ? make_float2(o[nd][2 * r] * inv, o[nd][2 * r + 1] * inv)
                             : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(orow + 8 * nd + 2 * t) = val;
    }
    if (t == 0) row.lse[(long)q * row.ld_lse] = any ? m[r] + logf(l[r]) : kFwdNegInf;
  }
}

}  // namespace msfa_tc
