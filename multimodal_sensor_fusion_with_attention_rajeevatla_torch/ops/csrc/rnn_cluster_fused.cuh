// The serving recurrences (grouped_lstm_fused, grouped_gru_fused, and
// grouped_lstm_forward over a precomputed projection) on a thread-block
// cluster, their products as 3xTF32 on the tensor cores, for Hopper
// (sm_90a). What bounds them and what was measured: rnn.cu's header note.
//
// rnn_cluster.cuh's forward (the LSTM training forward, lstm_train_fwd) with
// three changes; that kernel itself is left as it is, so its bits do not
// move. The helpers (local_col, peer, st_peer4, the split cluster barrier,
// the 3xTF32 fragments) are its own.
//
// One cluster of kCluster CTAs per (group, tile of 16 MT batch rows): MT
// m16 tiles per CTA, 1 or 2 (the wrapper picks the one that runs a launch
// in the fewest waves of clusters), and a warp runs kWarpTiles of them (at
// MT = 2 both, each B fragment loaded and split once for the two; one tile
// a warp on twice the warps measured the same, scripts/rnn_fused_variants.py).
// CTA `rank` owns the hidden units
// [c0, c0 + U), c0 = rank U, U = H / kCluster, and keeps two slices in
// shared memory for the whole sequence, both in local column order (four
// gate slots of each unit, local_col):
//   ws [4U][H + kPad]   W_hh's columns of its units (128 KB at H = 256)
//   wx [4U][Dp + kPad]  W_ih's columns of its units, depth D padded with
//                       zeros to Dp, a multiple of 8 (14 KB at D = 17)
// The LSTM's slots are its gates (i, f, g, o). The GRU's are (r, z, n_h,
// n_x): slot 2 holds W_hn in ws and zeros in wx, slot 3 zeros in ws and W_in
// in wx. So one lane's accumulators hold, as for the LSTM, everything its
// unit's cell needs, h W_hn apart from x W_in (b_hn sits inside the reset
// gate), at the price of a zero column in the step product (4U columns where
// 3U would do).
//
// Step t: z = h_{t-1} . ws (32-deep fresh accumulators, the chunks added in
// f32; at MT = 2 each B fragment is loaded and split once for both m tiles)
// + the x part + the bias; the cell; the new h of the CTA's units written
// into every CTA's next h buffer through distributed shared memory; one
// cluster barrier, split into arrive and wait. The x part of step t + 1,
// x_{t+1} . wx (3xTF32, K = Dp), does not depend on h: it runs between
// step t's arrive and its wait, in the time a CTA waits for its peers, and
// not on the step's chain (on the chain it cost 0.2-0.4 us a step more; by
// f32 FMAs instead of 3xTF32 it measured the same). x_t of the tile ([16 MT][Dp + kPad], 1-2 KB) is
// copied by 4-byte cp.async (a row of D floats is not 16-byte aligned)
// three steps ahead into a ring of kXStages buffers: step t's product
// window reads x_{t+1}, which the wait before step t - 1's arrive completed
// and that barrier made visible to every thread; a buffer is refilled one
// barrier after the window that read it.
//
// Biases in registers: the LSTM's b_ih + b_hh (one tensor from the
// wrapper); the GRU's b_ir + b_hr, b_iz + b_hz, b_hn and b_in apart.
// A row past its length is frozen (h and c kept); a cluster walks to the
// longest length of its rows; rows past the batch load zeros and store
// nothing; a row of length 0 returns exact zeros. Any B, T and D up to
// kFusedMaxD; 64-bit offsets; expf / tanhf, no fast math; no atomics, so a
// second launch repeats bit for bit.
//
// The x source is a template parameter. kXRaw is the above. kXProj
// (grouped_lstm_forward, the LSTM only) reads the step's x part from a
// precomputed x_proj [T, G, B, 4H] (b_ih inside) instead: no W_ih slice, no
// x ring and no x product; its bias is b_hh. Each lane loads its unit's four
// gate columns q H + j for its 2 WT rows (16 floats at WT = 2; the four lanes
// of a quad read 16 contiguous bytes of a gate and row) straight into the
// registers the x product would have filled, in the accumulator's slot
// order, one step ahead: step t + 1's loads start in step t's barrier wait
// and land before step t + 1's cell, behind the exchange and the product.
// The W_hh slice and h then take 195 KB at H 256 and 32 rows, where a ring
// of staged x_proj steps would not fit beside them. One 17 KB stage does,
// copied at the top of the step behind the product, at the price of a CTA
// barrier between the product and the cell: 9% slower at T 512, B 64 on an
// H100 80GB HBM3 (scripts/rnn_fused_variants.py).

#pragma once

#include <cuda_runtime.h>

#include "rnn_cluster.cuh"

namespace msfa_cluster {

constexpr int kXStages = 4;     // x_t buffers: staged three steps ahead
constexpr int kFusedMaxD = 64;  // input widths the serving body takes (ops/rnn.py CLUSTER_MAX_FEAT)
constexpr int kWarpTiles = 2;   // m16 tiles one warp runs; MT / kWarpTiles warps per 4 units
constexpr int kXRaw = 0;        // x source: raw x and the W_ih slice, x_t W_ih in the kernel
constexpr int kXProj = 1;       // x source: the precomputed x_proj (b_ih inside)

// the m16 tiles one warp runs at MT tiles a CTA, and the CTA's threads
__host__ __device__ constexpr int warp_tiles(int MT) { return MT < kWarpTiles ? MT : kWarpTiles; }
__host__ __device__ constexpr int fused_max_threads(int MT) {
  return kMaxThreads * MT / warp_tiles(MT);
}
inline int fused_threads(int H, int MT) { return cluster_threads(H) * MT / warp_tiles(MT); }

__host__ __device__ inline int pad8(int d) { return (d + 7) / 8 * 8; }

inline bool fused_supported(int H, int D) { return supported(H) && D > 0 && D <= kFusedMaxD; }

// the W_hh and W_ih slices, h (two buffers) and the x ring of one CTA; with
// the precomputed projection (D = 0) the W_hh slice and h alone
inline size_t fused_smem_bytes(int H, int D, int MT) {
  const size_t U = H / kCluster, ld = H + kPad, ldx = pad8(D) + kPad, rows = kTileRows * MT;
  const size_t x_side = D > 0 ? 4 * U * ldx + kXStages * rows * ldx : 0;
  return sizeof(float) * (4 * U * ld + 2 * rows * ld + x_side);
}

// one cluster of kCluster CTAs per (tile of `rows` batch rows, group)
inline void fused_cluster_config(cudaLaunchConfig_t& config, cudaLaunchAttribute (&attr)[1],
                                 size_t smem, int rows, int B, int G, int H, void* stream) {
  const int MT = rows / kTileRows;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.gridDim = dim3(kCluster, (B + rows - 1) / rows, G);
  config.blockDim = dim3(fused_threads(H, MT));
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
}

// the source gate of slot q (-1: a zero column) in W_hh and in W_ih
template <int CELL>
__device__ __forceinline__ int hh_gate(int q) {
  return CELL == msfa_rnn::kLstm ? q : (q < 3 ? q : -1);
}
template <int CELL>
__device__ __forceinline__ int ih_gate(int q) {
  return CELL == msfa_rnn::kLstm ? q : (q < 2 ? q : (q == 2 ? -1 : 2));
}

// this CTA's slice of a [depth, NG H] weight, its slots through GATE ->
// dst[local column][k] (row stride ld), zero past `depth` up to `rows` and in
// a zero column
template <int CELL, bool IH>
__device__ __forceinline__ void load_fused_slice(const float* __restrict__ w_g, float* dst,
                                                 int depth, int rows, int ld, int H, int U,
                                                 int c0) {
  constexpr int NG = CELL == msfa_rnn::kLstm ? 4 : 3;
  const int cols = 4 * U;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int k = i / cols, r = i - k * cols, q = r / U, u = r - q * U;
    const int src = IH ? ih_gate<CELL>(q) : hh_gate<CELL>(q);
    dst[local_col(q, u) * ld + k] =
        src < 0 || k >= depth ? 0.f : __ldg(w_g + (size_t)k * NG * H + src * H + c0 + u);
  }
}

// x_t of the tile's `rows` batch rows, [T, G, B, D] -> dst[row][d] (row stride
// ldx): 4-byte cp.async copies, zero-filled past the batch; one commit group
__device__ __forceinline__ void stage_x(const float* __restrict__ x, float* dst, int t, int grp,
                                        int b0, int G, int B, int D, int rows, int ldx) {
  const size_t base = ((size_t)t * G + grp) * B;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, b = b0 + r;
    cp_async4(dst + r * ldx + d, b < B ? x + (base + b) * D + d : x, b < B);
  }
  cp_async_commit();
}

// xacc = x_t . wx on n-tiles 2 wu, 2 wu + 1 for the WT m tiles from m0:
// 3xTF32, 32-deep fresh accumulators added in f32
template <int WT>
__device__ __forceinline__ void x_part(const float* xs, const float* wx, int ldx, int Dp, int wu,
                                       int m0, int gr, int tq, float (&xacc)[WT][2][4]) {
#pragma unroll
  for (int m = 0; m < WT; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) xacc[m][n][i] = 0.f;
  for (int k0 = 0; k0 < Dp; k0 += 8 * kChunkSteps) {
    const int steps = min(kChunkSteps, (Dp - k0) / 8);
    float part[WT][2][4];
    for (int s = 0; s < steps; ++s) {
      FragB b[2];
#pragma unroll
      for (int n = 0; n < 2; ++n) b[n] = load_b_rowk(wx, ldx, (2 * wu + n) * 8, k0 + 8 * s, gr, tq);
#pragma unroll
      for (int m = 0; m < WT; ++m) {
        const FragA a = load_a_rowk(xs, ldx, 16 * (m0 + m), k0 + 8 * s, gr, tq);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          if (s == 0) mma3_zero(part[m][n], a, b[n]);
          else mma3(part[m][n], a, b[n]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < WT; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) xacc[m][n][i] += part[m][n][i];
  }
}

// xacc = x_proj [T, G, B, 4H] at step t for this lane's rows gr + 8 rr + 16
// (m0 + m) of the tile from b0 and unit j, slot q at xacc[m][q / 2][2 rr +
// (q & 1)] (the accumulator's order); rows past the batch read zeros
template <int WT>
__device__ __forceinline__ void load_x_proj(const float* __restrict__ x_proj, int t, int grp,
                                            int b0, int m0, int gr, int j, int G, int B, int H,
                                            float (&xacc)[WT][2][4]) {
  const size_t base = ((size_t)t * G + grp) * B;
#pragma unroll
  for (int m = 0; m < WT; ++m)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int b = b0 + 16 * (m0 + m) + 8 * rr + gr;
      const float* row = x_proj + (base + min(b, B - 1)) * 4 * H + j;  // in bounds: no branch
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = __ldg(row + q * H);
        xacc[m][q / 2][2 * rr + (q & 1)] = b < B ? v : 0.f;
      }
    }
}

// kXRaw: x [T, G, B, D], w_ih [G, D, NG H], w_hh [G, H, NG H]; LSTM: bias_a =
// b_ih + b_hh [G, 4H], bias_b unused; GRU: bias_a = b_ih, bias_b = b_hh [G,
// 3H]. kXProj (LSTM): x = x_proj [T, G, B, 4H], w_ih unused, bias_a = b_hh,
// D = 0 -> out h_T [G, B, H]. Grid (kCluster, tiles of 16 MT rows, G),
// clusters of kCluster along x; fused_threads(H, MT) threads: warp w runs
// the units 4 wu .. 4 wu + 3 (wu = w % (U / 4)) of the WT m tiles from m0 =
// WT (w / (U / 4)).
template <int CELL, int MT, int XSRC = kXRaw>
__device__ __forceinline__ void fused_cluster_body(
    const float* __restrict__ x, const float* __restrict__ w_ih, const float* __restrict__ w_hh,
    const float* __restrict__ bias_a, const float* __restrict__ bias_b,
    const int* __restrict__ lengths, float* __restrict__ out, int T, int G, int B, int D, int H) {
  constexpr int NG = CELL == msfa_rnn::kLstm ? 4 : 3;
  constexpr int kRows = kTileRows * MT, WT = warp_tiles(MT);
  static_assert(XSRC == kXRaw || CELL == msfa_rnn::kLstm, "x_proj is read by the LSTM only");
  extern __shared__ float4 smem4[];
  const int U = H / kCluster, ld = H + kPad, Dp = pad8(D), ldx = Dp + kPad, cols = NG * H;
  float* ws = reinterpret_cast<float*>(smem4);  // [4U][ld] the W_hh slice
  float* h_s = ws + 4 * U * ld;                 // [2][kRows][ld] h_{t-1}, h_t
  float* wx = h_s + 2 * kRows * ld;             // [4U][ldx] the W_ih slice (kXRaw)
  float* x_s = wx + 4 * U * ldx;                // [kXStages][kRows][ldx] x_t (kXRaw)
  const int sx = kRows * ldx;
  __shared__ int len_s[kRows];

  const int rank = cluster_rank(), grp = blockIdx.z, b0 = blockIdx.y * kRows;
  const int c0 = rank * U, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wu = warp % (U / 4), m0 = WT * (warp / (U / 4));
  const int gr = lane / 4, tq = lane % 4, j = c0 + 4 * wu + tq;  // rows gr + 8 rr + 16 m; unit j
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    const int b = b0 + r;
    len_s[r] = b < B ? min(max(lengths[b], 0), T) : 0;
  }
  load_fused_slice<CELL, false>(w_hh + (size_t)grp * H * cols, ws, H, H, ld, H, U, c0);
  if constexpr (XSRC == kXRaw)
    load_fused_slice<CELL, true>(w_ih + (size_t)grp * D * cols, wx, D, Dp, ldx, H, U, c0);
  for (int i = threadIdx.x; i < kRows * ld; i += blockDim.x) h_s[i] = 0.f;  // h_0
  if constexpr (XSRC == kXRaw) {
    // the x buffers' columns past D, which no copy writes
    for (int i = threadIdx.x; i < kXStages * kRows * (ldx - D); i += blockDim.x) {
      const int r = i / (ldx - D);
      x_s[r * ldx + D + (i - r * (ldx - D))] = 0.f;
    }
  }
  __syncthreads();
  int t_end = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) t_end = max(t_end, len_s[r]);
  int len[WT][2];
#pragma unroll
  for (int m = 0; m < WT; ++m)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) len[m][rr] = len_s[16 * (m0 + m) + 8 * rr + gr];
  float bias[4];
  if constexpr (CELL == msfa_rnn::kLstm) {
#pragma unroll
    for (int q = 0; q < 4; ++q) bias[q] = __ldg(bias_a + (size_t)grp * cols + q * H + j);
  } else {  // r and z take both biases; b_hn stays inside the reset gate
    const float* bi = bias_a + (size_t)grp * cols + j;
    const float* bh = bias_b + (size_t)grp * cols + j;
    bias[0] = __ldg(bi) + __ldg(bh);
    bias[1] = __ldg(bi + H) + __ldg(bh + H);
    bias[2] = __ldg(bh + 2 * H);
    bias[3] = __ldg(bi + 2 * H);
  }
  if constexpr (XSRC == kXRaw) {
    for (int s = 0; s < kXStages - 1; ++s) {  // x_0, x_1, x_2 in flight
      if (s < t_end) stage_x(x, x_s + s * sx, s, grp, b0, G, B, D, kRows, ldx);
      else cp_async_commit();
    }
    cp_async_wait<kXStages - 3>();  // x_0's and x_1's
  }
  cluster_arrive();  // every CTA of the cluster runs and holds h_0 before any peer writes
  cluster_wait();

  float xacc[WT][2][4], h[WT][2] = {}, c[WT][2] = {};
  if (t_end > 0) {
    if constexpr (XSRC == kXRaw) x_part<WT>(x_s, wx, ldx, Dp, wu, m0, gr, tq, xacc);
    else load_x_proj<WT>(x, 0, grp, b0, m0, gr, j, G, B, H, xacc);
  }
  for (int t = 0; t < t_end; ++t) {
    const float* h_cur = h_s + (t & 1) * kRows * ld;
    float* h_nxt = h_s + ((t + 1) & 1) * kRows * ld;
    if constexpr (XSRC == kXRaw) {
      if (t + kXStages - 1 < t_end)  // into the buffer step t - 2's window read
        stage_x(x, x_s + (t + kXStages - 1) % kXStages * sx, t + kXStages - 1, grp, b0, G, B, D,
                kRows, ldx);
      else
        cp_async_commit();
    }
    // z = h_{t-1} . ws on n-tiles 2 wu, 2 wu + 1
    float acc[WT][2][4] = {};
#pragma unroll 2  // independent chunks in flight
    for (int k0 = 0; k0 < H; k0 += 8 * kChunkSteps) {
      float part[WT][2][4];
#pragma unroll
      for (int s = 0; s < kChunkSteps; ++s) {
        FragB b[2];
#pragma unroll
        for (int n = 0; n < 2; ++n) b[n] = load_b_rowk(ws, ld, (2 * wu + n) * 8, k0 + 8 * s, gr, tq);
#pragma unroll
        for (int m = 0; m < WT; ++m) {
          const FragA a = load_a_rowk(h_cur, ld, 16 * (m0 + m), k0 + 8 * s, gr, tq);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            if (s == 0) mma3_zero(part[m][n], a, b[n]);
            else mma3(part[m][n], a, b[n]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < WT; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][n][i] += part[m][n][i];
    }
    // the cell of unit j for rows gr + 8 rr + 16 (m0 + m): acc[m][0] holds
    // slots 0, 1 and acc[m][1] slots 2, 3, at (2 rr, 2 rr + 1)
    float h_new[WT][2];
#pragma unroll
    for (int m = 0; m < WT; ++m) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float z[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int at = 2 * rr + (q & 1);
          z[q] = acc[m][q / 2][at] + xacc[m][q / 2][at] + bias[q];
        }
        const bool valid = t < len[m][rr];
        if constexpr (CELL == msfa_rnn::kLstm) {
          const float cn = sigmoid(z[1]) * c[m][rr] + sigmoid(z[0]) * tanhf(z[2]);
          const float hn = sigmoid(z[3]) * tanhf(cn);
          h_new[m][rr] = valid ? hn : h[m][rr];
          c[m][rr] = valid ? cn : c[m][rr];
        } else {  // z[2] = h W_hn + b_hn, z[3] = x W_in + b_in
          const float r = sigmoid(z[0]), u = sigmoid(z[1]);
          const float n = tanhf(z[3] + r * z[2]);
          const float hn = (1.f - u) * n + u * h[m][rr];
          h_new[m][rr] = valid ? hn : h[m][rr];
        }
      }
    }
    // h_t of this lane's rows, units 4 wu .. 4 wu + 3 -> every CTA's next
    // buffer: the quad gathers its four units, lane tq sends to ranks tq,
    // tq + 4, ...
    float v[WT][2][4];
#pragma unroll
    for (int m = 0; m < WT; ++m)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[m][rr][i] = __shfl_sync(0xffffffffu, h_new[m][rr], (lane & ~3) + i);
#pragma unroll
    for (int i = 0; i < kCluster / 4; ++i)
#pragma unroll
      for (int m = 0; m < WT; ++m)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          st_peer4(peer(h_nxt + (16 * (m0 + m) + 8 * rr + gr) * ld + c0 + 4 * wu, tq + 4 * i),
                   v[m][rr][0], v[m][rr][1], v[m][rr][2], v[m][rr][3]);
    if constexpr (XSRC == kXRaw) cp_async_wait<kXStages - 3>();  // this thread's x_{t+2}
    cluster_arrive();  // (the barrier also makes every thread's copies visible)
#pragma unroll
    for (int m = 0; m < WT; ++m)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) h[m][rr] = h_new[m][rr];
    // the x part of step t + 1 while the peers finish their step (x_proj:
    // its loads, which land behind the exchange and the next product)
    if (t + 1 < t_end) {
      if constexpr (XSRC == kXRaw)
        x_part<WT>(x_s + (t + 1) % kXStages * sx, wx, ldx, Dp, wu, m0, gr, tq, xacc);
      else
        load_x_proj<WT>(x, t + 1, grp, b0, m0, gr, j, G, B, H, xacc);
    }
    cluster_wait();  // h_t in place in every CTA
  }
#pragma unroll
  for (int m = 0; m < WT; ++m)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int b = b0 + 16 * (m0 + m) + 8 * rr + gr;
      if (b < B) out[((size_t)grp * B + b) * H + j] = h[m][rr];
    }
}

}  // namespace msfa_cluster
