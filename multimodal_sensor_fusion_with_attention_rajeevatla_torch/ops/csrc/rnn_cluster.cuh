// The training recurrences (lstm_train_fwd / lstm_train_bwd, gru_train_fwd /
// gru_train_bwd) on a thread-block cluster, their step products as 3xTF32 on
// the tensor cores, for Hopper (sm_90a): one body per direction, templated on
// the cell. What bounds them and what was measured: rnn_train.cu's header
// note.
//
// One cluster of kCluster CTAs per (group, tile of kTileRows batch rows): the
// tile is the m = 16 of one mma.sync m16n8k8. CTA `rank` owns the hidden
// units [c0, c0 + U), c0 = rank U, U = H / kCluster, and four gate slots of
// each, taken from W_hh's columns q H + c0 + u: the LSTM's gates (i, f, g, o);
// the GRU's (r, z, n, a zero column), the GRU's slot map of
// rnn_cluster_fused.cuh with its x slot empty (x_proj holds x W_in apart).
// That slice, [H, 4U] (128 KB at H = 256), is read from device memory once
// per launch and kept in shared memory for the whole sequence, transposed to
// [4U][H] (local column n, depth k, row stride H + kPad), and both directions
// read it:
//   forward   z[16, 4U] = h_{t-1}[16, H] . slice     (B operand: k along a row)
//   backward  P[16, H]  = dz[16, 4U] . slice^T       (B operand: k down a column)
// Local columns are ordered so that one lane's accumulator holds the four
// slots of one unit for its two rows: warp w owns local units 4w .. 4w + 3
// and the n-tiles 2w (slots 0, 1) and 2w + 1 (slots 2, 3), and in each tile
// columns 2t and 2t + 1 are slots 2 (tile % 2) and 2 (tile % 2) + 1 of unit
// 4w + t. Lane (g, t) of warp w therefore runs the cell of unit 4w + t for
// rows g and g + 8 (8 U threads, 256 at H = 256), with no shuffle, and keeps
// that unit's carries (c; dc and dh; the GRU's h or dh) in registers for the
// whole sequence. The GRU's backward drops the zero column (bwd_slots 3:
// gate q of unit u at column q U + u, depth 3U; 6% faster on the card than
// the forward's 4U map).
//
// Forward step t: the CTA's z from h_{t-1} in shared memory (every product
// 32 deep in a fresh accumulator, the chunks added in f32: the tensor core
// cuts the bits its sums lose), + x_proj (staged by cp.async two steps
// ahead) + b_hh; the cell (the GRU's n = tanh(x_n + r (h W_hn + b_hn)): b_hn
// inside the reset gate); the new h of the CTA's units written into every
// CTA's next h buffer through distributed shared memory (16 bytes a store,
// st.shared::cluster); one cluster barrier, split into arrive and wait with
// the residual stores between. h is double-buffered: a CTA writes buffer
// (t + 1) % 2 of its peers while they read buffer t % 2, and a peer passed
// the barrier of step t - 1 only after it had read buffer (t + 1) % 2.
//
// Backward step t (reverse time): the gate cotangents of the CTA's units from
// the residuals (staged two steps ahead), stored to device memory; the
// hidden path's cotangent (the LSTM's dz; the GRU's dr, dz and dn r) to
// shared memory in local column order; the CTA's partial of dh_{t-1},
// P_rank = dz . slice^T [16, H]; each n-tile of P sent to the CTA that owns
// its units, into the slot of the sender's rank; one cluster barrier; each
// CTA sums its units' slots in rank order 0 .. kCluster - 1 (no atomics: a
// run repeats bit for bit) and adds the element-wise part (the GRU's dh z)
// or the dh of the rows that were frozen at t. The slots are double-buffered
// as h is.
//
// A row past its length is frozen: forward residuals not stored (the caller
// zero-fills them), h and c kept; backward gate cotangents exactly zero (its
// partials are sums of zeros), dc kept, and dh passed through. A cluster
// walks to the longest length of its rows; rows past the batch load zeros
// and store nothing. 64-bit offsets; expf / tanhf, no fast math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "rnn_cell.cuh"
#include "tf32_mma.cuh"

namespace msfa_cluster {

using msfa_rnn::kGru;
using msfa_rnn::kLstm;
using msfa_rnn::sigmoid;
using namespace msfa_tc;

constexpr int kCluster = 8;    // CTAs per cluster: the portable maximum
constexpr int kTileRows = 16;  // batch rows per cluster
constexpr int kMaxH = 256;     // the slice, h and the exchange buffers in one CTA's 227 KB
constexpr int kMaxThreads = 8 * kMaxH / kCluster;
constexpr int kChunkSteps = 4;  // 8-deep k-steps per fresh accumulator (32 deep)
constexpr int kDzPad = 8;       // dz row stride 4U + 8 (3U + 8): its pair loads touch 32 banks
constexpr int kStages = 3;      // steps of input in flight: staged two steps ahead

// gate columns of a cell per unit, and the residual arrays its backward
// reads beside the gates (c_{t-1}; h_{t-1} and hn)
template <int CELL>
__host__ __device__ constexpr int gate_count() { return CELL == kLstm ? 4 : 3; }
template <int CELL>
__host__ __device__ constexpr int aux_count() { return CELL == kLstm ? 1 : 2; }
// the backward product's slots a unit: the LSTM's four gates in local_col's
// map; the GRU's three gate-major, with no zero column
template <int CELL>
__host__ __device__ constexpr int bwd_slots() { return gate_count<CELL>(); }

// H the cluster body takes: the backward's depth 4U a whole number of
// 32-deep chunks, and what one CTA holds within its shared memory
inline bool supported(int H) { return H > 0 && H % 64 == 0 && H <= kMaxH; }
inline int cluster_threads(int H) { return 8 * (H / kCluster); }
// a step's staged input: the tile's NG gate columns [row][gate][unit], and
// NAUX arrays [row][unit] after them
__host__ __device__ inline size_t stage_floats(int H, int NG, int NAUX) {
  const size_t U = H / kCluster;
  return kTileRows * (NG * U + kPad) + NAUX * kTileRows * (U + kPad);
}
template <int CELL>
inline size_t fwd_smem_bytes(int H) {
  const size_t U = H / kCluster, ld = H + kPad;
  return sizeof(float) * (4 * U * ld + 2 * kTileRows * ld                         // slice, h
                          + kStages * stage_floats(H, gate_count<CELL>(), 0));  // x_proj
}
template <int CELL>
inline size_t bwd_smem_bytes(int H) {
  constexpr int SLOTS = bwd_slots<CELL>();
  const size_t U = H / kCluster, ld = H + kPad;
  return sizeof(float) *
         (SLOTS * U * ld + kTileRows * (SLOTS * U + kDzPad)                    // slice, dz
          + 2 * kCluster * kTileRows * (U + kPad)                              // slots (two buffers)
          + kStages * stage_floats(H, gate_count<CELL>(), aux_count<CELL>()));  // residuals
}

// local column of slot q of local unit u
__device__ __forceinline__ int local_col(int q, int u) {
  return (2 * (u / 4) + q / 2) * 8 + 2 * (u % 4) + (q & 1);
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of `local` (in this CTA's shared memory) in CTA `rank`'s
__device__ __forceinline__ unsigned peer(const float* local, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"((unsigned)__cvta_generic_to_shared(local)), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_peer4(unsigned addr, float a, float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a),
               "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ void st_peer2(unsigned addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}

// A as [m][k] with logical k = t and t + 4 taken as columns 2t and 2t + 1
// (two 8-byte loads a lane); pairs with load_b_colk
__device__ __forceinline__ FragA load_a_pairs(const float* s, int ld, int k0, int g, int t) {
  const float2 top = *reinterpret_cast<const float2*>(s + g * ld + k0 + 2 * t);
  const float2 bot = *reinterpret_cast<const float2*>(s + (g + 8) * ld + k0 + 2 * t);
  return split_a(top.x, bot.x, top.y, bot.y);
}

// this CTA's slice of one group's W_hh [H, NG H] -> ws[local column][k]:
// SLOTS 4, the slot map of local_col (a GRU's slot 3 a zero column); SLOTS
// 3, gate q of unit u at column q U + u
template <int CELL, int SLOTS = 4>
__device__ __forceinline__ void load_slice(const float* __restrict__ w_g, float* ws, int H, int U,
                                           int c0) {
  constexpr int NG = gate_count<CELL>();
  const int cols = SLOTS * U, ld = H + kPad;
  for (int i = threadIdx.x; i < H * cols; i += blockDim.x) {
    const int k = i / cols, r = i - k * cols, q = r / U, u = r - q * U;
    ws[(SLOTS == 4 ? local_col(q, u) : r) * ld + k] =
        q < NG ? __ldg(w_g + (size_t)k * NG * H + q * H + c0 + u) : 0.f;
  }
}

// this tile's batch rows, their lengths clamped to [0, T] (0 past the batch)
__device__ __forceinline__ void load_lengths(const int* __restrict__ lengths, int* len_s, int b0,
                                             int B, int T) {
  if (threadIdx.x < kTileRows) {
    const int b = b0 + threadIdx.x;
    len_s[threadIdx.x] = b < B ? min(max(lengths[b], 0), T) : 0;
  }
}

// step t of the tile's NG gate columns of the CTA's units, [T, G, B, NG H] ->
// dst[row][gate][unit] (row stride NG U + kPad), then of the NAUX arrays a0,
// a1 [T, G, B, H] -> one [row][unit] block each (stride U + kPad) after it:
// 16-byte cp.async copies, zero-filled past the batch; one commit group
template <int NG, int NAUX>
__device__ __forceinline__ void stage_step(const float* __restrict__ x,
                                           const float* __restrict__ a0,
                                           const float* __restrict__ a1, float* dst, int t,
                                           int grp, int b0, int c0, int G, int B, int H, int U) {
  static_assert(NAUX <= 2, "the aux arrays are a0 and a1");
  const int quads = U / 4, per_row = (NG + NAUX) * quads;
  for (int i = threadIdx.x; i < kTileRows * per_row; i += blockDim.x) {
    const int r = i / per_row, k = i - r * per_row, b = b0 + r;
    const size_t row = ((size_t)t * G + grp) * B + b;
    if (k < NG * quads) {
      const int q = k / quads, u = 4 * (k - q * quads);
      cp_async16(dst + r * (NG * U + kPad) + q * U + u,
                 b < B ? x + row * NG * H + q * H + c0 + u : x, b < B);
    } else {  // aux array a (a compare, not a division: NAUX is at most 2)
      const int ka = k - NG * quads, a = NAUX > 1 && ka >= quads ? 1 : 0;
      const int u = 4 * (ka - a * quads);
      const float* src = a == 0 ? a0 : a1;
      cp_async16(dst + kTileRows * (NG * U + kPad) + (a * kTileRows + r) * (U + kPad) + u,
                 b < B ? src + row * H + c0 + u : src, b < B);
    }
  }
  cp_async_commit();
}

// x_proj [T, G, B, NG H] (b_ih inside), w_hh [G, H, NG H], b_hh [G, NG H] ->
// out h_T [G, B, H]; gates [T, G, B, NG H] after their activations (i, f, g,
// o or r, z, n), hprev [T, G, B, H], and aux [T, G, B, H]: c_{t-1} (LSTM) or
// hn = h_{t-1} W_hn + b_hn (GRU), at valid steps only. Grid (kCluster, tiles,
// G), clusters of kCluster along x; 8 U threads.
template <int CELL>
__device__ __forceinline__ void train_fwd_cluster_body(
    const float* __restrict__ x_proj, const float* __restrict__ w_hh,
    const float* __restrict__ b_hh, const int* __restrict__ lengths, float* __restrict__ out,
    float* __restrict__ gates, float* __restrict__ hprev, float* __restrict__ aux, int T, int G,
    int B, int H) {
  constexpr int NG = gate_count<CELL>();
  extern __shared__ float4 smem4[];
  const int U = H / kCluster, ld = H + kPad, cols = NG * H, lx = NG * U + kPad;
  const int sx = (int)stage_floats(H, NG, 0);
  float* ws = reinterpret_cast<float*>(smem4);  // [4U][ld] the slice
  float* h_s = ws + 4 * U * ld;                 // [2][kTileRows][ld] h_{t-1}, h_t
  float* x_s = h_s + 2 * kTileRows * ld;        // [kStages][sx] x_proj of a step
  __shared__ int len_s[kTileRows];

  const int rank = cluster_rank(), grp = blockIdx.z, b0 = blockIdx.y * kTileRows;
  const int c0 = rank * U, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4, j = c0 + 4 * warp + tq;  // rows gr, gr + 8; unit j
  load_lengths(lengths, len_s, b0, B, T);
  load_slice<CELL>(w_hh + (size_t)grp * H * cols, ws, H, U, c0);
  for (int i = threadIdx.x; i < kTileRows * ld; i += blockDim.x) h_s[i] = 0.f;  // h_0
  __syncthreads();
  int t_end = 0;
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) t_end = max(t_end, len_s[r]);
  const int len[2] = {len_s[gr], len_s[gr + 8]};
  float bias[NG], h[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};
#pragma unroll
  for (int q = 0; q < NG; ++q) bias[q] = __ldg(b_hh + (size_t)grp * cols + q * H + j);
  for (int t = 0; t < kStages - 1; ++t) {  // x_proj of steps 0 and 1 in flight
    if (t < t_end)
      stage_step<NG, 0>(x_proj, nullptr, nullptr, x_s + t * sx, t, grp, b0, c0, G, B, H, U);
    else
      cp_async_commit();
  }
  cp_async_wait<kStages - 2>();  // step 0's
  cluster_arrive();  // every CTA of the cluster runs and holds h_0 before any peer writes
  cluster_wait();

  for (int t = 0; t < t_end; ++t) {
    const float* h_cur = h_s + (t & 1) * kTileRows * ld;
    float* h_nxt = h_s + ((t + 1) & 1) * kTileRows * ld;
    if (t + kStages - 1 < t_end)  // into the buffer step t - 1 read
      stage_step<NG, 0>(x_proj, nullptr, nullptr, x_s + (t + kStages - 1) % kStages * sx,
                        t + kStages - 1, grp, b0, c0, G, B, H, U);
    else
      cp_async_commit();
    const float* xp = x_s + t % kStages * sx + gr * lx + 4 * warp + tq;
    // z = h_{t-1} . slice on this warp's two n-tiles
    float acc[2][4] = {};
    // four 32-deep chunks in flight: 1.3% (LSTM) and 4% (GRU) faster than two
    // (scripts/lstm_cluster_variants.py)
#pragma unroll 4
    for (int k0 = 0; k0 < H; k0 += 8 * kChunkSteps) {
      float part[2][4];
#pragma unroll
      for (int s = 0; s < kChunkSteps; ++s) {
        const FragA a = load_a_rowk(h_cur, ld, 0, k0 + 8 * s, gr, tq);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const FragB b = load_b_rowk(ws, ld, (2 * warp + n) * 8, k0 + 8 * s, gr, tq);
          if (s == 0) mma3_zero(part[n], a, b);
          else mma3(part[n], a, b);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
    }
    // the cell of unit j for rows gr (rr 0) and gr + 8 (rr 1): acc[0] holds
    // slots 0, 1 and acc[1] slots 2, 3, at (2 rr, 2 rr + 1)
    float act[2][NG], h_new[2], kept[2];  // kept: the LSTM's new c, the GRU's hn
    bool valid[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float* x = xp + 8 * rr * lx;  // row gr + 8 rr, gate q at q U
      float hn;
      if constexpr (CELL == kLstm) {
        const float zi = acc[0][2 * rr] + x[0] + bias[0];
        const float zf = acc[0][2 * rr + 1] + x[U] + bias[1];
        const float zg = acc[1][2 * rr] + x[2 * U] + bias[2];
        const float zo = acc[1][2 * rr + 1] + x[3 * U] + bias[3];
        act[rr][0] = sigmoid(zi);
        act[rr][1] = sigmoid(zf);
        act[rr][2] = tanhf(zg);
        act[rr][3] = sigmoid(zo);
        kept[rr] = act[rr][1] * c[rr] + act[rr][0] * act[rr][2];
        hn = act[rr][3] * tanhf(kept[rr]);
      } else {  // slot 2 is h W_hn: + b_hn, inside the reset gate
        act[rr][0] = sigmoid(acc[0][2 * rr] + x[0] + bias[0]);
        act[rr][1] = sigmoid(acc[0][2 * rr + 1] + x[U] + bias[1]);
        kept[rr] = acc[1][2 * rr] + bias[2];
        act[rr][2] = tanhf(x[2 * U] + act[rr][0] * kept[rr]);
        hn = (1.f - act[rr][1]) * act[rr][2] + act[rr][1] * h[rr];
      }
      valid[rr] = t < len[rr];
      h_new[rr] = valid[rr] ? hn : h[rr];
    }
    // h_t of rows gr and gr + 8, units 4w .. 4w + 3 -> every CTA's next buffer:
    // the quad gathers its four units, lane tq sends to ranks tq, tq + 4, ...
    float v[2][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[rr][i] = __shfl_sync(0xffffffffu, h_new[rr], (lane & ~3) + i);
#pragma unroll
    for (int i = 0; i < kCluster / 4; ++i) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        st_peer4(peer(h_nxt + (gr + 8 * rr) * ld + c0 + 4 * warp, tq + 4 * i), v[rr][0],
                 v[rr][1], v[rr][2], v[rr][3]);
    }
    cp_async_wait<kStages - 2>();  // this thread's copies of step t + 1's x_proj
    cluster_arrive();  // (the barrier also makes every thread's copies visible)
    // the residuals of the valid rows while the peers finish their step
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (valid[rr]) {
        const size_t row = ((size_t)t * G + grp) * B + b0 + gr + 8 * rr;
#pragma unroll
        for (int q = 0; q < NG; ++q) gates[row * cols + q * H + j] = act[rr][q];
        hprev[row * H + j] = h[rr];
        aux[row * H + j] = CELL == kLstm ? c[rr] : kept[rr];
        if constexpr (CELL == kLstm) c[rr] = kept[rr];
      }
      h[rr] = h_new[rr];
    }
    cluster_wait();  // h_t (and step t + 1's x_proj) in place in every CTA
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int b = b0 + gr + 8 * rr;
    if (b < B) out[((size_t)grp * B + b) * H + j] = h[rr];
  }
}

// gates [T, G, B, NG H] and the forward's other residuals (LSTM: a0 =
// cprev; GRU: a0 = hprev, a1 = hn), w_hh [G, H, NG H], dh_out [G, B, H] ->
// dx [T, G, B, NG H], written at valid steps only (zero-filled by the
// caller). The product's depth is bwd_slots U. Grid and threads as the
// forward.
template <int CELL>
__device__ __forceinline__ void train_bwd_cluster_body(
    const float* __restrict__ gates, const float* __restrict__ a0, const float* __restrict__ a1,
    const float* __restrict__ w_hh, const int* __restrict__ lengths,
    const float* __restrict__ dh_out, float* __restrict__ dx, int T, int G, int B, int H) {
  constexpr int NG = gate_count<CELL>(), NAUX = aux_count<CELL>(), SLOTS = bwd_slots<CELL>();
  extern __shared__ float4 smem4[];
  const int U = H / kCluster, ld = H + kPad, cols = NG * H, lx = NG * U + kPad;
  const int depth = SLOTS * U, ldz = depth + kDzPad, ldr = U + kPad;
  const int slots = kCluster * kTileRows * ldr;
  float* ws = reinterpret_cast<float*>(smem4);  // [depth][ld] the slice
  float* dz_s = ws + depth * ld;                // [kTileRows][ldz] dz, local columns
  float* red_s = dz_s + kTileRows * ldz;        // [2][kCluster][kTileRows][ldr] partials
  const int sx = (int)stage_floats(H, NG, NAUX);
  float* r_s = red_s + 2 * slots;  // [kStages][sx] the residuals of a step
  __shared__ int len_s[kTileRows];

  const int rank = cluster_rank(), grp = blockIdx.z, b0 = blockIdx.y * kTileRows;
  const int c0 = rank * U, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4, u = 4 * warp + tq, j = c0 + u;
  load_lengths(lengths, len_s, b0, B, T);
  load_slice<CELL, SLOTS>(w_hh + (size_t)grp * H * cols, ws, H, U, c0);
  __syncthreads();
  int t_end = 0;
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) t_end = max(t_end, len_s[r]);
  const int len[2] = {len_s[gr], len_s[gr + 8]};
  float dh[2], dc[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int b = b0 + gr + 8 * rr;
    dh[rr] = b < B ? dh_out[((size_t)grp * B + b) * H + j] : 0.f;
  }
  // the residuals of step s go to buffer s % kStages; steps t_end - 1 and
  // t_end - 2 in flight
  for (int i = 1; i < kStages; ++i) {
    const int s = t_end - i;
    if (s >= 0)
      stage_step<NG, NAUX>(gates, a0, a1, r_s + s % kStages * sx, s, grp, b0, c0, G, B, H, U);
    else
      cp_async_commit();
  }
  cp_async_wait<kStages - 2>();  // step t_end - 1's
  cluster_arrive();  // every CTA of the cluster runs before any peer writes
  cluster_wait();

  for (int t = t_end - 1; t >= 0; --t) {
    const int s_next = t - (kStages - 1);
    if (s_next >= 0)  // into the buffer step t + 1 read
      stage_step<NG, NAUX>(gates, a0, a1, r_s + s_next % kStages * sx, s_next, grp, b0, c0, G,
                           B, H, U);
    else
      cp_async_commit();
    const float* res = r_s + t % kStages * sx;
    // d: the x_proj cotangent; p: the hidden path's, by slot
    float d[2][NG], p[2][SLOTS], skip[2];
    bool valid[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      valid[rr] = t < len[rr];
      const int row = gr + 8 * rr;
      if (valid[rr]) {
        const float* gt = res + row * lx + u;  // gate q at q U
        const float* ax = res + kTileRows * lx + row * ldr + u;  // aux array a at a 16 ldr
        if constexpr (CELL == kLstm) {
          const float gi = gt[0], gf = gt[U], gg = gt[2 * U], go = gt[3 * U];
          const float c_prev = ax[0];
          const float tc = tanhf(gf * c_prev + gi * gg);  // c_t recomputed
          const float dct = dc[rr] + dh[rr] * go * (1.f - tc * tc);
          d[rr][0] = dct * gg * gi * (1.f - gi);
          d[rr][1] = dct * c_prev * gf * (1.f - gf);
          d[rr][2] = dct * gi * (1.f - gg * gg);
          d[rr][3] = dh[rr] * tc * go * (1.f - go);
          dc[rr] = dct * gf;
          skip[rr] = 0.f;  // dh_{t-1} is all dz W_hh^T
#pragma unroll
          for (int q = 0; q < 4; ++q) p[rr][q] = d[rr][q];
        } else {
          const float gate_r = gt[0], gate_z = gt[U], gate_n = gt[2 * U];
          const float h_prev = ax[0], hn = ax[kTileRows * ldr];
          const float dn_pre = dh[rr] * (1.f - gate_z) * (1.f - gate_n * gate_n);
          d[rr][0] = dn_pre * hn * gate_r * (1.f - gate_r);
          d[rr][1] = dh[rr] * (h_prev - gate_n) * gate_z * (1.f - gate_z);
          d[rr][2] = dn_pre;
          p[rr][0] = d[rr][0];
          p[rr][1] = d[rr][1];
          p[rr][2] = dn_pre * gate_r;  // n = tanh(x_n + r hn): the hidden path's slot
          skip[rr] = dh[rr] * gate_z;  // the element-wise part of dh_{t-1}
        }
      } else {  // frozen: cotangents 0, dc and dh pass through
#pragma unroll
        for (int q = 0; q < NG; ++q) d[rr][q] = 0.f;
#pragma unroll
        for (int q = 0; q < SLOTS; ++q) p[rr][q] = 0.f;
        skip[rr] = dh[rr];
      }
      if constexpr (SLOTS == 4) {
        float* zr = dz_s + row * ldz + 16 * warp + 2 * tq;  // local_col(0, u)
        *reinterpret_cast<float2*>(zr) = make_float2(p[rr][0], p[rr][1]);
        *reinterpret_cast<float2*>(zr + 8) = make_float2(p[rr][2], p[rr][3]);
      } else {
#pragma unroll
        for (int q = 0; q < SLOTS; ++q) dz_s[row * ldz + q * U + u] = p[rr][q];
      }
    }
    if (t > 0) {
      __syncthreads();  // the tile's dz is in place
      // this CTA's partial of dh_{t-1}: P = dz . slice^T on this warp's four
      // n-tiles of units (the cluster's H / 8 n-tiles over its 8 U / 32 warps)
      float acc[kCluster / 2][4] = {};
      // one chunk at a time: the GRU's 3U product 4% faster than two in
      // flight, the LSTM's the same
#pragma unroll 1
      for (int k0 = 0; k0 < depth; k0 += 8 * kChunkSteps) {
        float part[kCluster / 2][4];
#pragma unroll
        for (int s = 0; s < kChunkSteps; ++s) {
          if (SLOTS == 3 && k0 + 8 * s >= depth) break;  // 3U: a last chunk of 8 or 16
          const FragA a = load_a_pairs(dz_s, ldz, k0 + 8 * s, gr, tq);
#pragma unroll
          for (int n = 0; n < kCluster / 2; ++n) {
            const FragB b =
                load_b_colk(ws, ld, k0 + 8 * s, (kCluster / 2 * warp + n) * 8, gr, tq);
            if (s == 0) mma3_zero(part[n], a, b);
            else mma3(part[n], a, b);
          }
        }
#pragma unroll
        for (int n = 0; n < kCluster / 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
      }
      // each n-tile's 8 units lie in one CTA: into that CTA's slot `rank`
      float* slot = red_s + (t & 1) * slots + rank * kTileRows * ldr;
#pragma unroll
      for (int n = 0; n < kCluster / 2; ++n) {
        const int unit = (kCluster / 2 * warp + n) * 8 + 2 * tq, r = unit / U, lu = unit - r * U;
        st_peer2(peer(slot + gr * ldr + lu, r), acc[n][0], acc[n][1]);
        st_peer2(peer(slot + (gr + 8) * ldr + lu, r), acc[n][2], acc[n][3]);
      }
      cp_async_wait<kStages - 2>();  // this thread's copies of step t - 1's residuals
      cluster_arrive();  // (the barrier also makes every thread's copies visible)
    }
    // the cotangents of the valid rows while the peers finish their step
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (valid[rr]) {
        const size_t row = ((size_t)t * G + grp) * B + b0 + gr + 8 * rr;
#pragma unroll
        for (int q = 0; q < NG; ++q) dx[row * cols + q * H + j] = d[rr][q];
      }
    }
    if (t > 0) {
      cluster_wait();  // every partial of this CTA's units (and step t - 1's residuals) in place
      // dh_{t-1} of unit j: the partials summed in rank order, then the
      // element-wise part or the frozen rows' dh
      const float* red = red_s + (t & 1) * slots;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int at = (gr + 8 * rr) * ldr + u;
        float s = red[at];
        for (int r = 1; r < kCluster; ++r) s += red[r * kTileRows * ldr + at];
        dh[rr] = s + skip[rr];
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_train_fwd_cluster_kernel(const float* __restrict__ x_proj, const float* __restrict__ w_hh,
                              const float* __restrict__ b_hh, const int* __restrict__ lengths,
                              float* __restrict__ out, float* __restrict__ gates,
                              float* __restrict__ hprev, float* __restrict__ cprev, int T, int G,
                              int B, int H) {
  train_fwd_cluster_body<kLstm>(x_proj, w_hh, b_hh, lengths, out, gates, hprev, cprev, T, G, B,
                                H);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
gru_train_fwd_cluster_kernel(const float* __restrict__ x_proj, const float* __restrict__ w_hh,
                             const float* __restrict__ b_hh, const int* __restrict__ lengths,
                             float* __restrict__ out, float* __restrict__ gates,
                             float* __restrict__ hprev, float* __restrict__ hn, int T, int G,
                             int B, int H) {
  train_fwd_cluster_body<kGru>(x_proj, w_hh, b_hh, lengths, out, gates, hprev, hn, T, G, B, H);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_train_bwd_cluster_kernel(const float* __restrict__ gates, const float* __restrict__ cprev,
                              const float* __restrict__ w_hh, const int* __restrict__ lengths,
                              const float* __restrict__ dh_out, float* __restrict__ dx, int T,
                              int G, int B, int H) {
  train_bwd_cluster_body<kLstm>(gates, cprev, nullptr, w_hh, lengths, dh_out, dx, T, G, B, H);
}

__global__ void __launch_bounds__(kMaxThreads, 1)
gru_train_bwd_cluster_kernel(const float* __restrict__ gates, const float* __restrict__ hprev,
                             const float* __restrict__ hn, const float* __restrict__ w_hh,
                             const int* __restrict__ lengths, const float* __restrict__ dh_out,
                             float* __restrict__ dx, int T, int G, int B, int H) {
  train_bwd_cluster_body<kGru>(gates, hprev, hn, w_hh, lengths, dh_out, dx, T, G, B, H);
}

}  // namespace msfa_cluster
