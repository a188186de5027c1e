// The grouped LSTM / GRU forward recurrence shared by rnn.cu (inference: the
// final hidden state) and rnn_train.cu (training: the final hidden state plus
// the per-step residuals the backward reads). Its design, what bounds it and
// what was measured are in rnn.cu's header note.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace msfa_rnn {

constexpr int kRows = 4;             // batch rows per block
constexpr int kUnroll = 4;           // reduction rows unrolled on the fused path
constexpr int kBatch = 16;           // rows of W_hh whose loads are issued together otherwise
constexpr int kHalf = kRows / 2;     // rows each half of the block finishes
static_assert(kRows % 4 == 0, "a unit's rows are read as 16-byte vectors");
constexpr int kUnits = 256;          // hidden units per pass
constexpr int kThreads = 2 * kUnits; // two halves of the reduction
constexpr int kLstm = 0, kGru = 1;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// one unit's kRows values [unit][row] as 16-byte accesses
__device__ __forceinline__ void load_rows(const float* p, float (&v)[kRows]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < kRows / 4; ++i) {
    const float4 t = p4[i];
    v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
  }
}

// acc[slot][r] += v[k][r] * w[q] for the NG gate columns q of one row k of W;
// gate 2 goes to slot S2 (the GRU keeps the input and hidden parts of its
// candidate gate apart), the others to their own index
template <int NG, int S2>
__device__ __forceinline__ void fma_row(const float (&w)[NG], const float* vk,
                                        float (&acc)[4][kRows]) {
  float hv[kRows];
  load_rows(vk, hv);
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const int slot = q == 2 ? S2 : q;
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[slot][r] = fmaf(hv[r], w[q], acc[slot][r]);
  }
}

// acc[slot][r] += sum_{k0 <= k < k1} v[k][r] * W[k][q * H + j] for the NG gate
// columns q of unit j. BATCH > 0: the weights of BATCH rows are loaded into
// registers before any of them is used, so that BATCH * NG L2 reads are in
// flight per thread; BATCH == 0: a loop unrolled kUnroll times, where ptxas
// places each load (and on the precomputed-projection path left one load in
// flight at a time: the LSTM training forward took 59.6 us a step, PERF.md).
// The fused path keeps the unrolled loop, which was the faster one there.
template <int NG, int S2, int BATCH>
__device__ __forceinline__ void accumulate(const float* __restrict__ W, int k0, int k1, int H,
                                           int j, const float* v, float (&acc)[4][kRows]) {
  const size_t ld = (size_t)NG * H;
  int k = k0;
  if constexpr (BATCH > 0) {
    for (; k + BATCH <= k1; k += BATCH) {
      float w[BATCH][NG];
#pragma unroll
      for (int i = 0; i < BATCH; ++i)
#pragma unroll
        for (int q = 0; q < NG; ++q) w[i][q] = __ldg(W + (k + i) * ld + q * H + j);
#pragma unroll
      for (int i = 0; i < BATCH; ++i) fma_row<NG, S2>(w[i], v + (k + i) * kRows, acc);
    }
  }
#pragma unroll kUnroll
  for (; k < k1; ++k) {
    float w[NG];
#pragma unroll
    for (int q = 0; q < NG; ++q) w[q] = __ldg(W + k * ld + q * H + j);
    fma_row<NG, S2>(w, v + k * kRows, acc);
  }
}

// x_t of the tile -> shared memory [d][row], asynchronously; rows past the
// batch keep the zeros the buffer was initialised with
__device__ __forceinline__ void stage_input(const float* __restrict__ x, float* x_s, int t, int g,
                                            int b0, int G, int B, int D) {
  const float* src = x + (((size_t)t * G + g) * B + b0) * D;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    if (b0 + r < B) __pipeline_memcpy_async(x_s + d * kRows + r, src + i, sizeof(float));
  }
  __pipeline_commit();
}

// x_proj_t of the tile -> shared memory [row][cols], asynchronously, 16 bytes
// a copy (4 where a row is not a whole number of 16-byte vectors: 3H with H
// not a multiple of 4)
__device__ __forceinline__ void stage_projection(const float* __restrict__ x_proj, float* xp_s,
                                                 int t, int g, int b0, int G, int B, int cols) {
  const float* src = x_proj + (((size_t)t * G + g) * B + b0) * cols;
  if (cols % 4 == 0) {
    const int quads = cols / 4;
    for (int i = threadIdx.x; i < kRows * quads; i += kThreads) {
      const int r = i / quads;
      if (b0 + r < B) __pipeline_memcpy_async(xp_s + 4 * i, src + 4 * i, sizeof(float4));
    }
  } else {
    for (int i = threadIdx.x; i < kRows * cols; i += kThreads) {
      if (b0 + i / cols < B) __pipeline_memcpy_async(xp_s + i, src + i, sizeof(float));
    }
  }
  __pipeline_commit();
}

// half HALF hands the partial sums of the other half's rows over
template <int HALF>
__device__ __forceinline__ void hand_over(const float (&acc)[4][kRows], float* red_s, int u) {
  float* dst = red_s + (1 - HALF) * 4 * kHalf * kUnits + u;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int rr = 0; rr < kHalf; ++rr)
      dst[(q * kHalf + rr) * kUnits] = acc[q][(1 - HALF) * kHalf + rr];
}

// The training forward's per-step stores, made for t < length only (the
// caller zero-fills them): the post-activation gates [T, G, B, NG*H] (i, f,
// g, o or r, z, n), the incoming h_{t-1} [T, G, B, H], and in `aux`
// [T, G, B, H] the incoming c_{t-1} (LSTM) or hn = h_{t-1} W_hn + b_hn (GRU).
// All null for inference.
struct Residuals {
  float* gates;
  float* hprev;
  float* aux;
};

// half HALF adds what it received and finishes its rows of unit j: gates, c, h
// (xp: this tile's precomputed projection [row][NG*H] in shared memory, or
// null; row0: the tile's first row in the [T, G, B] residual layout)
template <int CELL, int HALF, bool TRAIN>
__device__ __forceinline__ void finish(const float (&acc)[4][kRows], const float* red_s, int u,
                                       int j, const float* xp, int H, const float (&ba)[4],
                                       const float (&bb)[4], const int* len_s, int t,
                                       const float* h_cur, float* h_nxt, float* c_s,
                                       const Residuals& res, size_t row0) {
  constexpr int NG = CELL == kLstm ? 4 : 3;
  const float* src = red_s + HALF * 4 * kHalf * kUnits + u;
  const int at = j * kRows + HALF * kHalf;
#pragma unroll
  for (int rr = 0; rr < kHalf; ++rr) {
    const int row = HALF * kHalf + rr;
    float z[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) z[q] = acc[q][row] + src[(q * kHalf + rr) * kUnits];
    if (xp != nullptr) {  // the GRU's candidate column goes to slot 3, beside x W_in
#pragma unroll
      for (int q = 0; q < NG; ++q) z[CELL == kGru && q == 2 ? 3 : q] += xp[row * NG * H + q * H + j];
    }
    const bool valid = t < len_s[row];
    const float keep = valid ? 1.f : 0.f;
    const float h_old = h_cur[at + rr];
    float h, gate[NG], aux;
    if constexpr (CELL == kLstm) {
      gate[0] = sigmoid(z[0] + ba[0]);
      gate[1] = sigmoid(z[1] + ba[1]);
      gate[2] = tanhf(z[2] + ba[2]);
      gate[3] = sigmoid(z[3] + ba[3]);
      const float c_old = c_s[at + rr];
      const float c = gate[1] * c_old + gate[0] * gate[2];
      h = gate[3] * tanhf(c);
      c_s[at + rr] = keep * c + (1.f - keep) * c_old;
      aux = c_old;
    } else {
      // slot 2 holds h W_hn, slot 3 x W_in: b_hn stays inside the reset gate
      gate[0] = sigmoid(z[0] + ba[0] + bb[0]);
      gate[1] = sigmoid(z[1] + ba[1] + bb[1]);
      aux = z[2] + bb[2];
      gate[2] = tanhf(z[3] + ba[2] + gate[0] * aux);
      h = (1.f - gate[1]) * gate[2] + gate[1] * h_old;
    }
    h_nxt[at + rr] = keep * h + (1.f - keep) * h_old;
    if (TRAIN && valid) {  // unit j's columns: consecutive across the warp
      const size_t r_off = row0 + row;
#pragma unroll
      for (int q = 0; q < NG; ++q) res.gates[r_off * NG * H + q * H + j] = gate[q];
      res.hprev[r_off * H + j] = h_old;
      res.aux[r_off * H + j] = aux;
    }
  }
}

// CELL: kLstm or kGru. PROJ: `in` is raw x [T, G, B, D] and w_ih [G, D, NG*H]
// projects it here; else `in` is x_proj [T, G, B, NG*H]. bias_a is the one
// additive bias of the LSTM, b_ih of the GRU (null where x_proj holds it);
// bias_b is b_hh of the GRU. TRAIN: store the residuals at every valid step.
template <int CELL, bool PROJ, bool TRAIN>
__device__ __forceinline__ void recurrence(const float* __restrict__ in,
                                           const float* __restrict__ w_ih,
                                           const float* __restrict__ w_hh,
                                           const float* __restrict__ bias_a,
                                           const float* __restrict__ bias_b,
                                           const int* __restrict__ lengths,
                                           float* __restrict__ out, int T, int G, int B, int D,
                                           int H, Residuals res) {
  constexpr int NG = CELL == kLstm ? 4 : 3;
  extern __shared__ float4 smem4[];
  float* h_s = reinterpret_cast<float*>(smem4);  // [2][H][kRows]
  float* c_s = h_s + 2 * H * kRows;              // [H][kRows]
  // the staged input, two buffers: x_t [D][kRows], or x_proj_t [kRows][NG*H]
  const int staged = PROJ ? D * kRows : kRows * NG * H;
  float* x_s = c_s + H * kRows;
  float* red_s = x_s + 2 * staged;  // [2][4][kHalf][kUnits] partial sums
  __shared__ int len_s[kRows];

  const int g = blockIdx.y, b0 = blockIdx.x * kRows, tid = threadIdx.x;
  const int u = tid % kUnits, half = tid / kUnits;  // a warp lies in one half
  if (tid < kRows) {
    const int b = b0 + tid;
    len_s[tid] = b < B ? min(max(lengths[b], 0), T) : 0;
  }
  for (int i = tid; i < 3 * H * kRows + 2 * staged; i += kThreads) h_s[i] = 0.f;  // h, c, input
  __syncthreads();
  int t_end = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) t_end = max(t_end, len_s[r]);
  if (t_end > 0) {
    if (PROJ) stage_input(in, x_s, 0, g, b0, G, B, D);
    else stage_projection(in, x_s, 0, g, b0, G, B, NG * H);
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  const size_t gate_cols = (size_t)NG * H;
  const float* whh_g = w_hh + (size_t)g * H * gate_cols;
  const float* wih_g = PROJ ? w_ih + (size_t)g * D * gate_cols : nullptr;
  // this half's part of each reduction
  const int h_mid = (H + 1) / 2, d_mid = (D + 1) / 2;
  const int hk0 = half ? h_mid : 0, hk1 = half ? H : h_mid;
  const int dk0 = half ? d_mid : 0, dk1 = half ? D : d_mid;
  int cur = 0;
  for (int t = 0; t < t_end; ++t) {
    const float* h_cur = h_s + cur * H * kRows;
    float* h_nxt = h_s + (cur ^ 1) * H * kRows;
    if (t + 1 < t_end) {  // the next step's input arrives while this one computes
      if (PROJ) stage_input(in, x_s + (cur ^ 1) * staged, t + 1, g, b0, G, B, D);
      else stage_projection(in, x_s + (cur ^ 1) * staged, t + 1, g, b0, G, B, NG * H);
    }
    const size_t row0 = ((size_t)t * G + g) * B + b0;
    for (int j0 = 0; j0 < H; j0 += kUnits) {
      const int j = j0 + u;
      const bool active = j < H;
      float acc[4][kRows];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[q][r] = 0.f;
      float ba[4] = {0.f, 0.f, 0.f, 0.f}, bb[4] = {0.f, 0.f, 0.f, 0.f};
      if (active) {
#pragma unroll
        for (int q = 0; q < NG; ++q) {
          if (bias_a != nullptr) ba[q] = __ldg(bias_a + g * gate_cols + q * H + j);
          if (CELL == kGru) bb[q] = __ldg(bias_b + g * gate_cols + q * H + j);
        }
        accumulate<NG, 2, PROJ ? 0 : kBatch>(whh_g, hk0, hk1, H, j, h_cur, acc);
        if (PROJ)
          accumulate<NG, CELL == kGru ? 3 : 2, 0>(wih_g, dk0, dk1, H, j, x_s + cur * staged,
                                                  acc);
        if (half == 0) hand_over<0>(acc, red_s, u); else hand_over<1>(acc, red_s, u);
      }
      __syncthreads();  // the partial sums are in place
      if (active) {
        const float* xp = PROJ ? nullptr : x_s + cur * staged;
        if (half == 0)
          finish<CELL, 0, TRAIN>(acc, red_s, u, j, xp, H, ba, bb, len_s, t, h_cur, h_nxt, c_s,
                                 res, row0);
        else
          finish<CELL, 1, TRAIN>(acc, red_s, u, j, xp, H, ba, bb, len_s, t, h_cur, h_nxt, c_s,
                                 res, row0);
      }
      if (j0 + kUnits < H) __syncthreads();  // the next pass reuses the exchange buffer
    }
    __pipeline_wait_prior(0);
    __syncthreads();  // the new h and the next input are in place
    cur ^= 1;
  }

  const float* h_fin = h_s + cur * H * kRows;
  for (int j = tid; j < H; j += kThreads)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (b0 + r < B) out[((size_t)g * B + b0 + r) * H + j] = h_fin[j * kRows + r];
}

// h (two buffers), c, the staged input (two buffers of `staged` floats), the exchange buffer
inline size_t smem_bytes(int H, size_t staged) {
  return sizeof(float) * ((size_t)3 * H * kRows + 2 * staged + 2 * 4 * kHalf * kUnits);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline bool bad_shape(int T, int G, int B, int D, int H) {
  return T < 0 || G <= 0 || B <= 0 || D < 0 || H <= 0;
}

}  // namespace msfa_rnn
