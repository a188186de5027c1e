// Fused eval-mode HybridFusion head, f32, for Hopper (sm_90a).
//
// Replaces: multimodal_sensor_fusion_with_attention_rajeevatla_tpu/ops/pallas_fusion.py
//   _head_kernel (launched by fused_hybrid_head, reached by hybrid_fused_inference).
//
// From the projected (post-ReLU) modality embeddings e [M, B, H] and the
// availability mask [B, M], for the P = M(M-1) ordered (query, key) pairs in
// query-major order:
//   att_p  = (e_k Wv_p + bv_p) Wo_p + bo_p       replaced by bo_p where key k is masked
//   agg_q  = (e_q + sum_{p: query q} att_p) / M * mask_q
//   w      = adaptive gate weights of (agg_q . wg_q + bg_q), with the
//            mask-proportional and uniform fallbacks of ops/masked.py
//   logits = relu((sum_q w_q agg_q) W1 + b1) W2 + b2
// Every product is computed here; no library call.
//
// What bounds it on the H100: at batch 64 the 2P pair matrices (P = 12,
// H = 256), the other weights and the inputs are 6.9 MB against 0.21 GFLOP.
// As 3xTF32 on the tensor cores (165 TFLOP/s) the operations take 1.3 us and
// the bytes 2.1 us at 3.35 TB/s: bytes bound it. The TPU kept all weights
// resident in VMEM; an SM holds 227 KB, so here the weights are spread over
// many blocks. What a launch then costs is latency, not the card's rates:
// each launch costs microseconds of its own, one SM takes in its operands
// from the L2 far slower than the card as a whole does, and a warp's chain of
// dependent mma.sync products waits on each product. So:
//   - every product is a tile of 64 (pairs) or 32 (hidden) rows x 32 columns,
//     a warp per 16 x 16 piece: each pair weight element is read once per
//     64-row batch tile, and no SM takes in more than ~100 KB. The block
//     stages all of its operands (K = H) into shared memory at once by
//     cp.async, weights first, then multiplies with no barrier between
//     chunks, two 32-deep chunks at a time (independent accumulator chains).
//     Above H = 576 (what one block's shared memory holds) K comes in slabs
//     of 576, a barrier between slabs; the chunks are added in the same
//     order either way;
//   - each launch after the first is a programmatic dependent launch: every
//     kernel lets the next one start as soon as all its blocks run, and the
//     next stages what does not depend on its predecessor (the weights, the
//     masks, the embeddings) before it waits (griddepcontrol.wait) for the
//     predecessor's output, so the launches and the weight loads overlap;
//   - the gate takes a batch row a block, every warp staging, and the biases
//     and masks of an epilogue are read before the product. Where a gate
//     row's operands ((M^2 + M) H floats) or the logits block's (4 H + H C)
//     exceed a block's shared memory, that kernel reads them from device
//     memory instead, in the same order: the head takes any M >= 2, H (a
//     multiple of 4) and C.
//
// Five launches on one stream:
//   pairs:   v_p = e_k Wv_p + bv_p for every pair, into scratch [P, B, H];
//            blocks (pair, column tile, batch tile): 96 at batch 64
//   att:     att_p = v_p Wo_p + bo_p, the key mask selecting bo_p per row in
//            the epilogue, into scratch [P, B, H]; the same blocks
//   gate:    agg_q = (e_q + the att_p of q's pairs in query-major order) / M
//            * mask_q, the gate scores (a warp per modality), the adaptive
//            gate weights and fused = sum_q w_q agg_q, a row a block, into
//            scratch [B, H]
//   hidden:  relu(fused W1 + b1), blocks (column tile, batch tile), into
//            scratch [B, H]
//   logits:  hidden W2 + b2, a thread per (row, class), 4 rows a block
// Every product takes each f32 product as three TF32 products (tf32_mma.cuh),
// a fresh accumulator per 32-deep chunk of K added in order in f32, as the
// tiles of tc_product.cuh do. Each element of every sum is added in a fixed
// order, no atomics: the head repeats bit for bit. Rows of the last batch
// tile beyond B load zeros and are never written, so padding cannot leak
// into real rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "residual_ln.cuh"

namespace {

namespace tc = msfa_tc;

constexpr int kCols = 32;         // columns of a product block, two warps of 16 wide
constexpr int kPairRows = 64;     // batch rows of a pair product block: 8 warps
constexpr int kHiddenRows = 32;   // batch rows of a hidden product block: 4 warps
constexpr int kRowsL = 4;         // rows of a logits block
constexpr int kThreadsG = 256;
constexpr int kSmemFloats = 227 * 1024 / 4;  // a block's shared memory on the H100
constexpr int kSlabK = 576;  // K of a pair product block's staged slab: fills kSmemFloats

// The next kernel on the stream may launch (programmatic dependent launch).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Wait until the kernel before this one on the stream has finished and its
// writes are visible; returns at once for a launch without the attribute.
__device__ __forceinline__ void wait_for_predecessor() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// K = H rounded up to an even number of 32-deep chunks (zeros past H): the
// product takes its chunks two at a time
__host__ __device__ inline int padded_k(int H) {
  constexpr int kPair = 2 * tc::kProdK;
  return (H + kPair - 1) / kPair * kPair;
}

// K of one staged slab: all of Kp up to kSlabK
__host__ __device__ inline int slab_k(int H) { return min(padded_k(H), kSlabK); }

// A product block's shared memory: A [rows][slab + 8] (k along the row), W
// [slab][kCols + 4] (k down the column)
__host__ __device__ inline int product_smem_floats(int rows, int H) {
  return rows * (slab_k(H) + tc::kRowKPad) + slab_k(H) * (kCols + tc::kPad);
}

__host__ __device__ constexpr int product_threads(int rows) { return rows / 16 * 2 * 32; }

// The key of query-major ordered pair p (query p / (M - 1)).
__device__ __forceinline__ int key_of(int p, int M) {
  const int q = p / (M - 1), kk = p % (M - 1);
  return kk < q ? kk : kk + 1;
}

// One warp's 16 x 16 piece of one 32-deep chunk, from a zero accumulator.
__device__ __forceinline__ void chunk_product(const float* As, int lda, const float* Ws,
                                              int m0, int n0, int k0, int g, int t,
                                              float (&part)[2][4]) {
#pragma unroll
  for (int kk = 0; kk < tc::kProdK; kk += 8) {
    const tc::FragA fa = tc::load_a<false>(As, lda, m0, k0 + kk, g, t);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const tc::FragB fb = tc::load_b<true>(Ws, kCols + tc::kPad, n0 + 8 * j, k0 + kk, g, t);
      if (kk == 0) {
        tc::mma3_zero(part[j], fa, fb);
      } else {
        tc::mma3(part[j], fa, fb);
      }
    }
  }
}

// out = A W + bias (relu'd with kRelu) for the block's kRows x 32 tile at
// batch row b0 and column n0, a warp per 16 x 16 piece: A rows of a [B, H]
// matrix, W an [H, H] weight in [in, out] layout. With key_mask [B, M], a row
// whose key column `key` is masked gets the bias alone (attention weight 0:
// the out-projection sees zeros and leaves its bias). W, the bias and the
// mask are read before the wait for the predecessor; A, which it may have
// written, after. kSlabs (H above kSlabK): K staged in slabs of kSlabK, a
// separate instantiation so that the one-slab product keeps its registers.
template <int kRows, bool kRelu, bool kSlabs>
__device__ __forceinline__ void product_tile(const float* __restrict__ A,
                                             const float* __restrict__ W,
                                             const float* __restrict__ bias,
                                             const float* __restrict__ key_mask, int key, int M,
                                             float* __restrict__ out, int B, int H, int b0,
                                             int n0, float* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  constexpr int kThreads = product_threads(kRows);
  const int Kp = padded_k(H), Ks = kSlabs ? kSlabK : Kp;  // slab_k(H)
  const int lda = Ks + tc::kRowKPad, ldw = kCols + tc::kPad;
  float* As = smem;
  float* Ws = smem + kRows * lda;
  constexpr int kQuads = kCols / 4;
  // rows [s0, s0 + Ks) of W into Ws, and of A's columns into As
  auto stage_w = [&](int s0) {
    for (int i = tid; i < Ks * kQuads; i += kThreads) {
      const int k = s0 + i / kQuads, c = i % kQuads * 4;
      const bool ok = k < H && n0 + c < H;
      tc::cp_async16(Ws + (k - s0) * ldw + c, ok ? W + (long)k * H + n0 + c : W, ok);
    }
    tc::cp_async_commit();
  };
  auto stage_a = [&](int s0) {
    const int quads = Ks / 4;
    for (int i = tid; i < kRows * quads; i += kThreads) {
      const int r = i / quads, k = s0 + i % quads * 4;
      const bool ok = b0 + r < B && k < H;
      tc::cp_async16(As + r * lda + k - s0, ok ? A + (long)(b0 + r) * H + k : A, ok);
    }
    tc::cp_async_commit();
  };
  stage_w(0);
  // this thread's rows 16 (w / 2) + g, + 8 and columns 16 (w % 2) + 8 j + 2 t, + 1
  const int m0 = warp / 2 * 16, c0 = warp % 2 * 16;
  float bv[2][2];
  bool kept[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + c0 + 8 * j + 2 * t + e;
      bv[j][e] = n < H ? bias[n] : 0.f;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = b0 + m0 + g + 8 * h;
    kept[h] = !key_mask || (b < B && key_mask[(long)b * M + key] > 0.f);
  }
  wait_for_predecessor();
  stage_a(0);
  tc::cp_async_wait<0>();
  __syncthreads();
  float acc[2][4] = {};
  auto multiply = [&](int k_len) {  // the staged slab's first k_len
    for (int k0 = 0; k0 < k_len; k0 += 2 * tc::kProdK) {  // two independent chains
      float p0[2][4], p1[2][4];
      chunk_product(As, lda, Ws, m0, c0, k0, g, t, p0);
      chunk_product(As, lda, Ws, m0, c0, k0 + tc::kProdK, g, t, p1);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = acc[j][e] + p0[j][e] + p1[j][e];
    }
  };
  multiply(Ks);
  if constexpr (kSlabs) {
    for (int s0 = Ks; s0 < Kp; s0 += Ks) {
      __syncthreads();  // every warp is done with the last slab
      stage_w(s0);
      stage_a(s0);
      tc::cp_async_wait<0>();
      __syncthreads();
      multiply(min(Ks, Kp - s0));
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // accumulator layout: rows g, g + 8; columns 2t, 2t + 1
      const int b = b0 + m0 + g + 8 * (e >> 1), n = n0 + c0 + 8 * j + 2 * t + (e & 1);
      if (b >= B || n >= H) continue;
      const float bias_n = bv[j][e & 1];
      const float y = kept[e >> 1] ? acc[j][e] + bias_n : bias_n;
      out[(long)b * H + n] = kRelu ? fmaxf(y, 0.f) : y;
    }
}

// v_p = e_k(p) Wv_p + bv_p; blockIdx = (pair, column tile, batch tile)
template <bool kSlabs>
__global__ void __launch_bounds__(product_threads(kPairRows))
fusion_head_pairs_kernel(const float* __restrict__ e, const float* __restrict__ wv,
                         const float* __restrict__ bv, float* __restrict__ v, int M, int B,
                         int H) {
  extern __shared__ __align__(16) float smem[];
  launch_dependents();
  const long p = blockIdx.x;
  product_tile<kPairRows, false, kSlabs>(e + (long)key_of(p, M) * B * H, wv + p * H * H,
                                         bv + p * H, nullptr, 0, M, v + p * B * H, B, H,
                                         blockIdx.z * kPairRows, blockIdx.y * kCols, smem);
}

// att_p = v_p Wo_p + bo_p, or bo_p where key k(p) is masked
template <bool kSlabs>
__global__ void __launch_bounds__(product_threads(kPairRows))
fusion_head_att_kernel(const float* __restrict__ v, const float* __restrict__ mask,
                       const float* __restrict__ wo, const float* __restrict__ bo,
                       float* __restrict__ att, int M, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  launch_dependents();
  const long p = blockIdx.x;
  product_tile<kPairRows, false, kSlabs>(v + p * B * H, wo + p * H * H, bo + p * H, mask,
                                         key_of(p, M), M, att + p * B * H, B, H,
                                         blockIdx.z * kPairRows, blockIdx.y * kCols, smem);
}

int gate_smem_floats(int M, int H) {
  // e and att rows [M + P][H] (M + P = M^2), wg [M][H], mask and gate [M]
  return (M * M + M) * H + 2 * M;
}

// For batch row b = blockIdx.x: agg_q = (e_q + the att_p of q's pairs, in
// query-major order) / M * mask_q; the gate scores agg_q . wg_q + bg_q; the
// adaptive gate weights w; fused = sum_q w_q agg_q. A row a block, so that
// each SM has little to take in. kStaged: every operand staged into shared
// memory by cp.async first, the embeddings, wg and the mask before the wait
// for the att kernel, and agg computed in place; else (a row's operands
// exceed a block's shared memory) only the mask and the gate there, and agg
// recomputed from device memory where it is read, in the same order.
template <bool kStaged>
__global__ void __launch_bounds__(kThreadsG)
fusion_head_gate_kernel(const float* __restrict__ e, const float* __restrict__ att,
                        const float* __restrict__ mask, const float* __restrict__ wg,
                        const float* __restrict__ bg, float* __restrict__ fused, int M,
                        int B, int H) {
  extern __shared__ __align__(16) float smem[];
  launch_dependents();
  const int P = M * (M - 1), b = blockIdx.x;
  float* x = smem;                                 // [M + P][H]: e rows, then att rows
  float* wgs = x + (kStaged ? (M + P) * H : 0);    // [M][H]
  float* msk = wgs + (kStaged ? M * H : 0);        // [M]
  float* gate = msk + M;                           // [M]: scores, then weights
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, n_warps = blockDim.x >> 5;
  // rows t in [t_begin, t_end) of x: a warp per row, 16 bytes a lane
  auto stage_rows = [&](int t_begin, int t_end, const float* src) {
    for (int t = t_begin + warp; t < t_end; t += n_warps)
      for (int c = 4 * lane; c < H; c += 128)
        tc::cp_async16(x + t * H + c, src + ((long)(t - t_begin) * B + b) * H + c, true);
  };
  // agg_q at column n from device memory (not kStaged)
  auto agg = [&](int q, int n) {
    float total = e[((long)q * B + b) * H + n];
    for (int kk = 0; kk < M - 1; ++kk) total += att[((long)(q * (M - 1) + kk) * B + b) * H + n];
    return total / (float)M * msk[q];
  };
  if constexpr (kStaged) {
    stage_rows(0, M, e);
    for (int i = tid; i < M * H; i += kThreadsG) tc::cp_async4(wgs + i, wg + i, true);
  }
  for (int i = tid; i < M; i += kThreadsG) tc::cp_async4(msk + i, mask + (long)b * M + i, true);
  tc::cp_async_commit();
  wait_for_predecessor();
  if constexpr (kStaged) {
    stage_rows(M, M + P, att);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  if constexpr (kStaged) {
    for (int n = tid; n < H; n += kThreadsG)
      for (int q = 0; q < M; ++q) {
        float total = x[q * H + n];
        for (int kk = 0; kk < M - 1; ++kk) total += x[(M + q * (M - 1) + kk) * H + n];
        x[q * H + n] = total / (float)M * msk[q];
      }
    __syncthreads();
  }
  // agg_q at column n, and wg_q's
  auto agg_at = [&](int q, int n) { return kStaged ? x[q * H + n] : agg(q, n); };
  auto wg_at = [&](int q, int n) { return kStaged ? wgs[q * H + n] : wg[q * H + n]; };
  for (int m = warp; m < M; m += n_warps) {  // warp-uniform
    float s = 0.f;
    for (int n = lane; n < H; n += 32) s = fmaf(agg_at(m, n), wg_at(m, n), s);
    s = msfa_ln::warp_sum(s);
    if (lane == 0) gate[m] = s + bg[m];
  }
  __syncthreads();
  if (tid == 0) {  // adaptive_gate_weights (M is small)
    float row_max = -INFINITY;
    for (int m = 0; m < M; ++m) row_max = fmaxf(row_max, msk[m] > 0.f ? gate[m] : -INFINITY);
    const float safe_max = isfinite(row_max) ? row_max : 0.f;
    float denom = 0.f;
    for (int m = 0; m < M; ++m) {
      const float s = msk[m] > 0.f ? gate[m] : -INFINITY;
      gate[m] = isfinite(s) ? expf(s - safe_max) : 0.f;
      denom += gate[m];
    }
    float sums = 0.f, mask_sum = 0.f;
    for (int m = 0; m < M; ++m) {
      gate[m] = (denom > 0.f ? gate[m] / denom : 0.f) * msk[m];
      sums += gate[m];
      mask_sum += msk[m];
    }
    for (int m = 0; m < M; ++m) {
      const float fallback = mask_sum > 0.f ? msk[m] / (mask_sum + 1e-8f) : 1.f / (float)M;
      gate[m] = sums > 0.f ? gate[m] / (sums + 1e-8f) : fallback;
    }
  }
  __syncthreads();
  for (int n = tid; n < H; n += kThreadsG) {
    float f = agg_at(0, n) * gate[0];
    for (int m = 1; m < M; ++m) f += agg_at(m, n) * gate[m];
    fused[(long)b * H + n] = f;
  }
}

// hidden = relu(fused W1 + b1); blockIdx = (column tile, batch tile)
template <bool kSlabs>
__global__ void __launch_bounds__(product_threads(kHiddenRows))
fusion_head_hidden_kernel(const float* __restrict__ fused, const float* __restrict__ w1,
                          const float* __restrict__ b1, float* __restrict__ hidden, int B,
                          int H) {
  extern __shared__ __align__(16) float smem[];
  launch_dependents();
  product_tile<kHiddenRows, true, kSlabs>(fused, w1, b1, nullptr, 0, 0, hidden, B, H,
                                          blockIdx.y * kHiddenRows, blockIdx.x * kCols, smem);
}

int logits_smem_floats(int H, int C) { return kRowsL * H + H * C; }

// logits = hidden W2 + b2 for the block's kRowsL rows, a thread per (row,
// class). kStaged: from W2 and the rows staged into shared memory by
// cp.async (W2 before the wait for the hidden kernel); else (they exceed a
// block's shared memory) from device memory, in the same order.
template <bool kStaged>
__global__ void __launch_bounds__(kThreadsG)
fusion_head_logits_kernel(const float* __restrict__ hidden, const float* __restrict__ w2,
                          const float* __restrict__ b2, float* __restrict__ logits, int B,
                          int H, int C) {
  extern __shared__ __align__(16) float smem[];
  const int r0 = blockIdx.x * kRowsL, rows = min(kRowsL, B - r0), tid = threadIdx.x;
  const float* h = hidden + (long)r0 * H;  // [kRowsL][H]
  const float* w = w2;                     // [H][C]
  if constexpr (kStaged) {
    float* hs = smem;
    float* ws = hs + kRowsL * H;
    for (int i = tid; i < H * C; i += kThreadsG) tc::cp_async4(ws + i, w2 + i, true);
    tc::cp_async_commit();
    wait_for_predecessor();
    for (int i = 4 * tid; i < rows * H; i += 4 * kThreadsG)
      tc::cp_async16(hs + i, hidden + (long)r0 * H + i, true);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    h = hs;
    w = ws;
  } else {
    wait_for_predecessor();
  }
  for (int i = tid; i < rows * C; i += kThreadsG) {
    const int r = i / C, c = i % C;
    float s = 0.f;
    for (int n = 0; n < H; ++n) s = fmaf(h[r * H + n], w[n * C + c], s);
    logits[(long)(r0 + r) * C + c] = s + b2[c];
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Launch kernel on s; `dependent`: as a programmatic dependent launch, which
// may start before its predecessor on the stream ends (the kernel waits for
// it with griddepcontrol.wait before it reads what the predecessor wrote).
template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads, int smem_floats,
                   cudaStream_t s, bool dependent, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = (size_t)smem_floats * sizeof(float);
  config.stream = s;
  config.attrs = attr;
  config.numAttrs = dependent ? 1 : 0;
  const cudaError_t err = msfa_ln::allow_smem(kernel, smem_floats);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
}

}  // namespace

extern "C" {

// scratch: (2P + 2) * B * H floats (v and att [P, B, H], fused and hidden
// [B, H]). M >= 2 and H a multiple of 4 (any M, H and C: the products stage
// K in slabs, and the gate and logits kernels read device memory where
// their operands exceed shared memory); the operands the kernels copy 16
// bytes at a time (projected, the pair weights, W1, scratch) 16-byte
// aligned.
int msfa_fusion_head(const float* projected, const float* mask, const float* wv,
                     const float* bv, const float* wo, const float* bo,
                     const float* wg, const float* bg, const float* w1,
                     const float* b1, const float* w2, const float* b2,
                     float* logits, float* scratch, int M, int B, int H, int C,
                     void* stream) {
  if (M <= 0 || B <= 0 || H <= 0 || C <= 0 || H % 4 || 2 * M > kSmemFloats)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(projected) || !aligned16(wv) || !aligned16(wo) || !aligned16(w1) ||
      !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = M * (M - 1);
  float* v = scratch;
  float* att = v + (long)P * B * H;
  float* fused = att + (long)P * B * H;
  float* hidden = fused + (long)B * H;
  const int pair_smem = product_smem_floats(kPairRows, H);
  const int hidden_smem = product_smem_floats(kHiddenRows, H);
  const int tiles = (H + kCols - 1) / kCols, logit_blocks = (B + kRowsL - 1) / kRowsL;
  const dim3 pair_grid(P, tiles, (B + kPairRows - 1) / kPairRows);
  const dim3 hidden_grid(tiles, (B + kHiddenRows - 1) / kHiddenRows);
  // the first launch waits for the stream as any launch does
  bool dependent = false;
  const bool slabs = padded_k(H) > kSlabK;
  if (P > 0) {
    MSFA_TRY(launch(slabs ? fusion_head_pairs_kernel<true> : fusion_head_pairs_kernel<false>,
                    pair_grid, product_threads(kPairRows), pair_smem, s, false, projected, wv, bv,
                    v, M, B, H));
    MSFA_TRY(launch(slabs ? fusion_head_att_kernel<true> : fusion_head_att_kernel<false>,
                    pair_grid, product_threads(kPairRows), pair_smem, s, true, v, mask, wo, bo,
                    att, M, B, H));
    dependent = true;
  }
  const bool gate_staged = gate_smem_floats(M, H) <= kSmemFloats;
  MSFA_TRY(launch(gate_staged ? fusion_head_gate_kernel<true> : fusion_head_gate_kernel<false>,
                  dim3(B), kThreadsG, gate_staged ? gate_smem_floats(M, H) : 2 * M, s,
                  dependent, projected, att, mask, wg, bg, fused, M, B, H));
  MSFA_TRY(launch(slabs ? fusion_head_hidden_kernel<true> : fusion_head_hidden_kernel<false>,
                  hidden_grid, product_threads(kHiddenRows), hidden_smem, s, true, fused, w1, b1,
                  hidden, B, H));
  const bool logits_staged = logits_smem_floats(H, C) <= kSmemFloats;
  MSFA_TRY(launch(logits_staged ? fusion_head_logits_kernel<true>
                                : fusion_head_logits_kernel<false>,
                  dim3(logit_blocks), kThreadsG, logits_staged ? logits_smem_floats(H, C) : 0, s,
                  true, hidden, w2, b2, logits, B, H, C));
  return 0;
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
