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
// What bounds it on the H100: at batch 64 the 2P pair matrices (P=12,
// H=256) are 6.3 MB against 0.21 GFLOP, ~32 operations per byte: in f32 on
// the CUDA cores that is ~3 us of arithmetic against ~2 us of HBM traffic,
// so the work is tiny and what bounds a real launch is how much of the card
// it can keep busy. The TPU kept all weights resident in VMEM; an SM holds
// 227 KB, so here the weights stream. Each block owns a tile of
// 4 batch rows and 256 threads; thread n owns output column n of every
// product, so each weight element is read by exactly one thread, coalesced
// across the warp, straight into registers and used for the block's 4 rows
// (nothing to gain from a shared-memory copy that no other thread reads).
// The activations of the block's rows (e, the per-pair v, agg, fused,
// hidden) live in shared memory and are read as broadcasts. At batch 64
// this is 16 blocks on 132 SMs, each streaming the whole 6.3 MB through a
// chain of dependent loads: the launch is bound by load latency on a few
// SMs, two orders of magnitude above the card's bound. Spreading the pairs
// and the columns over more blocks (a second pass for the gate) and bf16
// weights are later work.
//
// Rows of the last tile beyond the batch are loaded as zeros with mask 1
// and never written, so padding cannot leak into real rows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 4;  // batch rows per block
constexpr int kThreads = 256;

size_t smem_bytes(int M, int H) {
  // e [M][R][H], agg [M][R][H], v / fused / hidden [R][H], mask + weights [R][M]
  return sizeof(float) *
         ((size_t)2 * M * kRows * H + (size_t)3 * kRows * H + (size_t)2 * kRows * M);
}

// y[r][n] = sum_j x[r][j] * W[j][n] for the block's rows, n owned by this thread
__device__ __forceinline__ void row_tile_matvec(const float* x, const float* __restrict__ W,
                                                int K, int N, int n, float acc[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int j = 0; j < K; ++j) {
    const float w = __ldg(W + (long)j * N + n);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(x[r * K + j], w, acc[r]);
  }
}

__global__ void __launch_bounds__(kThreads)
fusion_head_kernel(const float* __restrict__ projected, const float* __restrict__ mask,
                   const float* __restrict__ wv, const float* __restrict__ bv,
                   const float* __restrict__ wo, const float* __restrict__ bo,
                   const float* __restrict__ wg, const float* __restrict__ bg,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   float* __restrict__ logits, int M, int B, int H, int C) {
  extern __shared__ float smem[];
  float* e = smem;                      // [M][R][H]
  float* agg = e + M * kRows * H;       // [M][R][H]
  float* v = agg + M * kRows * H;       // [R][H]
  float* fused = v + kRows * H;         // [R][H]
  float* hidden = fused + kRows * H;    // [R][H]
  float* msk = hidden + kRows * H;      // [R][M]
  float* gate = msk + kRows * M;        // [R][M] scores, then weights

  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const long HH = (long)H * H;

  for (int i = tid; i < M * kRows * H; i += blockDim.x) {
    const int m = i / (kRows * H), r = (i / H) % kRows, n = i % H;
    e[i] = r0 + r < B ? projected[((long)m * B + r0 + r) * H + n] : 0.f;
  }
  for (int i = tid; i < kRows * M; i += blockDim.x) {
    const int r = i / M, m = i % M;
    msk[i] = r0 + r < B ? mask[(long)(r0 + r) * M + m] : 1.f;
  }
  __syncthreads();

  float acc[kRows];
  for (int q = 0; q < M; ++q) {
    float* agg_q = agg + q * kRows * H;
    for (int n = tid; n < H; n += blockDim.x)
#pragma unroll
      for (int r = 0; r < kRows; ++r) agg_q[r * H + n] = e[(q * kRows + r) * H + n];
    for (int kk = 0; kk < M - 1; ++kk) {
      const int k = kk < q ? kk : kk + 1;
      const int p = q * (M - 1) + kk;  // query-major ordered pairs
      __syncthreads();                 // v of the previous pair fully consumed
      for (int n = tid; n < H; n += blockDim.x) {
        row_tile_matvec(e + k * kRows * H, wv + p * HH, H, H, n, acc);
        const float bias = bv[(long)p * H + n];
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r * H + n] = acc[r] + bias;
      }
      __syncthreads();
      for (int n = tid; n < H; n += blockDim.x) {
        row_tile_matvec(v, wo + p * HH, H, H, n, acc);
        const float bias = bo[(long)p * H + n];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          // a masked key has attention weight 0: the out-projection sees
          // zeros and leaves its bias
          const float att = msk[r * M + k] > 0.f ? acc[r] + bias : bias;
          agg_q[r * H + n] += att;
        }
      }
    }
    // agg_q columns are owned by the same thread throughout: no barrier needed
    for (int n = tid; n < H; n += blockDim.x)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        agg_q[r * H + n] = agg_q[r * H + n] / (float)M * msk[r * M + q];
  }
  __syncthreads();

  // gate scores: one warp per (row, modality), lanes stride over H
  const int warp = tid >> 5, lane = tid & 31, n_warps = blockDim.x >> 5;
  for (int i = warp; i < kRows * M; i += n_warps) {
    const int r = i / M, m = i % M;
    float s = 0.f;
    for (int n = lane; n < H; n += 32) s = fmaf(agg[(m * kRows + r) * H + n], wg[(long)m * H + n], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) gate[r * M + m] = s + bg[m];
  }
  __syncthreads();

  // adaptive_gate_weights, one thread per row (M is small)
  if (tid < kRows) {
    float* g = gate + tid * M;
    const float* mk = msk + tid * M;
    float row_max = -INFINITY;
    for (int m = 0; m < M; ++m) row_max = fmaxf(row_max, mk[m] > 0.f ? g[m] : -INFINITY);
    const float safe_max = isfinite(row_max) ? row_max : 0.f;
    float denom = 0.f;
    for (int m = 0; m < M; ++m) {
      const float s = mk[m] > 0.f ? g[m] : -INFINITY;
      g[m] = isfinite(s) ? expf(s - safe_max) : 0.f;
      denom += g[m];
    }
    float sums = 0.f, mask_sum = 0.f;
    for (int m = 0; m < M; ++m) {
      g[m] = (denom > 0.f ? g[m] / denom : 0.f) * mk[m];
      sums += g[m];
      mask_sum += mk[m];
    }
    for (int m = 0; m < M; ++m) {
      const float fallback = mask_sum > 0.f ? mk[m] / (mask_sum + 1e-8f) : 1.f / (float)M;
      g[m] = sums > 0.f ? g[m] / (sums + 1e-8f) : fallback;
    }
  }
  __syncthreads();

  for (int n = tid; n < H; n += blockDim.x)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float f = agg[r * H + n] * gate[r * M];
      for (int m = 1; m < M; ++m) f += agg[(m * kRows + r) * H + n] * gate[r * M + m];
      fused[r * H + n] = f;
    }
  __syncthreads();

  for (int n = tid; n < H; n += blockDim.x) {
    row_tile_matvec(fused, w1, H, H, n, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) hidden[r * H + n] = fmaxf(acc[r] + b1[n], 0.f);
  }
  __syncthreads();

  for (int c = tid; c < C; c += blockDim.x) {
    row_tile_matvec(hidden, w2, H, C, c, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r0 + r < B) logits[(long)(r0 + r) * C + c] = acc[r] + b2[c];
  }
}

}  // namespace

extern "C" {

int msfa_fusion_head(const float* projected, const float* mask, const float* wv,
                     const float* bv, const float* wo, const float* bo,
                     const float* wg, const float* bg, const float* w1,
                     const float* b1, const float* w2, const float* b2,
                     float* logits, int M, int B, int H, int C, void* stream) {
  if (M <= 0 || B <= 0 || H <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(M, H);
  cudaError_t err = cudaFuncSetAttribute(
      fusion_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kRows - 1) / kRows);
  fusion_head_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      projected, mask, wv, bv, wo, bo, wg, bg, w1, b1, w2, b2, logits, M, B, H, C);
  return (int)cudaGetLastError();
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
