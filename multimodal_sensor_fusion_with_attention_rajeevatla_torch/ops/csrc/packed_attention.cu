// Packed multi-head self-attention forward, f32, for Hopper (sm_90a).
//
// Replaces: multimodal_sensor_fusion_with_attention_rajeevatla_tpu/ops/pallas_attention.py
//   _packed_fwd_kernel (launched by _packed_forward, reached by flash_mha_packed).
//
// Computes, for every batch row b and head h of the packed projection
// qkv [B, T, 3F] (q | k | v along the minor dim, head h at columns h*D..h*D+D
// inside each third, F = H*D):
//   s    = (q * sm_scale) k^T            key columns >= lengths[b] masked
//   out  = softmax(s) v                  [B, T, F]
//   lse  = rowmax(s) + log(rowsum(exp))  [B, T, H]
// A row with no valid key gives exact zeros in out and -1e30 in lse, as the
// TPU kernel does.
//
// What bounds it on the H100: arithmetic. At the serving shape (B=64, T=512,
// H=4, D=64) with every key valid one launch does 4*B*H*T*T*D = 17.2 GFLOP
// and moves 135 MB (qkv in, out and lse back); in f32 on the CUDA cores
// (67 TFLOP/s) that is ~0.26 ms against ~0.04 ms for the bytes at 3.35 TB/s.
// The TPU kernel fed bf16 to the MXU; this first version stays
// in f32 throughout (operands, scores, accumulators), so it is right before
// it is fast. wgmma on bf16 tiles with TMA loads is later work.
//
// Design: one block per (64-query tile, head, batch row), 256 threads as a
// 16 x 16 grid. Q is loaded once, pre-scaled; K and V stream through shared
// memory in 64-key tiles read straight from the strided packed layout (each
// tile row is D contiguous floats, no transpose pass). Each thread owns a
// 4-query x 4-key score micro-tile and a 4-query x D/16 output micro-tile.
// The softmax is online (running max and sum in registers, rescaled per
// tile), so the [T, T] score matrix never exists. Key tiles at or past the
// row's length are skipped: a length-0 row runs no tile and takes the
// exact-zero branch, and a length that is not a multiple of 64 masks the
// tail of its last tile. Every processed tile holds at least one valid key,
// so the running max is finite after the first tile and no inf - inf occurs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  // Qs [BQ][D], Ks [BK][D+1], Vs [BK][D], Ps [BQ][BK+1]
  return sizeof(float) *
         (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
packed_attention_fwd_kernel(const float* __restrict__ qkv,
                            const int* __restrict__ lengths,
                            float* __restrict__ out, float* __restrict__ lse,
                            int T, int H, float sm_scale) {
  constexpr int kDJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * D;
  float* Vs = Ks + kBlockK * (D + 1);
  float* Ps = Vs + kBlockK * D;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key / output-column group
  const int ty = tid >> 4;  // query rows ty*4 .. ty*4+3
  const int F = H * D;
  const long row_stride = 3L * F;
  const float* base = qkv + (long)b * T * row_stride + h * D;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > T ? T : len);

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    Qs[i] = t < T ? base[(long)t * row_stride + c] * sm_scale : 0.f;
  }

  float m[4], l[4], acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (len + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // previous tile's P.V reads of Ks/Vs/Ps are done
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D, t = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < T) {
        const float* row = base + (long)t * row_stride + c;
        kv = row[F];
        vv = row[2 * F];
      }
      Ks[r * (D + 1) + c] = kv;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], k[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * D + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) k[j] = Ks[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], k[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= len) s[i][j] = -INFINITY;
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      // the 16 threads of one query-row group are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(m[i], tile_max);
      const float rescale = expf(m[i] - m_new);  // 0 on the first tile
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (k0 + tx + 16 * j < len) ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * (kBlockK + 1) + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * rescale + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDJ; ++j) acc[i][j] *= rescale;
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < kBlockK; ++k) {
      float v[kDJ];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) v[j] = Vs[k * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * (kBlockK + 1) + k];
#pragma unroll
        for (int j = 0; j < kDJ; ++j) acc[i][j] = fmaf(p, v[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= T) continue;
    float* orow = out + ((long)b * T + t) * F + h * D;
    const bool any = l[i] > 0.f;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) orow[tx + 16 * j] = any ? acc[i][j] / l[i] : 0.f;
    if (tx == 0) lse[((long)b * T + t) * H + h] = any ? m[i] + logf(l[i]) : kNegInf;
  }
}

template <int D>
int launch(const float* qkv, const int* lengths, float* out, float* lse, int B,
           int T, int H, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      packed_attention_fwd_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kBlockQ - 1) / kBlockQ, H, B);
  packed_attention_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      qkv, lengths, out, lse, T, H, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Head dims the kernel is instantiated for; the wrapper checks before calling.
int msfa_packed_attention_fwd(const float* qkv, const int* lengths, float* out,
                              float* lse, int B, int T, int H, int D,
                              float sm_scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(qkv, lengths, out, lse, B, T, H, sm_scale, s);
    case 32: return launch<32>(qkv, lengths, out, lse, B, T, H, sm_scale, s);
    case 64: return launch<64>(qkv, lengths, out, lse, B, T, H, sm_scale, s);
    case 128: return launch<128>(qkv, lengths, out, lse, B, T, H, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
