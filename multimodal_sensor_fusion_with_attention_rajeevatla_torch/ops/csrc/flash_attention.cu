// Self-attention forward on the [B*H, T, D] layout, f32, for Hopper (sm_90a):
// the single-key-block kernel and the tiled online-softmax kernel.
//
// Replaces: multimodal_sensor_fusion_with_attention_rajeevatla_tpu/ops/pallas_attention.py
//   _fwd_single_kblock_kernel (flash_fwd_single_kernel below) and
//   _flash_kernel (flash_fwd_tiled_kernel below), both launched by
//   _flash_forward and reached by flash_self_attention.
//
// Both compute, for every row bh = b*H + h of q, k, v [B*H, T, D]:
//   s    = (q * sm_scale) k^T            key columns >= lengths[b] masked
//   out  = softmax(s) v                  [B*H, T, D]
//   lse  = rowmax(s) + log(rowsum(exp))  [B*H, T]
// Query rows are not masked. A row with no valid key gives exact zeros in out
// and -1e30 in lse, as the TPU kernels do. T is any positive length: the
// kernels mask the ragged last tile themselves.
//
// What bounds them on the H100: arithmetic. With sum_len valid keys over the
// batch one launch does 4*H*D*T*sum_len operations (34.4 GFLOP at B=32, H=4,
// D=64, T=1024 with every key valid) against 4 * 4*B*H*T*D bytes (134 MB,
// 0.04 ms at 3.35 TB/s). The TPU kernels fed bf16 to the matrix unit; the
// port's limits are f32's (1e-4), which bf16 and one TF32 product miss.
//
// flash_fwd_single_kernel runs both products on the TF32 tensor cores at f32
// accuracy, three mma.sync TF32 products per f32 product (3xTF32):
// 0.21 ms for that shape at 495/3 = 165 TFLOP/s, against 0.51 ms at 67
// TFLOP/s on the CUDA cores. The TPU kernel sees the whole key axis at once
// and skips the running rescale because VMEM holds [block_q, T] scores; in
// a block's shared memory those scores would leave one block per SM and cap
// T. So it is an online softmax over 64-key tiles with one rescale per tile,
// in registers, one block of 4 warps per 64 query rows: the body in
// attention_fwd.cuh, which packed_attention_fwd_kernel shares on the packed
// layout. Any T.
//
// flash_fwd_tiled_kernel is the online softmax on the CUDA cores: one block
// per 64-query tile, running max and sum in registers, the accumulator
// rescaled per 64-key tile; the score matrix never exists beyond one 64 x 64
// tile.
//
// Both: key tiles at or past the row's length skipped, every processed tile
// holds at least one valid key. Offsets into q/k/v/out are 64-bit: [256,
// 4096, 64] is 67 M elements per tensor.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_fwd.cuh"

namespace {

constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- single ----

// One block per (64-query tile, row bh); the body is attention_fwd.cuh's.
template <int D>
__global__ void __launch_bounds__(msfa_tc::kFwdThreads)
flash_fwd_single_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ lengths,
                        float* __restrict__ out, float* __restrict__ lse, int T, int H,
                        int q_tiles, float sm_scale) {
  extern __shared__ __align__(16) float single_smem[];
  const long bh = blockIdx.x / q_tiles;
  const int q0 = (int)(blockIdx.x % q_tiles) * msfa_tc::kFwdTileQ;
  const long at = bh * T * D;
  int len = lengths[bh / H];
  len = len < 0 ? 0 : (len > T ? T : len);
  const msfa_tc::FwdRow row{q + at, k + at, v + at, D, out + at, D, lse + bh * T, 1};
  msfa_tc::attention_fwd_tile<D>(row, T, len, q0, sm_scale, single_smem);
}

template <int D>
int launch_single(const float* q, const float* k, const float* v, const int* lengths, float* out,
                  float* lse, long BH, int T, int H, float sm_scale, cudaStream_t stream) {
  const size_t smem = msfa_tc::fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_single_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (T + msfa_tc::kFwdTileQ - 1) / msfa_tc::kFwdTileQ;
  const long blocks = BH * q_tiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  flash_fwd_single_kernel<D><<<(unsigned)blocks, msfa_tc::kFwdThreads, smem, stream>>>(
      q, k, v, lengths, out, lse, T, H, q_tiles, sm_scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- tiled ----

constexpr int kBlockQ = 64;

template <int D>
constexpr size_t tiled_smem_bytes() {
  // Qs [BQ][D], Ks [BK][D+1], Vs [BK][D], Ps [BQ][BK+1]
  return sizeof(float) *
         (kBlockQ * D + kBlockK * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const int* __restrict__ lengths,
                       float* __restrict__ out, float* __restrict__ lse, int T, int H,
                       int q_tiles, float sm_scale) {
  constexpr int kDJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * D;
  float* Vs = Ks + kBlockK * (D + 1);
  float* Ps = Vs + kBlockK * D;

  const long bh = blockIdx.x / q_tiles;
  const int q0 = (int)(blockIdx.x % q_tiles) * kBlockQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key / output-column group
  const int ty = tid >> 4;  // query rows ty*4 .. ty*4+3
  const float* qb = q + bh * T * D;
  const float* kb = k + bh * T * D;
  const float* vb = v + bh * T * D;

  int len = lengths[bh / H];
  len = len < 0 ? 0 : (len > T ? T : len);

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int t = q0 + i / D;
    Qs[i] = t < T ? qb[(long)t * D + i % D] * sm_scale : 0.f;
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
      const bool ok = t < T;
      Ks[r * (D + 1) + c] = ok ? kb[(long)t * D + c] : 0.f;
      Vs[r * D + c] = ok ? vb[(long)t * D + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * D + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
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
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * rescale + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDJ; ++j) acc[i][j] *= rescale;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float vv[kDJ];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * (kBlockK + 1) + kk];
#pragma unroll
        for (int j = 0; j < kDJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= T) continue;
    float* orow = out + (bh * T + t) * D;
    const bool any = l[i] > 0.f;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) orow[tx + 16 * j] = any ? acc[i][j] / l[i] : 0.f;
    if (tx == 0) lse[bh * T + t] = any ? m[i] + logf(l[i]) : kNegInf;
  }
}

template <int D>
int launch_tiled(const float* q, const float* k, const float* v, const int* lengths, float* out,
                 float* lse, long BH, int T, int H, float sm_scale, cudaStream_t stream) {
  const size_t smem = tiled_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tiled_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (T + kBlockQ - 1) / kBlockQ;
  const long blocks = BH * q_tiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  flash_fwd_tiled_kernel<D><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, lengths, out, lse, T, H, q_tiles, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: [B*H, T, D] f32; lengths: [B] int32; lse: [B*H, T] f32.
// Head dims the kernels are instantiated for; the wrapper checks before calling.
int msfa_flash_fwd_single(const float* q, const float* k, const float* v, const int* lengths,
                          float* out, float* lse, int B, int T, int H, int D, float sm_scale,
                          void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long BH = (long)B * H;
  switch (D) {
    case 16: return launch_single<16>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, s);
    case 32: return launch_single<32>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, s);
    case 64: return launch_single<64>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, s);
    case 128: return launch_single<128>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int msfa_flash_fwd_tiled(const float* q, const float* k, const float* v, const int* lengths,
                         float* out, float* lse, int B, int T, int H, int D, float sm_scale,
                         void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long BH = (long)B * H;
  switch (D) {
    case 16: return launch_tiled<16>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, s);
    case 32: return launch_tiled<32>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, s);
    case 64: return launch_tiled<64>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, s);
    case 128: return launch_tiled<128>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
