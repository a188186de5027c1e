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
// D=64, T=1024 with every key valid: 0.51 ms at 67 TFLOP/s f32 on the CUDA
// cores) against 4 * 4*B*H*T*D bytes (134 MB, 0.04 ms at 3.35 TB/s). The TPU
// kernels fed bf16 to the matrix unit; these first versions stay in f32
// throughout. wgmma on bf16 tiles with TMA loads is later work.
//
// flash_fwd_single_kernel keeps what the TPU kernel is about: the whole key
// axis is visible at once, so there is one max, one exp and one normalise per
// score row and no running rescale. The TPU kernel holds a [block_q, T] score
// tile in VMEM; a block here has at most 227 KB of shared memory, so one
// block owns R = 32 query rows (R = 16 when 32 full score rows do not fit:
// above T = 1408 at D = 64) and their R x T scores live in shared memory
// while K, then V, stream through a 128-key tile buffer: pass 1 writes the
// scores and tracks the row max, the exp pass rewrites them as p and sums the
// row, pass 2 is P.V. A score row belongs to one warp and each lane meets
// only scores it wrote itself before P.V, so the block synchronises once
// between the exp pass and P.V. The scores take most of the SM's shared
// memory, so one block of 8 warps runs per SM: that, not the arithmetic, is
// what holds this kernel back.
//
// flash_fwd_tiled_kernel is the online softmax: one block per 64-query tile,
// running max and sum in registers, the accumulator rescaled per 64-key tile;
// the score matrix never exists beyond one 64 x 64 tile.
//
// Both: 256 threads, key tiles at or past the row's length skipped, every
// processed tile holds at least one valid key. Offsets into q/k/v/out are
// 64-bit: [256, 4096, 64] is 67 M elements per tensor.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most a block may ask for

// ---------------------------------------------------------------- single ----

constexpr int kSingleK = 128;  // keys per streamed tile of the single-key-block kernel

template <int D, int R>
size_t single_smem_bytes(int T) {
  const int key_tiles = (T + kSingleK - 1) / kSingleK;
  // Qs [R][D], KVs [TK][D+1], Ss [R][key_tiles * TK]
  return sizeof(float) *
         ((size_t)R * D + kSingleK * (D + 1) + (size_t)R * key_tiles * kSingleK);
}

// 256 threads as 8 warps x 32 lanes: warp ty owns R/8 query rows, lane tx owns
// keys tx + 32j of the tile (scores) and output columns tx + 32j (P.V).
template <int D, int R>
__global__ void __launch_bounds__(kThreads)
flash_fwd_single_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ lengths,
                        float* __restrict__ out, float* __restrict__ lse, int T, int H,
                        int q_tiles, float sm_scale) {
  constexpr int kRQ = R / 8;          // query rows per warp
  constexpr int kKJ = kSingleK / 32;  // keys per lane and tile
  constexpr int kDJ = (D + 31) / 32;  // output columns per lane
  extern __shared__ float smem[];
  const int stride = (T + kSingleK - 1) / kSingleK * kSingleK;
  float* Qs = smem;
  float* KVs = Qs + R * D;
  float* Ss = KVs + kSingleK * (D + 1);

  const long bh = blockIdx.x / q_tiles;
  const int q0 = (int)(blockIdx.x % q_tiles) * R;
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const float* qb = q + bh * T * D;
  const float* kb = k + bh * T * D;
  const float* vb = v + bh * T * D;

  int len = lengths[bh / H];
  len = len < 0 ? 0 : (len > T ? T : len);
  const int n_tiles = (len + kSingleK - 1) / kSingleK;

  for (int i = tid; i < R * D; i += kThreads) {
    const int t = q0 + i / D;
    Qs[i] = t < T ? qb[(long)t * D + i % D] * sm_scale : 0.f;
  }

  // pass 1: scores into shared memory, row max in registers
  float m[kRQ];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) m[i] = -INFINITY;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kSingleK;
    __syncthreads();  // Qs is loaded; the previous tile's reads of KVs are done
    for (int i = tid; i < kSingleK * D; i += kThreads) {
      const int r = i / D, c = i % D, t = k0 + r;
      KVs[r * (D + 1) + c] = t < T ? kb[(long)t * D + c] : 0.f;
    }
    __syncthreads();
    float s[kRQ][kKJ];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < kKJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[kRQ], kk[kKJ];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) a[i] = Qs[(ty * kRQ + i) * D + c];
#pragma unroll
      for (int j = 0; j < kKJ; ++j) kk[j] = KVs[(tx + 32 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int j = 0; j < kKJ; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        const int col = k0 + tx + 32 * j;
        const float sv = col < len ? s[i][j] : -INFINITY;
        Ss[(ty * kRQ + i) * stride + col] = sv;
        m[i] = fmaxf(m[i], sv);
      }
  }

  // one max, one exp, one sum per row; a row belongs to one warp, and each
  // lane meets again only the scores it wrote itself
  float l[kRQ];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
    float* row = Ss + (ty * kRQ + i) * stride;
    float sum = 0.f;
    for (int col = tx; col < n_tiles * kSingleK; col += 32) {
      const float p = col < len ? expf(row[col] - m[i]) : 0.f;
      row[col] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l[i] = sum;
  }

  // pass 2: P.V
  float acc[kRQ][kDJ];
#pragma unroll
  for (int i = 0; i < kRQ; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kSingleK;
    __syncthreads();  // the previous tile's reads of KVs are done
    for (int i = tid; i < kSingleK * D; i += kThreads) {
      const int r = i / D, c = i % D, t = k0 + r;
      KVs[r * D + c] = t < T ? vb[(long)t * D + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kSingleK; ++kk) {
      float vv[kDJ];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) vv[j] = tx + 32 * j < D ? KVs[kk * D + tx + 32 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < kRQ; ++i) {
        const float p = Ss[(ty * kRQ + i) * stride + k0 + kk];
#pragma unroll
        for (int j = 0; j < kDJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int t = q0 + ty * kRQ + i;
    if (t >= T) continue;
    float* orow = out + (bh * T + t) * D;
    const bool any = l[i] > 0.f;
#pragma unroll
    for (int j = 0; j < kDJ; ++j)
      if (tx + 32 * j < D) orow[tx + 32 * j] = any ? acc[i][j] / l[i] : 0.f;
    if (tx == 0) lse[bh * T + t] = any ? m[i] + logf(l[i]) : kNegInf;
  }
}

template <int D, int R>
int launch_single_rows(const float* q, const float* k, const float* v, const int* lengths,
                       float* out, float* lse, long BH, int T, int H, float sm_scale,
                       cudaStream_t stream) {
  const size_t smem = single_smem_bytes<D, R>(T);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_single_kernel<D, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (T + R - 1) / R;
  const long blocks = BH * q_tiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  flash_fwd_single_kernel<D, R><<<(unsigned)blocks, kThreads, smem, stream>>>(
      q, k, v, lengths, out, lse, T, H, q_tiles, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_single(const float* q, const float* k, const float* v, const int* lengths, float* out,
                  float* lse, long BH, int T, int H, float sm_scale, cudaStream_t stream) {
  // 32 query rows per block while their full score rows fit, else 16; a T
  // whose 16 rows do not fit either is refused by the launch (an error code)
  if (single_smem_bytes<D, 32>(T) <= kMaxSmem)
    return launch_single_rows<D, 32>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, stream);
  return launch_single_rows<D, 16>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, stream);
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
