// Packed multi-head self-attention backward, f32, for Hopper (sm_90a).
//
// Replaces: multimodal_sensor_fusion_with_attention_rajeevatla_tpu/ops/pallas_attention.py
//   _packed_bwd_kernel (launched by _packed_backward, the VJP of flash_mha_packed).
//
// Computes, for every batch row b and head h of the packed projection
// qkv [B, T, 3F] (q | k | v along the minor dim, head h at columns h*D..h*D+D
// inside each third), from the forward's out [B, T, F] and lse [B, T, H] and
// the cotangent dout [B, T, F]:
//   p     = exp((q * sm_scale) k^T - lse)     key columns >= lengths[b] -> 0,
//                                             rows with lse = -1e30 -> 0
//   delta = rowsum(dout * out)                per (b, t, h)
//   ds    = p * (dout v^T - delta)
//   dv = p^T dout,  dk = ds^T (q * sm_scale),  dq = (ds k) * sm_scale
// written into the packed dqkv [B, T, 3F]. As in the TPU kernel, sm_scale is
// folded into q (dk uses the scaled q) and applied to dq after the product;
// query rows are not masked (t >= length still gets dq), key tiles at or past
// the length get exact-zero dk and dv, written.
//
// What bounds it on the H100: arithmetic. With Σlen valid keys over the batch
// the TPU kernel's five products cost 10*H*D*T*Σlen operations (21.5 GFLOP
// at B=32, T=512, H=4, D=64 with every key valid, 0.32 ms at 67 TFLOP/s f32)
// against ~100 MB (0.03 ms). This version recomputes the scores and dp in a
// second kernel for dq (7 products instead of 5), in f32 on the CUDA cores.
//
// Design (FA2-style, three launches on the stream):
//   1. delta_kernel: delta[b, t, h], one thread per (b, t, h).
//   2. dkv_kernel: one block per (64-key tile, head, batch row); K and V stay
//      in shared memory while the block walks every 64-row query tile,
//      recomputes p and ds and accumulates dk and dv in registers (4 keys x
//      D/16 columns per thread). A tile at or past the length writes zeros.
//   3. dq_kernel: one block per (64-query tile, head, batch row) walks the
//      key tiles below the length and accumulates dq in registers.
// dq takes a second pass over the keys instead of atomicAdd across key
// tiles: deterministic, and no zeroing pass. Both kernels read q, k, v, dout
// straight from the strided packed layout (each tile row is D contiguous
// floats), as the forward does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__global__ void delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                             float* __restrict__ delta, long rows, int D) {
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* o = out + r * D;
  const float* g = dout + r * D;
  float s = 0.f;
  for (int c = 0; c < D; ++c) s = fmaf(g[c], o[c], s);
  delta[r] = s;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // Ks, Vs [BK][D+1]; Qs, dOs [BQ][D]; Ps, dSs [BQ][BK+1]; lse, delta [BQ]
  return sizeof(float) * (2 * kBlockK * (D + 1) + 2 * kBlockQ * D +
                          2 * kBlockQ * (kBlockK + 1) + 2 * kBlockQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Qs, dOs [BQ][D]; Ks, Vs [BK][D+1]; dSs [BQ][BK+1]; lse, delta [BQ]
  return sizeof(float) * (2 * kBlockQ * D + 2 * kBlockK * (D + 1) +
                          kBlockQ * (kBlockK + 1) + 2 * kBlockQ);
}

// Loads one query tile (q pre-scaled, dout, lse, delta); rows past T are zeros
// with lse = NEG_INF, so they add nothing.
template <int D>
__device__ __forceinline__ void load_query_tile(const float* base, const float* dbase,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ delta,
                                                long row_stride, int F, int q0, int T,
                                                int H, int b, int h, float sm_scale,
                                                float* Qs, float* dOs, float* Ls, float* Ds) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    const bool ok = t < T;
    Qs[i] = ok ? base[(long)t * row_stride + c] * sm_scale : 0.f;
    dOs[i] = ok ? dbase[(long)t * F + c] : 0.f;
  }
  for (int r = tid; r < kBlockQ; r += kThreads) {
    const int t = q0 + r;
    const long at = ((long)b * T + t) * H + h;
    Ls[r] = t < T ? lse[at] : kNegInf;
    Ds[r] = t < T ? delta[at] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void load_key_tile(const float* base, long row_stride, int F,
                                              int k0, int T, float* Ks, float* Vs) {
  for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
    const int r = i / D, c = i % D, t = k0 + r;
    float kv = 0.f, vv = 0.f;
    if (t < T) {
      const float* row = base + (long)t * row_stride + c;
      kv = row[F];
      vv = row[2 * F];
    }
    Ks[r * (D + 1) + c] = kv;
    Vs[r * (D + 1) + c] = vv;
  }
}

// p and ds for the 4 x 4 micro-tile (query ty*4+i, key tx+16j) of one
// (query tile, key tile) pair, stored to Ps (if given) and dSs.
template <int D>
__device__ __forceinline__ void p_and_ds(const float* Qs, const float* dOs, const float* Ks,
                                         const float* Vs, const float* Ls, const float* Ds,
                                         int k0, int len, float* Ps, float* dSs) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    float a[4], g[4], k[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(ty * 4 + i) * D + c];
      g[i] = dOs[(ty * 4 + i) * D + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      k[j] = Ks[(tx + 16 * j) * (D + 1) + c];
      v[j] = Vs[(tx + 16 * j) * (D + 1) + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], k[j], s[i][j]);
        dp[i][j] = fmaf(g[i], v[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = ty * 4 + i;
    const float l = Ls[q];
    const bool row_ok = l > kNegInf / 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = tx + 16 * j;
      const float p = (row_ok && k0 + kk < len) ? expf(s[i][j] - l) : 0.f;
      if (Ps) Ps[q * (kBlockK + 1) + kk] = p;
      dSs[q * (kBlockK + 1) + kk] = p * (dp[i][j] - Ds[q]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ qkv, const int* __restrict__ lengths,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ dout, float* __restrict__ dqkv, int T, int H,
           float sm_scale) {
  constexpr int kDJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlockK * (D + 1);
  float* Qs = Vs + kBlockK * (D + 1);
  float* dOs = Qs + kBlockQ * D;
  float* Ps = dOs + kBlockQ * D;
  float* dSs = Ps + kBlockQ * (kBlockK + 1);
  float* Ls = dSs + kBlockQ * (kBlockK + 1);
  float* Ds = Ls + kBlockQ;

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output column group
  const int ty = tid >> 4;  // keys ty*4 .. ty*4+3
  const int F = H * D;
  const long row_stride = 3L * F;
  const float* base = qkv + (long)b * T * row_stride + h * D;
  const float* dbase = dout + (long)b * T * F + h * D;
  float* dk_base = dqkv + (long)b * T * row_stride + F + h * D;
  float* dv_base = dk_base + F;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > T ? T : len);

  float dk[4][kDJ], dv[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  if (k0 < len) {  // block-uniform: a tile at or past the length writes zeros
    load_key_tile<D>(base, row_stride, F, k0, T, Ks, Vs);
    for (int q0 = 0; q0 < T; q0 += kBlockQ) {
      __syncthreads();  // previous tile's reads of Qs/dOs/Ps/dSs are done
      load_query_tile<D>(base, dbase, lse, delta, row_stride, F, q0, T, H, b, h, sm_scale,
                         Qs, dOs, Ls, Ds);
      __syncthreads();
      p_and_ds<D>(Qs, dOs, Ks, Vs, Ls, Ds, k0, len, Ps, dSs);
      __syncthreads();
#pragma unroll 4
      for (int q = 0; q < kBlockQ; ++q) {
        float pk[4], dsk[4], go[kDJ], qv[kDJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pk[i] = Ps[q * (kBlockK + 1) + ty * 4 + i];
          dsk[i] = dSs[q * (kBlockK + 1) + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < kDJ; ++j) {
          go[j] = dOs[q * D + tx + 16 * j];
          qv[j] = Qs[q * D + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kDJ; ++j) {
            dv[i][j] = fmaf(pk[i], go[j], dv[i][j]);
            dk[i][j] = fmaf(dsk[i], qv[j], dk[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      dk_base[(long)t * row_stride + tx + 16 * j] = dk[i][j];
      dv_base[(long)t * row_stride + tx + 16 * j] = dv[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ qkv, const int* __restrict__ lengths,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const float* __restrict__ dout, float* __restrict__ dqkv, int T, int H,
          float sm_scale) {
  constexpr int kDJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBlockQ * D;
  float* Ks = dOs + kBlockQ * D;
  float* Vs = Ks + kBlockK * (D + 1);
  float* dSs = Vs + kBlockK * (D + 1);
  float* Ls = dSs + kBlockQ * (kBlockK + 1);
  float* Ds = Ls + kBlockQ;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;  // queries ty*4 .. ty*4+3
  const int F = H * D;
  const long row_stride = 3L * F;
  const float* base = qkv + (long)b * T * row_stride + h * D;
  const float* dbase = dout + (long)b * T * F + h * D;
  float* dq_base = dqkv + (long)b * T * row_stride + h * D;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > T ? T : len);

  load_query_tile<D>(base, dbase, lse, delta, row_stride, F, q0, T, H, b, h, sm_scale,
                     Qs, dOs, Ls, Ds);
  float dq[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dq[i][j] = 0.f;

  const int n_tiles = (len + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // previous tile's reads of Ks/Vs/dSs are done
    load_key_tile<D>(base, row_stride, F, k0, T, Ks, Vs);
    __syncthreads();
    p_and_ds<D>(Qs, dOs, Ks, Vs, Ls, Ds, k0, len, nullptr, dSs);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBlockK; ++k) {
      float kv[kDJ];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) kv[j] = Ks[k * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty * 4 + i) * (kBlockK + 1) + k];
#pragma unroll
        for (int j = 0; j < kDJ; ++j) dq[i][j] = fmaf(ds, kv[j], dq[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dq_base[(long)t * row_stride + tx + 16 * j] = dq[i][j] * sm_scale;
  }
}

template <int D>
int launch(const float* qkv, const int* lengths, const float* out, const float* lse,
           const float* dout, float* delta, float* dqkv, int B, int T, int H,
           float sm_scale, cudaStream_t stream) {
  const long rows = (long)B * T * H;
  delta_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(out, dout, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int tiles = (T + kBlockQ - 1) / kBlockQ;
  const dim3 grid(tiles, H, B);
  const size_t smem_kv = dkv_smem_bytes<D>();
  err = cudaFuncSetAttribute(dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<D><<<grid, kThreads, smem_kv, stream>>>(qkv, lengths, lse, delta, dout, dqkv, T,
                                                     H, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<D><<<grid, kThreads, smem_q, stream>>>(qkv, lengths, lse, delta, dout, dqkv, T, H,
                                                   sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Head dims the kernels are instantiated for; the wrapper checks before calling.
// delta [B, T, H] is scratch.
int msfa_packed_attention_bwd(const float* qkv, const int* lengths, const float* out,
                              const float* lse, const float* dout, float* delta,
                              float* dqkv, int B, int T, int H, int D, float sm_scale,
                              void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(qkv, lengths, out, lse, dout, delta, dqkv, B, T, H, sm_scale, s);
    case 32: return launch<32>(qkv, lengths, out, lse, dout, delta, dqkv, B, T, H, sm_scale, s);
    case 64: return launch<64>(qkv, lengths, out, lse, dout, delta, dqkv, B, T, H, sm_scale, s);
    case 128: return launch<128>(qkv, lengths, out, lse, dout, delta, dqkv, B, T, H, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
