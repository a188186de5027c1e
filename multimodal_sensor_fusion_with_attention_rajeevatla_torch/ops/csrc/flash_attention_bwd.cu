// Self-attention backward on the [B*H, T, D] layout, f32, for Hopper (sm_90a):
// the fused backward (one kernel and the ordered sum of its dq partials), the
// split dk/dv and dq kernels, and delta.
//
// Replaces: multimodal_sensor_fusion_with_attention_rajeevatla_tpu/ops/pallas_attention.py
//   _bwd_fused_kernel (flash_bwd_fused_kernel below), _dkv_kernel
//   (flash_dkv_kernel) and _dq_kernel (flash_dq_kernel), all launched by
//   _flash_backward, the VJP of flash_self_attention. The reference takes
//   delta = rowsum(dout * out) in plain XLA; here it is the small
//   flash_delta_kernel with its own entry point, run once before either route.
//
// All compute, for every row bh = b*H + h of q, k, v [B*H, T, D], from the
// forward's lse [B*H, T], delta [B*H, T] and the cotangent dout [B*H, T, D]:
//   p  = exp((q * sm_scale) k^T - lse)     key columns >= lengths[b] -> 0,
//                                          rows with lse = -1e30 -> 0
//   ds = p * (dout v^T - delta)
//   dv = p^T dout,  dk = ds^T (q * sm_scale),  dq = (ds k) * sm_scale
// sm_scale is folded into q (dk uses the scaled q) and applied to dq after the
// product, which is the TPU kernels' ds * sm_scale up to rounding. Query rows
// are not masked (t >= length still gets dq); key tiles at or past the length
// get exact-zero dk and dv, written; a length-0 row gets three exact zeros
// and never evaluates an exp. T is any positive length: the kernels mask the
// ragged last tile themselves. Offsets are 64-bit.
//
// What bounds them on the H100: arithmetic. With sum_len valid keys over the
// batch the function's five products cost 10*H*D*T*sum_len operations (85.9
// GFLOP at B=32, H=4, D=64, T=1024 with every key valid: 0.52 ms at 495/3 =
// 165 TFLOP/s on 3xTF32, 1.28 ms at 67 TFLOP/s f32 on the CUDA cores)
// against 8 tensors of 4*B*H*T*D bytes (0.08 ms at 3.35 TB/s).
//
// flash_bwd_fused_kernel keeps what the TPU kernel is about: the scores, p,
// dp and ds of every (query, key) pair are computed once (five products, not
// the split pair's seven). The TPU kernel holds whole [T, T] f32 tiles in
// VMEM (4 MB at T = 1024); here one block of 4 warps owns one (64-key tile,
// row bh), 16 x 128 = 2,048 blocks at [128, 1024, 64], and runs the products
// on the TF32 tensor cores at f32 accuracy (3xTF32 mma.sync): the body in
// attention_bwd.cuh, which the packed backward shares on its layout. Each
// block writes its keys' dk and dv and a dq partial over its 64 keys; a
// second launch, flash_bwd_fused_dq_reduce, sums the partials of the tiles
// below the length in key-tile order, with no atomic adds, so the result
// does not depend on scheduling. The partials take B*H*ceil(T/64)*T*D floats
// of scratch (537 MB at [128, 1024, 64]), written once and read once.
//
// flash_dkv_kernel: one block per (64-key tile, row); K and V stay in shared
// memory while the block walks every query tile. flash_dq_kernel: one block
// per (64-query tile, row) walks the key tiles below the length and
// recomputes the scores and dp. Both on the CUDA cores: 256 threads as a
// 16 x 16 grid, 4 x 4 score micro-tiles, 4 x D/16 output micro-tiles.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_bwd.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__global__ void flash_delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
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

// Loads one query tile (q pre-scaled, dout, lse, delta) of one row's [T, D]
// arrays; rows past T are zeros with lse = NEG_INF, so they add nothing.
template <int D>
__device__ __forceinline__ void load_query_tile(const float* qb, const float* dob,
                                                const float* lse_row, const float* delta_row,
                                                int q0, int T, float sm_scale, float* Qs,
                                                float* dOs, float* Ls, float* Ds) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int t = q0 + i / D;
    const bool ok = t < T;
    const long at = (long)t * D + i % D;
    Qs[i] = ok ? qb[at] * sm_scale : 0.f;
    dOs[i] = ok ? dob[at] : 0.f;
  }
  for (int r = tid; r < kBlockQ; r += kThreads) {
    const int t = q0 + r;
    Ls[r] = t < T ? lse_row[t] : kNegInf;
    Ds[r] = t < T ? delta_row[t] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void load_key_tile(const float* kb, const float* vb, int k0, int T,
                                              float* Ks, float* Vs) {
  for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
    const int r = i / D, c = i % D, t = k0 + r;
    const bool ok = t < T;
    Ks[r * (D + 1) + c] = ok ? kb[(long)t * D + c] : 0.f;
    Vs[r * (D + 1) + c] = ok ? vb[(long)t * D + c] : 0.f;
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
    const int qr = ty * 4 + i;
    const float l = Ls[qr];
    const bool row_ok = l > kNegInf / 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = tx + 16 * j;
      const float p = (row_ok && k0 + kk < len) ? expf(s[i][j] - l) : 0.f;
      if (Ps) Ps[qr * (kBlockK + 1) + kk] = p;
      dSs[qr * (kBlockK + 1) + kk] = p * (dp[i][j] - Ds[qr]);
    }
  }
}

// dk += dS^T Q and dv += P^T dO for the thread's 4 keys x D/16 columns.
template <int D>
__device__ __forceinline__ void accumulate_dkv(const float* Qs, const float* dOs, const float* Ps,
                                               const float* dSs, float (&dk)[4][D / 16],
                                               float (&dv)[4][D / 16]) {
  constexpr int kDJ = D / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int qr = 0; qr < kBlockQ; ++qr) {
    float pk[4], dsk[4], go[kDJ], qv[kDJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pk[i] = Ps[qr * (kBlockK + 1) + ty * 4 + i];
      dsk[i] = dSs[qr * (kBlockK + 1) + ty * 4 + i];
    }
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      go[j] = dOs[qr * D + tx + 16 * j];
      qv[j] = Qs[qr * D + tx + 16 * j];
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

// dq += dS K for the thread's 4 queries x D/16 columns.
template <int D>
__device__ __forceinline__ void accumulate_dq(const float* Ks, const float* dSs,
                                              float (&dq)[4][D / 16]) {
  constexpr int kDJ = D / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int kk = 0; kk < kBlockK; ++kk) {
    float kv[kDJ];
#pragma unroll
    for (int j = 0; j < kDJ; ++j) kv[j] = Ks[kk * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ds = dSs[(ty * 4 + i) * (kBlockK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) dq[i][j] = fmaf(ds, kv[j], dq[i][j]);
    }
  }
}

struct RowPointers {
  const float *q, *k, *v, *dout, *lse, *delta;
  int len;
};

__device__ __forceinline__ RowPointers row_pointers(const float* q, const float* k,
                                                    const float* v, const float* dout,
                                                    const float* lse, const float* delta,
                                                    const int* lengths, long bh, int T, int H,
                                                    int D) {
  RowPointers r;
  const long at = bh * T * D;
  r.q = q + at;
  r.k = k + at;
  r.v = v + at;
  r.dout = dout + at;
  r.lse = lse + bh * T;
  r.delta = delta + bh * T;
  const int len = lengths[bh / H];
  r.len = len < 0 ? 0 : (len > T ? T : len);
  return r;
}

// One block per (64-key tile, row bh), the key tile fastest; the body is
// attention_bwd.cuh's. The tile's dq partial goes to dq_part [B*H,
// ceil(T/64), T, D].
template <int D>
__global__ void __launch_bounds__(msfa_tc::kBwdThreads)
flash_bwd_fused_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const int* __restrict__ lengths,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const float* __restrict__ dout, float* __restrict__ dk,
                       float* __restrict__ dv, float* __restrict__ dq_part, int T, int H,
                       int n_kt, float sm_scale) {
  extern __shared__ __align__(16) float fused_smem[];
  const long bh = blockIdx.x / n_kt;
  const int kt = (int)(blockIdx.x % n_kt);
  const long at = bh * T * D;
  int len = lengths[bh / H];
  len = len < 0 ? 0 : (len > T ? T : len);
  const msfa_tc::BwdRow row{
      q + at, k + at, v + at, D,                       // q, k, v
      dout + at, D,                                    // dout
      lse + bh * T, delta + bh * T, 1,                 // lse, delta
      dk + at, dv + at, D,                             // dk, dv
      dq_part + (bh * n_kt + kt) * T * D, D};          // this tile's dq partial
  msfa_tc::attention_bwd_tile<D>(row, T, len, kt * msfa_tc::kBwdTile, sm_scale, fused_smem);
}

// dq[bh, t, f] = sm_scale * sum over key tiles kt < ceil(len / 64) of
// dq_part[bh, kt, t, f], in order; four floats per thread.
__global__ void flash_bwd_fused_dq_reduce(const float* __restrict__ dq_part,
                                          const int* __restrict__ lengths, float* __restrict__ dq,
                                          int T, int H, int D, int n_kt, float sm_scale,
                                          long quads) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  msfa_tc::dq_reduce(dq_part, lengths, dq, T, D, n_kt, H, D, sm_scale, i);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lengths,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv,
                 int T, int H, int tiles, float sm_scale) {
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

  const long bh = blockIdx.x / tiles;
  const int k0 = (int)(blockIdx.x % tiles) * kBlockK;
  const int tx = threadIdx.x & 15;  // output column group
  const int ty = threadIdx.x >> 4;  // keys ty*4 .. ty*4+3
  const RowPointers row = row_pointers(q, k, v, dout, lse, delta, lengths, bh, T, H, D);

  float dk_acc[4][kDJ], dv_acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  if (k0 < row.len) {  // block-uniform: a tile at or past the length writes zeros
    load_key_tile<D>(row.k, row.v, k0, T, Ks, Vs);
    for (int q0 = 0; q0 < T; q0 += kBlockQ) {
      __syncthreads();  // previous tile's reads of Qs/dOs/Ps/dSs are done
      load_query_tile<D>(row.q, row.dout, row.lse, row.delta, q0, T, sm_scale, Qs, dOs, Ls, Ds);
      __syncthreads();
      p_and_ds<D>(Qs, dOs, Ks, Vs, Ls, Ds, k0, row.len, Ps, dSs);
      __syncthreads();
      accumulate_dkv<D>(Qs, dOs, Ps, dSs, dk_acc, dv_acc);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty * 4 + i;
    if (t >= T) continue;
    const long at = (bh * T + t) * D + tx;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      dk[at + 16 * j] = dk_acc[i][j];
      dv[at + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ lengths,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ dout, float* __restrict__ dq, int T, int H, int tiles,
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

  const long bh = blockIdx.x / tiles;
  const int q0 = (int)(blockIdx.x % tiles) * kBlockQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;  // queries ty*4 .. ty*4+3
  const RowPointers row = row_pointers(q, k, v, dout, lse, delta, lengths, bh, T, H, D);

  load_query_tile<D>(row.q, row.dout, row.lse, row.delta, q0, T, sm_scale, Qs, dOs, Ls, Ds);
  float dq_acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dq_acc[i][j] = 0.f;

  const int n_tiles = (row.len + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // previous tile's reads of Ks/Vs/dSs are done
    load_key_tile<D>(row.k, row.v, k0, T, Ks, Vs);
    __syncthreads();
    p_and_ds<D>(Qs, dOs, Ks, Vs, Ls, Ds, k0, row.len, nullptr, dSs);
    __syncthreads();
    accumulate_dq<D>(Ks, dSs, dq_acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= T) continue;
    const long at = (bh * T + t) * D + tx;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dq[at + 16 * j] = dq_acc[i][j] * sm_scale;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

long fused_scratch_floats(long BH, int T, int D) {
  return BH * ((T + msfa_tc::kBwdTile - 1) / msfa_tc::kBwdTile) * T * D;
}

template <int D>
int launch_fused(const float* q, const float* k, const float* v, const int* lengths,
                 const float* lse, const float* delta, const float* dout, float* dq, float* dk,
                 float* dv, float* dq_part, long BH, int T, int H, float sm_scale,
                 cudaStream_t stream) {
  const size_t smem = msfa_tc::BwdLayout<D>::kBytes;
  cudaError_t err = allow_smem(flash_bwd_fused_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (T + msfa_tc::kBwdTile - 1) / msfa_tc::kBwdTile;
  const long quads = BH * T * (D / 4);
  if (BH * n_kt > 0x7fffffffL || (quads + 255) / 256 > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  flash_bwd_fused_kernel<D><<<(unsigned)(BH * n_kt), msfa_tc::kBwdThreads, smem, stream>>>(
      q, k, v, lengths, lse, delta, dout, dk, dv, dq_part, T, H, n_kt, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_fused_dq_reduce<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
      dq_part, lengths, dq, T, H, D, n_kt, sm_scale, quads);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const int* lengths,
               const float* lse, const float* delta, const float* dout, float* dk, float* dv,
               long BH, int T, int H, float sm_scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (T + kBlockK - 1) / kBlockK;
  if (BH * tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  flash_dkv_kernel<D><<<(unsigned)(BH * tiles), kThreads, smem, stream>>>(
      q, k, v, lengths, lse, delta, dout, dk, dv, T, H, tiles, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const int* lengths,
              const float* lse, const float* delta, const float* dout, float* dq, long BH, int T,
              int H, float sm_scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_dq_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (T + kBlockQ - 1) / kBlockQ;
  if (BH * tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  flash_dq_kernel<D><<<(unsigned)(BH * tiles), kThreads, smem, stream>>>(
      q, k, v, lengths, lse, delta, dout, dq, T, H, tiles, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define MSFA_DISPATCH_D(call)                  \
  switch (D) {                                 \
    case 16: return call(16);                  \
    case 32: return call(32);                  \
    case 64: return call(64);                  \
    case 128: return call(128);                \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// q, k, v, dout, dq, dk, dv: [B*H, T, D] f32; lse, delta: [B*H, T] f32;
// lengths: [B] int32. Head dims the kernels are instantiated for; the
// wrappers check before calling.

// delta[r] = sum_c dout[r, c] * out[r, c] over rows = B*H*T rows of width D.
int msfa_flash_delta(const float* out, const float* dout, float* delta, long long rows, int D,
                     void* stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_delta_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, dout, delta, (long)rows, D);
  return (int)cudaGetLastError();
}

// Floats of scratch the wrapper allocates for msfa_flash_bwd_fused: the dq
// partials [B*H, ceil(T / 64), T, D].
long long msfa_flash_bwd_fused_scratch(int B, int T, int H, int D) {
  return fused_scratch_floats((long)B * H, T, D);
}

// Two launches: the kernel (dk, dv and the dq partials), then their ordered sum.
int msfa_flash_bwd_fused(const float* q, const float* k, const float* v, const int* lengths,
                         const float* lse, const float* delta, const float* dout, float* dq,
                         float* dk, float* dv, float* scratch, int B, int T, int H, int D,
                         float sm_scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long BH = (long)B * H;
#define CALL(d) \
  launch_fused<d>(q, k, v, lengths, lse, delta, dout, dq, dk, dv, scratch, BH, T, H, sm_scale, s)
  MSFA_DISPATCH_D(CALL)
#undef CALL
}

int msfa_flash_bwd_dkv(const float* q, const float* k, const float* v, const int* lengths,
                       const float* lse, const float* delta, const float* dout, float* dk,
                       float* dv, int B, int T, int H, int D, float sm_scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long BH = (long)B * H;
#define CALL(d) launch_dkv<d>(q, k, v, lengths, lse, delta, dout, dk, dv, BH, T, H, sm_scale, s)
  MSFA_DISPATCH_D(CALL)
#undef CALL
}

int msfa_flash_bwd_dq(const float* q, const float* k, const float* v, const int* lengths,
                      const float* lse, const float* delta, const float* dout, float* dq, int B,
                      int T, int H, int D, float sm_scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long BH = (long)B * H;
#define CALL(d) launch_dq<d>(q, k, v, lengths, lse, delta, dout, dq, BH, T, H, sm_scale, s)
  MSFA_DISPATCH_D(CALL)
#undef CALL
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
