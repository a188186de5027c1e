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
// What bounds it on the H100: arithmetic. With sum_len valid keys over the
// batch the five products cost 10*H*D*T*sum_len operations (21.5 GFLOP at
// B=32, T=512, H=4, D=64 with every key valid) against ~100 MB (0.03 ms).
// They run on the TF32 tensor cores at f32 accuracy, three mma.sync TF32
// products per f32 product (tf32_mma.cuh): 0.13 ms at 495/3 = 165 TFLOP/s,
// against 0.32 ms at 67 TFLOP/s on the CUDA cores.
//
// Design: the TPU kernel's five products, no recomputation, three launches:
//   1. delta_kernel: delta[b, t, h], D/4 threads per (b, t, h).
//   2. bwd_kernel: one block of 4 warps per (64-key tile, head, batch row).
//      K and V stay in shared memory while the block walks the 64-row query
//      tiles, which arrive by cp.async (q, dout, lse, delta) into a two-stage
//      ring read straight from the strided packed layout. Warp w owns keys
//      16w..16w+15 and computes S^T = K Q^T and dP^T = V dout^T, then P^T and
//      dS^T in registers, and dv += P^T dout, dk += dS^T q from those
//      registers (the accumulator is the next product's operand). dS^T goes
//      to shared memory once, where warp w reads it back as the rows of its
//      16 queries for dq_part = dS K over the tile's 64 keys. A tile at or
//      past the length writes zero dk and dv and no partial.
//   3. dq_reduce_kernel: dq = sm_scale * sum of the partials of the key tiles
//      below the length, in key-tile order.
// No atomics: a run repeats bit for bit. 105 KB of shared memory per block at
// D = 64, so two blocks fit on an SM. The scratch holds delta [B, T, H] and
// the partials [B, ceil(T/64), T, F].

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kTile = 64;      // keys per block, query rows per staged tile
constexpr int kThreads = 128;  // 4 warps x 16 keys (dk, dv) or 16 queries (dq)
constexpr float kNegInf = -1e30f;

// delta[r] = rowsum(dout * out) over the D floats of row r = (b*T + t)*H + h:
// each thread takes 4 consecutive floats (coalesced), the D/4 lanes of a row
// add theirs by shuffles.
template <int D>
__global__ void delta_kernel(const float* __restrict__ out, const float* __restrict__ dout,
                             float* __restrict__ delta, long quads) {
  constexpr int kLanes = D / 4;  // 4, 8, 16 or 32: a row never straddles two warps
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  float s = 0.f;
  if (i < quads) {
    const float4 o = reinterpret_cast<const float4*>(out)[i];
    const float4 g = reinterpret_cast<const float4*>(dout)[i];
    s = g.x * o.x + g.y * o.y + g.z * o.z + g.w * o.w;
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (i < quads && i % kLanes == 0) delta[i / kLanes] = s;
}

// Shared layout in floats: Ks, Vs [kTile][D + kPad]; then per stage a q slot
// (q rows at stride D + kPad, later dS^T at stride kTile + kPad, so it is
// sized for the larger), dout [kTile][D + kPad], lse [kTile], delta [kTile].
template <int D>
struct Layout {
  static constexpr int kLd = D + msfa_tc::kPad;
  static constexpr int kLdS = kTile + msfa_tc::kPad;
  static constexpr int kKV = kTile * kLd;
  static constexpr int kQSlot = kTile * (kLd > kLdS ? kLd : kLdS);
  static constexpr int kStage = kQSlot + kKV + 2 * kTile;
  static constexpr size_t kBytes = sizeof(float) * (2 * kKV + 2 * kStage);
};

// One query tile's q, dout, lse, delta into a stage; rows past T are zeros.
template <int D>
__device__ __forceinline__ void stage_query_tile(float* stage, const float* qbase,
                                                 const float* dbase,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ delta,
                                                 long row_stride, int F, int q0, int T, int H,
                                                 int b, int h, int tid) {
  using L = Layout<D>;
  msfa_tc::stage_rows<D>(stage, qbase + (long)q0 * row_stride, row_stride, kTile, T - q0,
                         qbase, tid, kThreads);
  msfa_tc::stage_rows<D>(stage + L::kQSlot, dbase + (long)q0 * F, F, kTile, T - q0, dbase, tid,
                         kThreads);
  float* Ls = stage + L::kQSlot + L::kKV;
  const int r = tid & (kTile - 1);
  const float* src = tid < kTile ? lse : delta;
  const long at = ((long)b * T + q0 + r) * H + h;
  msfa_tc::cp_async4(Ls + (tid < kTile ? 0 : kTile) + r, q0 + r < T ? src + at : src,
                     q0 + r < T);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const float* __restrict__ qkv, const int* __restrict__ lengths,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ dout, float* __restrict__ dqkv,
           float* __restrict__ dq_part, int T, int H, float sm_scale) {
  using namespace msfa_tc;
  using L = Layout<D>;
  constexpr int kSteps = D / 8;
  constexpr int kLd = L::kLd, kLdS = L::kLdS;
  extern __shared__ __align__(16) float bwd_smem[];
  float* Ks = bwd_smem;
  float* Vs = Ks + L::kKV;
  float* stages = Vs + L::kKV;

  const int kt = blockIdx.x;
  const int k0 = kt * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int F = H * D;
  const long row_stride = 3L * F;
  const float* qbase = qkv + (long)b * T * row_stride + h * D;
  const float* dbase = dout + (long)b * T * F + h * D;
  float* dk_base = dqkv + (long)b * T * row_stride + F + h * D;
  float* dv_base = dk_base + F;
  const int key0 = k0 + warp * 16 + g, key1 = key0 + 8;  // this lane's two key rows

  int len = lengths[b];
  len = len < 0 ? 0 : (len > T ? T : len);

  float dk[kSteps][4], dv[kSteps][4];
#pragma unroll
  for (int nd = 0; nd < kSteps; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  if (k0 < len) {  // block-uniform: a tile at or past the length writes zeros
    const float* kbase = qbase + F;
    stage_rows<D>(Ks, kbase + (long)k0 * row_stride, row_stride, kTile, T - k0, kbase, tid,
                  kThreads);
    stage_rows<D>(Vs, kbase + F + (long)k0 * row_stride, row_stride, kTile, T - k0, kbase, tid,
                  kThreads);
    stage_query_tile<D>(stages, qbase, dbase, lse, delta, row_stride, F, 0, T, H, b, h, tid);
    cp_async_commit();
    const int n_q = (T + kTile - 1) / kTile;
    const bool key_ok[2] = {key0 < len, key1 < len};
    for (int i = 0; i < n_q; ++i) {
      const int q0 = i * kTile;
      float* Qs = stages + (i & 1) * L::kStage;
      const float* dOs = Qs + L::kQSlot;
      const float* Ls = dOs + L::kKV;
      const float* Ds = Ls + kTile;
      cp_async_wait<0>();  // this tile (and, at i = 0, K and V) has landed
      __syncthreads();     // ... for every thread; the other stage is free
      if (i + 1 < n_q) {
        stage_query_tile<D>(stages + ((i + 1) & 1) * L::kStage, qbase, dbase, lse, delta,
                            row_stride, F, q0 + kTile, T, H, b, h, tid);
        cp_async_commit();
      }

      // S^T = K q^T and dP^T = V dout^T: 16 keys x 64 queries per warp
      float st[8][4], dpt[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const FragA ak = load_a_rowk(Ks, kLd, warp * 16, 8 * kk, g, t);
        const FragA av = load_a_rowk(Vs, kLd, warp * 16, 8 * kk, g, t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mma3(st[j], ak, load_b_rowk(Qs, kLd, 8 * j, 8 * kk, g, t));
          mma3(dpt[j], av, load_b_rowk(dOs, kLd, 8 * j, 8 * kk, g, t));
        }
      }

      // P^T and dS^T in place: row key0 (e < 2) or key1, column query 8j + 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const float l = Ls[c];
          const bool keep = key_ok[e >> 1] && q0 + c < T && l > kNegInf / 2;
          const float p = keep ? expf(st[j][e] * sm_scale - l) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - Ds[c]);
        }

      // dv += P^T dout, dk += dS^T q (q unscaled; sm_scale goes on at the end)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const FragA ap = acc_as_a(st[j]);
        const FragA ad = acc_as_a(dpt[j]);
#pragma unroll
        for (int nd = 0; nd < kSteps; ++nd) {
          mma3(dv[nd], ap, load_b_colk(dOs, kLd, 8 * j, 8 * nd, g, t));
          mma3(dk[nd], ad, load_b_colk(Qs, kLd, 8 * j, 8 * nd, g, t));
        }
      }

      __syncthreads();  // every warp is done with this stage's q rows
      float* dSs = Qs;  // dS^T [key][query] over the q slot
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* at = dSs + (warp * 16 + g) * kLdS + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(at) = make_float2(dpt[j][0], dpt[j][1]);
        *reinterpret_cast<float2*>(at + 8 * kLdS) = make_float2(dpt[j][2], dpt[j][3]);
      }
      __syncthreads();

      // dq_part = dS K for queries q0 + 16w .. q0 + 16w + 15 over the tile's keys
      float dq[kSteps][4];
#pragma unroll
      for (int nd = 0; nd < kSteps; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[nd][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const FragA a = load_a_colk(dSs, kLdS, warp * 16, 8 * kk, g, t);
#pragma unroll
        for (int nd = 0; nd < kSteps; ++nd)
          mma3(dq[nd], a, load_b_colk(Ks, kLd, 8 * kk, 8 * nd, g, t));
      }
      const int n_kt = gridDim.x;
      float* part = dq_part + (((long)b * n_kt + kt) * T) * F + h * D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = q0 + warp * 16 + g + 8 * r;
        if (q >= T) continue;
#pragma unroll
        for (int nd = 0; nd < kSteps; ++nd)
          *reinterpret_cast<float2*>(part + (long)q * F + 8 * nd + 2 * t) =
              make_float2(dq[nd][2 * r], dq[nd][2 * r + 1]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r == 0 ? key0 : key1;
    if (key >= T) continue;
#pragma unroll
    for (int nd = 0; nd < kSteps; ++nd) {
      const long at = (long)key * row_stride + 8 * nd + 2 * t;
      *reinterpret_cast<float2*>(dk_base + at) =
          make_float2(dk[nd][2 * r] * sm_scale, dk[nd][2 * r + 1] * sm_scale);
      *reinterpret_cast<float2*>(dv_base + at) = make_float2(dv[nd][2 * r], dv[nd][2 * r + 1]);
    }
  }
}

// dq[b, t, f] = sm_scale * sum over key tiles kt < ceil(len_b / 64) of
// dq_part[b, kt, t, f], in order; four floats per thread.
__global__ void dq_reduce_kernel(const float* __restrict__ dq_part,
                                 const int* __restrict__ lengths, float* __restrict__ dqkv,
                                 int T, int F, int n_kt, float sm_scale, long quads) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  const long per_b = (long)T * F;
  const long e = i * 4;
  const int b = (int)(e / per_b);
  const long within = e - b * per_b;  // t * F + f
  int len = lengths[b];
  len = len < 0 ? 0 : (len > T ? T : len);
  const int n = (len + kTile - 1) / kTile;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* src = dq_part + (long)b * n_kt * per_b + within;
  for (int kt = 0; kt < n; ++kt) {
    const float4 x = *reinterpret_cast<const float4*>(src + kt * per_b);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const long t = within / F, f = within % F;
  *reinterpret_cast<float4*>(dqkv + ((long)b * T + t) * 3 * F + f) =
      make_float4(acc.x * sm_scale, acc.y * sm_scale, acc.z * sm_scale, acc.w * sm_scale);
}

long scratch_floats(int B, int T, int H, int D) {
  const long n_kt = (T + kTile - 1) / kTile;
  return (long)B * T * H + (long)B * n_kt * T * H * D;
}

template <int D>
int launch(const float* qkv, const int* lengths, const float* out, const float* lse,
           const float* dout, float* scratch, float* dqkv, int B, int T, int H,
           float sm_scale, cudaStream_t stream) {
  const long rows = (long)B * T * H;
  float* delta = scratch;
  float* dq_part = scratch + rows;
  const long quads = rows * (D / 4);
  delta_kernel<D><<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(out, dout, delta, quads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_kt = (T + kTile - 1) / kTile;
  const size_t smem = Layout<D>::kBytes;
  err = cudaFuncSetAttribute(bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<D><<<dim3(n_kt, H, B), kThreads, smem, stream>>>(
      qkv, lengths, lse, delta, dout, dqkv, dq_part, T, H, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dq_reduce_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
      dq_part, lengths, dqkv, T, H * D, n_kt, sm_scale, quads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch the wrapper allocates for msfa_packed_attention_bwd:
// delta [B, T, H], then the dq partials [B, ceil(T / 64), T, H * D].
long long msfa_packed_attention_bwd_scratch(int B, int T, int H, int D) {
  return scratch_floats(B, T, H, D);
}

// Head dims the kernels are instantiated for; the wrapper checks before calling.
int msfa_packed_attention_bwd(const float* qkv, const int* lengths, const float* out,
                              const float* lse, const float* dout, float* scratch,
                              float* dqkv, int B, int T, int H, int D, float sm_scale,
                              void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(qkv, lengths, out, lse, dout, scratch, dqkv, B, T, H, sm_scale, s);
    case 32: return launch<32>(qkv, lengths, out, lse, dout, scratch, dqkv, B, T, H, sm_scale, s);
    case 64: return launch<64>(qkv, lengths, out, lse, dout, scratch, dqkv, B, T, H, sm_scale, s);
    case 128: return launch<128>(qkv, lengths, out, lse, dout, scratch, dqkv, B, T, H, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
