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
// sm_scale is folded into the scores and applied to dk and dq after the
// product, which is the TPU kernels' scaled q and ds * sm_scale up to
// rounding. Query rows are not masked (t >= length still gets dq); key tiles
// at or past the length get exact-zero dk and dv, written; a length-0 row
// gets three exact zeros and never evaluates an exp. T is any positive
// length: the kernels mask the ragged last tile themselves. Offsets are
// 64-bit.
//
// What bounds them on the H100: arithmetic. With sum_len valid keys over the
// batch the fused route's five products cost 10*H*D*T*sum_len operations
// (343.6 GFLOP at B=32, H=4, D=64, T=2048 with every key valid: 2.08 ms at
// 495/3 = 165 TFLOP/s on 3xTF32, 5.13 ms at 67 TFLOP/s f32 on the CUDA
// cores). The split route recomputes the scores and dp in both kernels,
// seven products in all: dk/dv 8*H*D*T*sum_len (274.9 GFLOP there, 1.67 ms on
// 3xTF32, 4.10 on the CUDA cores), dq 6*H*D*T*sum_len (206.2 GFLOP, 1.25 ms,
// 3.08). The bytes are 7, 6 and 5 tensors of 4*B*H*T*D (0.07 ms apiece at
// 3.35 TB/s).
//
// All three run on the TF32 tensor cores at f32 accuracy (3xTF32 mma.sync,
// tf32_mma.cuh) on tiles staged by cp.async, the bodies in attention_bwd.cuh:
//
// flash_bwd_fused_kernel keeps what the TPU kernel is about: the scores, p,
// dp and ds of every (query, key) pair are computed once (five products, not
// the split pair's seven). The TPU kernel holds whole [T, T] f32 tiles in
// VMEM (4 MB at T = 1024); here one block of 4 warps owns one (64-key tile,
// row bh), 16 x 128 = 2,048 blocks at [128, 1024, 64], and runs the body the
// packed backward shares on its layout. Each block writes its keys' dk and
// dv and a dq partial over its 64 keys; a second launch,
// flash_bwd_fused_dq_reduce, sums the partials of the tiles below the length
// in key-tile order, with no atomic adds, so the result does not depend on
// scheduling. The partials take B*H*ceil(T/64)*T*D floats of scratch (537 MB
// at [128, 1024, 64], 2.1 GB at T = 2048), written once and read once.
//
// The split route needs no scratch. flash_dkv_kernel is the fused kernel's
// body without its dq (attention_bwd_tile<D, false>): one block per (64-key
// tile, row), dk and dv the same instructions, so the fused kernel's bits.
// flash_dq_kernel is one block of 4 warps per (64-query tile, row) on
// attention_dq_tile: the query tile staged once, K and V of the key tiles
// below the length staged one at a time (three blocks on an SM at D = 64),
// dS kept in registers as the A operand of dq += dS K, each key tile's
// product added in FP32 in key-tile order. Neither uses atomics: a run
// repeats bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_bwd.cuh"

namespace {

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

// lengths[bh / H] clamped to [0, T].
__device__ __forceinline__ int row_length(const int* lengths, long bh, int H, int T) {
  const int len = lengths[bh / H];
  return len < 0 ? 0 : (len > T ? T : len);
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
  const msfa_tc::BwdRow row{
      q + at, k + at, v + at, D,                       // q, k, v
      dout + at, D,                                    // dout
      lse + bh * T, delta + bh * T, 1,                 // lse, delta
      dk + at, dv + at, D,                             // dk, dv
      dq_part + (bh * n_kt + kt) * T * D, D};          // this tile's dq partial
  msfa_tc::attention_bwd_tile<D>(row, T, row_length(lengths, bh, H, T), kt * msfa_tc::kBwdTile,
                                 sm_scale, fused_smem);
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

// The fused kernel's body without its dq: one block per (64-key tile, row
// bh), the key tile fastest, writing the tile's dk and dv.
template <int D>
__global__ void __launch_bounds__(msfa_tc::kBwdThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lengths,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ dout, float* __restrict__ dk, float* __restrict__ dv,
                 int T, int H, int n_kt, float sm_scale) {
  extern __shared__ __align__(16) float dkv_smem[];
  const long bh = blockIdx.x / n_kt;
  const int kt = (int)(blockIdx.x % n_kt);
  const long at = bh * T * D;
  const msfa_tc::BwdRow row{
      q + at, k + at, v + at, D,                       // q, k, v
      dout + at, D,                                    // dout
      lse + bh * T, delta + bh * T, 1,                 // lse, delta
      dk + at, dv + at, D,                             // dk, dv
      nullptr, 0};                                     // no dq partial
  msfa_tc::attention_bwd_tile<D, false>(row, T, row_length(lengths, bh, H, T),
                                        kt * msfa_tc::kBwdTile, sm_scale, dkv_smem);
}

// One block per (64-query tile, row bh), the query tile fastest, writing the
// tile's dq.
template <int D>
__global__ void __launch_bounds__(msfa_tc::kBwdThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ lengths,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ dout, float* __restrict__ dq, int T, int H, int n_qt,
                float sm_scale) {
  extern __shared__ __align__(16) float dq_smem[];
  const long bh = blockIdx.x / n_qt;
  const int qt = (int)(blockIdx.x % n_qt);
  const long at = bh * T * D;
  const msfa_tc::BwdRow row{
      q + at, k + at, v + at, D,                       // q, k, v
      dout + at, D,                                    // dout
      lse + bh * T, delta + bh * T, 1,                 // lse, delta
      nullptr, nullptr, 0, nullptr, 0};                // dq is written below
  msfa_tc::attention_dq_tile<D>(row, dq + at, D, T, row_length(lengths, bh, H, T),
                                qt * msfa_tc::kBwdTile, sm_scale, dq_smem);
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
  const size_t smem = msfa_tc::BwdLayout<D>::kBytes;
  cudaError_t err = allow_smem(flash_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_kt = (T + msfa_tc::kBwdTile - 1) / msfa_tc::kBwdTile;
  if (BH * n_kt > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  flash_dkv_kernel<D><<<(unsigned)(BH * n_kt), msfa_tc::kBwdThreads, smem, stream>>>(
      q, k, v, lengths, lse, delta, dout, dk, dv, T, H, n_kt, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const int* lengths,
              const float* lse, const float* delta, const float* dout, float* dq, long BH, int T,
              int H, float sm_scale, cudaStream_t stream) {
  const size_t smem = msfa_tc::DqLayout<D>::kBytes;
  cudaError_t err = allow_smem(flash_dq_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (T + msfa_tc::kBwdTile - 1) / msfa_tc::kBwdTile;
  if (BH * n_qt > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  flash_dq_kernel<D><<<(unsigned)(BH * n_qt), msfa_tc::kBwdThreads, smem, stream>>>(
      q, k, v, lengths, lse, delta, dout, dq, T, H, n_qt, sm_scale);
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
