// Packed multi-head self-attention backward, f32 and bf16 operands, for Hopper
// (sm_90a).
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
//   2. bwd_kernel: one block of 4 warps per (64-key tile, head, batch row),
//      the body in attention_bwd.cuh (shared with flash_bwd_fused_kernel on
//      the [B*H, T, D] layout): K and V stay in shared memory while the
//      block walks the 64-row query tiles, which arrive by cp.async into a
//      two-stage ring read straight from the strided packed layout; S^T, dP^T,
//      P^T, dS^T per warp in registers; dv and dk per query tile in a fresh
//      accumulator added in FP32; dS^T once through shared memory for the
//      tile's dq partial. A tile at or past the length writes zero dk and dv
//      and no partial.
//   3. dq_reduce_kernel: dq = sm_scale * sum of the partials of the key tiles
//      below the length, in key-tile order.
// No atomics: a run repeats bit for bit. 105 KB of shared memory per block at
// D = 64, so two blocks fit on an SM. The scratch holds delta [B, T, H] and
// the partials [B, ceil(T/64), T, F].
//
// bf16 entry (msfa_packed_attention_bwd_bf16, mixed_precision): qkv bf16,
// out, lse and dout f32, dqkv bf16, each of dq, dk, dv rounded to nearest
// even once from f32 sums (the VJP of the reference's cast of a bf16 qkv to
// f32). Every product on wgmma m64n64k16 bf16 (wgmma_attention_bwd.cuh),
// the f32 operands carried as three bf16 terms each. Three launches:
//   1. bwd_prep_kernel: delta, dout's bf16 planes, and per 64-row query
//      tile of each (b, h) whether it needs one plane (every entry a bf16
//      value: the model's cotangent) or three, one block a tile.
//   2. bwd_dkv_wg_kernel: dk and dv, one warpgroup of 64 keys a block.
//   3. bwd_dq_wg_kernel: dq, one warpgroup of 64 queries a block, S and dP
//      taken again, the key tiles' products added in key-tile order.
// No partial of dq goes through device memory. Scratch: dout's planes [3,
// B, T, F] bf16, delta [B, T, H], the plane counts [B, H, ceil(T/64)]. Its
// bound: each product at the bf16 tensor-core peak (989 TFLOP/s) for the
// terms it takes, 13 products a (query, key) tile pair with a bf16
// cotangent (20 with an f32 one): 0.056 ms at B=32, T=512, H=4, D=64 with
// every key valid, against ~110 MB (0.03 ms). msfa_packed_attention_bwd_bf16_sums
// is the same computation with dqkv written in f32 before the rounding (the
// sums alone, for checking their accuracy).

#include <cuda_runtime.h>

#include "attention_bwd.cuh"
#include "wgmma_attention_bwd.cuh"

namespace {

constexpr int kTile = msfa_tc::kBwdTile;

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

template <int D>
__global__ void __launch_bounds__(msfa_tc::kBwdThreads)
bwd_kernel(const float* __restrict__ qkv, const int* __restrict__ lengths,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const float* __restrict__ dout, float* __restrict__ dqkv,
           float* __restrict__ dq_part, int T, int H, float sm_scale) {
  extern __shared__ __align__(16) float bwd_smem[];
  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int F = H * D;
  const long ld = 3L * F;
  const long stat = (long)b * T * H + h;
  const float* q = qkv + (long)b * T * ld + h * D;
  float* dk = dqkv + (long)b * T * ld + F + h * D;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > T ? T : len);
  const msfa_tc::BwdRow row{
      q, q + F, q + 2 * F, ld,                                    // q, k, v
      dout + (long)b * T * F + h * D, F,                          // dout
      lse + stat, delta + stat, H,                                // lse, delta
      dk, dk + F, ld,                                             // dk, dv
      dq_part + ((long)b * gridDim.x + kt) * T * F + h * D, F};   // this tile's dq partial
  msfa_tc::attention_bwd_tile<D>(row, T, len, kt * kTile, sm_scale, bwd_smem);
}

// dq[b, t, f] = sm_scale * sum over key tiles kt < ceil(len_b / 64) of
// dq_part[b, kt, t, f], in order; four floats per thread.
__global__ void dq_reduce_kernel(const float* __restrict__ dq_part,
                                 const int* __restrict__ lengths, float* __restrict__ dqkv,
                                 int T, int F, int n_kt, float sm_scale, long quads) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  msfa_tc::dq_reduce(dq_part, lengths, dqkv, T, F, n_kt, 1, 3L * F, sm_scale, i);
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
  const size_t smem = msfa_tc::BwdLayout<D>::kBytes;
  err = cudaFuncSetAttribute(bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<D><<<dim3(n_kt, H, B), msfa_tc::kBwdThreads, smem, stream>>>(
      qkv, lengths, lse, delta, dout, dqkv, dq_part, T, H, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dq_reduce_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
      dq_part, lengths, dqkv, T, H * D, n_kt, sm_scale, quads);
  return (int)cudaGetLastError();
}

// ---- the bf16 entry, on wgmma ---------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWgRows = msfa_wg::kBwdTileRows;  // keys or queries a block

// the bf16 scratch: dout's planes [3][B, T, F] (bf16), then delta [B, T, H]
// and the plane counts (1 or 3) [B, H, ceil(T/64)], in floats
struct WgScratch {
  bf16* planes;
  float* delta;
  int* nterms;
  long plane_stride;  // elements of one plane
};

WgScratch wg_scratch(float* scratch, int B, int T, int H, int D) {
  const long plane = (long)B * T * H * D;
  float* delta = scratch + (msfa_wg::kDoutTerms * plane + 1) / 2;
  return {reinterpret_cast<bf16*>(scratch), delta,
          reinterpret_cast<int*>(delta + (long)B * T * H), plane};
}

long wg_scratch_floats(int B, int T, int H, int D) {
  const long plane = (long)B * T * H * D;
  const long n_qt = (T + msfa_wg::kBwdTileRows - 1) / msfa_wg::kBwdTileRows;
  return (msfa_wg::kDoutTerms * plane + 1) / 2 + (long)B * T * H + (long)B * H * n_qt;
}

template <typename Out>
__device__ __forceinline__ msfa_wg::BwdWgRow<Out> wg_row(const bf16* qkv, WgScratch sc,
                                                         const float* lse, Out* dqkv, int T,
                                                         int H, int D) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int F = H * D;
  const long ld = 3L * F;
  const long stat = (long)b * T * H + h;
  const bf16* q = qkv + (long)b * T * ld + h * D;
  Out* dq = dqkv + (long)b * T * ld + h * D;
  const int n_qt = (T + msfa_wg::kBwdTileRows - 1) / msfa_wg::kBwdTileRows;
  return {q, q + F, q + 2 * F, ld,
          sc.planes + (long)b * T * F + h * D, sc.plane_stride, F,
          lse + stat, sc.delta + stat, H,
          sc.nterms + ((long)b * H + h) * n_qt,
          dq, dq + F, dq + 2 * F};
}

__device__ __forceinline__ int clamp_len(const int* lengths, int T) {
  const int len = lengths[blockIdx.z];
  return len < 0 ? 0 : (len > T ? T : len);
}

// delta, dout's planes and their count for one 64-row query tile of one (b, h)
template <int D>
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const float* __restrict__ out, const float* __restrict__ dout, WgScratch sc,
                int T, int H) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long F = (long)H * D;
  const long base = (long)b * T * F + h * D;
  msfa_wg::bwd_prep_tile<D>(out + base, dout + base, F, sc.delta + (long)b * T * H + h, H,
                            sc.planes + base, sc.plane_stride,
                            sc.nterms + ((long)b * H + h) * gridDim.x + qt, qt * 64, T);
}

template <int D, typename Out>
__global__ void __launch_bounds__(msfa_wg::AttnBwdWg<D>::kThreads, 1)
bwd_dkv_wg_kernel(const bf16* __restrict__ qkv, const int* __restrict__ lengths,
                  const float* __restrict__ lse, WgScratch sc, Out* __restrict__ dqkv, int T,
                  int H, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  msfa_wg::attention_dkv_wg<D>(wg_row(qkv, sc, lse, dqkv, T, H, D), T, clamp_len(lengths, T),
                               blockIdx.x * kWgRows, sm_scale, msfa_wg::align1024(wg_smem));
}

template <int D, typename Out>
__global__ void __launch_bounds__(msfa_wg::AttnBwdWg<D>::kThreads, 1)
bwd_dq_wg_kernel(const bf16* __restrict__ qkv, const int* __restrict__ lengths,
                 const float* __restrict__ lse, WgScratch sc, Out* __restrict__ dqkv, int T,
                 int H, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  msfa_wg::attention_dq_wg<D>(wg_row(qkv, sc, lse, dqkv, T, H, D), T, clamp_len(lengths, T),
                              blockIdx.x * kWgRows, sm_scale, msfa_wg::align1024(wg_smem));
}

template <int D, typename Out>
int launch_wg(const bf16* qkv, const int* lengths, const float* out, const float* lse,
              const float* dout, float* scratch, Out* dqkv, int B, int T, int H, float sm_scale,
              cudaStream_t stream) {
  using A = msfa_wg::AttnBwdWg<D>;
  const WgScratch sc = wg_scratch(scratch, B, T, H, D);
  const int n_qt = (T + msfa_wg::kBwdTileRows - 1) / msfa_wg::kBwdTileRows;
  bwd_prep_kernel<D><<<dim3(n_qt, H, B), 256, 0, stream>>>(out, dout, sc, T, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kWgRows - 1) / kWgRows, H, B);
  err = cudaFuncSetAttribute(bwd_dkv_wg_kernel<D, Out>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, A::kDkvSmemBytes);
  if (err != cudaSuccess) return (int)err;
  bwd_dkv_wg_kernel<D, Out><<<grid, A::kThreads, A::kDkvSmemBytes, stream>>>(
      qkv, lengths, lse, sc, dqkv, T, H, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_wg_kernel<D, Out>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, A::kDqSmemBytes);
  if (err != cudaSuccess) return (int)err;
  bwd_dq_wg_kernel<D, Out><<<grid, A::kThreads, A::kDqSmemBytes, stream>>>(
      qkv, lengths, lse, sc, dqkv, T, H, sm_scale);
  return (int)cudaGetLastError();
}

int dispatch(const float* qkv, const int* lengths, const float* out, const float* lse,
             const float* dout, float* scratch, float* dqkv, int B, int T, int H, int D,
             float sm_scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(qkv, lengths, out, lse, dout, scratch, dqkv, B, T, H, sm_scale, s);
    case 32: return launch<32>(qkv, lengths, out, lse, dout, scratch, dqkv, B, T, H, sm_scale, s);
    case 64: return launch<64>(qkv, lengths, out, lse, dout, scratch, dqkv, B, T, H, sm_scale, s);
    case 128: return launch<128>(qkv, lengths, out, lse, dout, scratch, dqkv, B, T, H, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Out>
int dispatch_wg(const bf16* qkv, const int* lengths, const float* out, const float* lse,
                const float* dout, float* scratch, Out* dqkv, int B, int T, int H, int D,
                float sm_scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSFA_BWD_WG(W) \
  launch_wg<W>(qkv, lengths, out, lse, dout, scratch, dqkv, B, T, H, sm_scale, s)
  switch (D) {
    case 16: return MSFA_BWD_WG(16);
    case 32: return MSFA_BWD_WG(32);
    case 64: return MSFA_BWD_WG(64);
    case 128: return MSFA_BWD_WG(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MSFA_BWD_WG
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
  return dispatch(qkv, lengths, out, lse, dout, scratch, dqkv, B, T, H, D, sm_scale, stream);
}

// Floats of scratch for the bf16 entries: dout's planes [3, B, T, H * D] in
// bf16, delta [B, T, H], the plane counts [B, H, ceil(T / 64)].
long long msfa_packed_attention_bwd_bf16_scratch(int B, int T, int H, int D) {
  return wg_scratch_floats(B, T, H, D);
}

// The bf16 entry: qkv and dqkv bf16, out, lse and dout f32.
int msfa_packed_attention_bwd_bf16(const bf16* qkv, const int* lengths, const float* out,
                                   const float* lse, const float* dout, float* scratch,
                                   bf16* dqkv, int B, int T, int H, int D, float sm_scale,
                                   void* stream) {
  return dispatch_wg(qkv, lengths, out, lse, dout, scratch, dqkv, B, T, H, D, sm_scale, stream);
}

// The bf16 entry's sums before the rounding: dqkv f32.
int msfa_packed_attention_bwd_bf16_sums(const bf16* qkv, const int* lengths, const float* out,
                                        const float* lse, const float* dout, float* scratch,
                                        float* dqkv, int B, int T, int H, int D, float sm_scale,
                                        void* stream) {
  return dispatch_wg(qkv, lengths, out, lse, dout, scratch, dqkv, B, T, H, D, sm_scale, stream);
}
long long msfa_packed_attention_bwd_bf16_sums_scratch(int B, int T, int H, int D) {
  return wg_scratch_floats(B, T, H, D);
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
