// Packed multi-head self-attention forward, f32 and bf16 operands, for Hopper
// (sm_90a).
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
// TPU kernel does. Query rows are not masked; any T (a padded T = 72 is not a
// multiple of the 64-row tile).
//
// What bounds it on the H100: arithmetic. At the serving shape (B=64, T=512,
// H=4, D=64) with every key valid one launch does 4*B*H*T*T*D = 17.2 GFLOP
// and moves 135 MB (qkv in, out and lse back, 0.04 ms at 3.35 TB/s). The TPU
// kernel fed bf16 to the MXU; the port's limits are f32's (1e-4), which bf16
// and one TF32 product miss. Both products run on the TF32 tensor cores at
// f32 accuracy, three mma.sync TF32 products per f32 product (tf32_mma.cuh):
// 0.10 ms at 495/3 = 165 TFLOP/s, against 0.26 ms at 67 TFLOP/s on the CUDA
// cores.
//
// Design: flash_fwd_single_kernel's (flash_attention.cu) on the packed
// layout's strides, one body in attention_fwd.cuh: one block of 4 warps per
// (64-query tile, head, batch row); an online softmax over 64-key tiles with
// one rescale per tile in registers; q scaled once and held in registers; K
// and V tiles by cp.async into a two-stage ring, read straight from the
// strided packed rows (each tile row is D contiguous floats at a stride of
// 3F, no transpose pass); P from the score accumulators into P.V with no
// shared round trip, each two 8-key steps of P.V in a fresh accumulator added
// to O in FP32. Key tiles at or past the row's length are skipped: a length-0
// row runs no tile and takes the exact-zero branch.
//
// bf16 entry (msfa_packed_attention_fwd_bf16, mixed_precision): qkv bf16,
// out and lse f32, the function the reference computes off the TPU (its
// interpret path casts a bf16 qkv to f32: the f32 arithmetic on the bf16
// values). The TPU kernel rounds P to bf16 for the MXU; that misses f32's
// 1e-5 limit by two orders, so this entry keeps P at f32 accuracy.
//   Bound: it moves 84 MB at the serving shape (half the bytes of qkv in,
//   out and lse f32 back), and its products run at the bf16 tensor-core peak
//   (989 TFLOP/s): Q.K^T once and P.V as the two bf16 terms of P that meet
//   f32's 1e-5 limit. Bytes and operations bound it about equally there,
//   0.025 ms (chip_smoke.py's _bf16_bound; 0.042 with P.V counted at two
//   TF32 passes, as the old body ran it).
//   Design: wgmma (wgmma_bf16.cuh's attention_fwd_wg), two warpgroups a
//   block of 128 query rows of one (b, h), sharing the K and V tiles. S =
//   Q K^T is m64n64k16 bf16 wgmma from shared memory (the exact products
//   summed in f32), scaled by sm_scale after. The online softmax runs on the
//   accumulator's rows as it did on mma.sync's (each warp's 16 rows in the
//   same (g, 2t) places). P is split in registers into three bf16 terms (hi,
//   lo, lo2: p to ~2^-26), each the register A operand of one wgmma with the
//   V tile as B, V read d-contiguous as an MN-major operand (no transpose
//   pass); a tile's terms go into a fresh accumulator added to O in FP32. Q,
//   and K and V in a two-stage ring, go into 128-byte-swizzled shared memory
//   by cp.async (the head dim zero-padded to whole 64-wide panels: d 16 and
//   32 run as 64). Key tiles at or past the length are skipped; no atomics,
//   so two runs give the same bits.
//   It replaced the f32 body's bf16 instantiation (attention_fwd.cuh: one
//   TF32 m16n8k8 mma.sync pass for Q.K^T and two for P.V on bf16 values
//   widened to TF32, 16-key fresh accumulators): 0.2560 -> 0.0973 ms at B
//   64, T 512, H 4, d 64, every key valid, where SDPA in bf16 takes 0.0867
//   (scripts/attention_kernels_ab.py, an H100 80GB HBM3 at 700 W).

#include <cuda_runtime.h>

#include "attention_fwd.cuh"
#include "wgmma_bf16.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(msfa_tc::kFwdThreads)
packed_attention_fwd_kernel(const float* __restrict__ qkv, const int* __restrict__ lengths,
                            float* __restrict__ out, float* __restrict__ lse, int T, int H,
                            float sm_scale) {
  extern __shared__ __align__(16) float packed_smem[];
  const int q0 = blockIdx.x * msfa_tc::kFwdTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int F = H * D;
  const long ld = 3L * F;
  const float* q = qkv + (long)b * T * ld + h * D;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > T ? T : len);
  const msfa_tc::FwdRow row{q,   q + F, q + 2 * F, ld, out + (long)b * T * F + h * D, F,
                            lse + (long)b * T * H + h, H};
  msfa_tc::attention_fwd_tile<D>(row, T, len, q0, sm_scale, packed_smem);
}

// the bf16 entry's kernel, on wgmma
template <int D>
__global__ void __launch_bounds__(msfa_wg::AttnWg<D>::kThreads)
packed_attention_fwd_wg_kernel(const __nv_bfloat16* __restrict__ qkv,
                               const int* __restrict__ lengths, float* __restrict__ out,
                               float* __restrict__ lse, int T, int H, float sm_scale) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const int q0 = blockIdx.x * msfa_wg::AttnWg<D>::kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int F = H * D;
  const long ld = 3L * F;
  const __nv_bfloat16* q = qkv + (long)b * T * ld + h * D;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > T ? T : len);
  msfa_wg::attention_fwd_wg<D>(q, q + F, q + 2 * F, ld, out + (long)b * T * F + h * D, F,
                               lse + (long)b * T * H + h, H, T, len, q0, sm_scale,
                               msfa_wg::align1024(wg_smem));
}

template <int D>
int launch(const float* qkv, const int* lengths, float* out, float* lse, int B, int T, int H,
           float sm_scale, cudaStream_t stream) {
  const size_t smem = msfa_tc::fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(packed_attention_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + msfa_tc::kFwdTileQ - 1) / msfa_tc::kFwdTileQ, H, B);
  packed_attention_fwd_kernel<D><<<grid, msfa_tc::kFwdThreads, smem, stream>>>(
      qkv, lengths, out, lse, T, H, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wg(const __nv_bfloat16* qkv, const int* lengths, float* out, float* lse, int B, int T,
              int H, float sm_scale, cudaStream_t stream) {
  constexpr int kSmem = msfa_wg::AttnWg<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(packed_attention_fwd_wg_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  using A = msfa_wg::AttnWg<D>;
  const dim3 grid((T + A::kRows - 1) / A::kRows, H, B);
  packed_attention_fwd_wg_kernel<D><<<grid, A::kThreads, kSmem, stream>>>(qkv, lengths, out, lse,
                                                                         T, H, sm_scale);
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

// The bf16 entry: qkv bf16, out and lse f32, on wgmma.
int msfa_packed_attention_fwd_bf16(const __nv_bfloat16* qkv, const int* lengths, float* out,
                                   float* lse, int B, int T, int H, int D, float sm_scale,
                                   void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_wg<16>(qkv, lengths, out, lse, B, T, H, sm_scale, s);
    case 32: return launch_wg<32>(qkv, lengths, out, lse, B, T, H, sm_scale, s);
    case 64: return launch_wg<64>(qkv, lengths, out, lse, B, T, H, sm_scale, s);
    case 128: return launch_wg<128>(qkv, lengths, out, lse, B, T, H, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
