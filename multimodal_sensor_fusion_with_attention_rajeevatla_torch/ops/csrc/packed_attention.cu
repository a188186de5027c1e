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
// bf16 entry (msfa_packed_attention_fwd_bf16, mixed_precision): the same body
// on a bf16 qkv, out and lse f32, the function the reference computes off the
// TPU (its interpret path casts a bf16 qkv to f32: the f32 arithmetic on the
// bf16 values). It reads half the bytes of qkv (50 MB at the serving shape)
// and takes Q.K^T as one TF32 product (exact on two bf16 operands) and P.V as
// two (f32 P, bf16 V): 3 of the f32 body's 6 TF32 passes. Its bound: Q.K^T at
// the bf16 tensor-core peak (989 TFLOP/s), P.V, which has an f32 operand, at
// the port's f32-class rate (3xTF32, 165 TFLOP/s): 0.0589 ms at the serving
// shape. The TPU kernel rounds P to bf16 as well; this entry keeps P in f32,
// as the reference's tested function does.

#include <cuda_runtime.h>

#include "attention_fwd.cuh"

namespace {

template <int D, typename In>
__global__ void __launch_bounds__(msfa_tc::kFwdThreads)
packed_attention_fwd_kernel(const In* __restrict__ qkv, const int* __restrict__ lengths,
                            float* __restrict__ out, float* __restrict__ lse, int T, int H,
                            float sm_scale) {
  extern __shared__ __align__(16) float packed_smem[];
  const int q0 = blockIdx.x * msfa_tc::kFwdTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int F = H * D;
  const long ld = 3L * F;
  const In* q = qkv + (long)b * T * ld + h * D;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > T ? T : len);
  const msfa_tc::FwdRow<In> row{q,   q + F, q + 2 * F, ld, out + (long)b * T * F + h * D, F,
                                lse + (long)b * T * H + h, H};
  msfa_tc::attention_fwd_tile<D, In>(row, T, len, q0, sm_scale, packed_smem);
}

template <int D, typename In>
int launch(const In* qkv, const int* lengths, float* out, float* lse, int B, int T, int H,
           float sm_scale, cudaStream_t stream) {
  const size_t smem = msfa_tc::fwd_smem_bytes<D, In>();
  cudaError_t err = cudaFuncSetAttribute(packed_attention_fwd_kernel<D, In>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + msfa_tc::kFwdTileQ - 1) / msfa_tc::kFwdTileQ, H, B);
  packed_attention_fwd_kernel<D, In><<<grid, msfa_tc::kFwdThreads, smem, stream>>>(
      qkv, lengths, out, lse, T, H, sm_scale);
  return (int)cudaGetLastError();
}

template <typename In>
int dispatch(const In* qkv, const int* lengths, float* out, float* lse, int B, int T, int H,
             int D, float sm_scale, void* stream) {
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

}  // namespace

extern "C" {

// Head dims the kernel is instantiated for; the wrapper checks before calling.
int msfa_packed_attention_fwd(const float* qkv, const int* lengths, float* out,
                              float* lse, int B, int T, int H, int D,
                              float sm_scale, void* stream) {
  return dispatch(qkv, lengths, out, lse, B, T, H, D, sm_scale, stream);
}

// The bf16 entry: qkv bf16, out and lse f32.
int msfa_packed_attention_fwd_bf16(const __nv_bfloat16* qkv, const int* lengths, float* out,
                                   float* lse, int B, int T, int H, int D, float sm_scale,
                                   void* stream) {
  return dispatch(qkv, lengths, out, lse, B, T, H, D, sm_scale, stream);
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
