// Self-attention forward on the [B*H, T, D] layout, f32, for Hopper (sm_90a):
// the single-key-block kernel and the tiled kernel, two entries on one body.
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
// Both run both products on the TF32 tensor cores at f32 accuracy, three
// mma.sync TF32 products per f32 product (3xTF32): 0.21 ms for that shape at
// 495/3 = 165 TFLOP/s, against 0.51 ms at 67 TFLOP/s on the CUDA cores. The
// TPU's single-key-block kernel sees the whole key axis at once and skips the
// running rescale because VMEM holds [block_q, T] scores; in a block's shared
// memory those scores would leave one block per SM and cap T. The TPU's tiled
// kernel walks key blocks with a running max and sum, which is what the body
// does for every T: an online softmax over 64-key tiles with one rescale per
// tile, in registers, one block of 4 warps per 64 query rows (the body in
// attention_fwd.cuh, which packed_attention_fwd_kernel shares on the packed
// layout). So the two kernels give the same bits on the same inputs; the
// router's choice between them (SINGLE_K_MAX, the reference's) stays.
//
// Key tiles at or past the row's length are skipped, so every processed tile
// holds at least one valid key. Offsets into q/k/v/out are 64-bit: [256,
// 4096, 64] is 67 M elements per tensor.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_fwd.cuh"

namespace {

// One block per (64-query tile, row bh): the row's strided views for the body.
template <int D>
__device__ __forceinline__ void forward_tile(const float* q, const float* k, const float* v,
                                             const int* lengths, float* out, float* lse, int T,
                                             int H, int q_tiles, float sm_scale, float* smem) {
  const long bh = blockIdx.x / q_tiles;
  const int q0 = (int)(blockIdx.x % q_tiles) * msfa_tc::kFwdTileQ;
  const long at = bh * T * D;
  int len = lengths[bh / H];
  len = len < 0 ? 0 : (len > T ? T : len);
  const msfa_tc::FwdRow row{q + at, k + at, v + at, D, out + at, D, lse + bh * T, 1};
  msfa_tc::attention_fwd_tile<D>(row, T, len, q0, sm_scale, smem);
}

// Two entries on the one body, each with its own name, so that profiles and
// ptxas report the single-key-block and the tiled route apart.
template <int D>
__global__ void __launch_bounds__(msfa_tc::kFwdThreads)
flash_fwd_single_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ lengths,
                        float* __restrict__ out, float* __restrict__ lse, int T, int H,
                        int q_tiles, float sm_scale) {
  extern __shared__ __align__(16) float single_smem[];
  forward_tile<D>(q, k, v, lengths, out, lse, T, H, q_tiles, sm_scale, single_smem);
}

template <int D>
__global__ void __launch_bounds__(msfa_tc::kFwdThreads)
flash_fwd_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const int* __restrict__ lengths,
                       float* __restrict__ out, float* __restrict__ lse, int T, int H,
                       int q_tiles, float sm_scale) {
  extern __shared__ __align__(16) float tiled_smem[];
  forward_tile<D>(q, k, v, lengths, out, lse, T, H, q_tiles, sm_scale, tiled_smem);
}

template <int D, bool kTiled>
int launch(const float* q, const float* k, const float* v, const int* lengths, float* out,
           float* lse, long BH, int T, int H, float sm_scale, cudaStream_t stream) {
  const auto kernel = kTiled ? flash_fwd_tiled_kernel<D> : flash_fwd_single_kernel<D>;
  const size_t smem = msfa_tc::fwd_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (T + msfa_tc::kFwdTileQ - 1) / msfa_tc::kFwdTileQ;
  const long blocks = BH * q_tiles;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, msfa_tc::kFwdThreads, smem, stream>>>(q, k, v, lengths, out, lse, T,
                                                                    H, q_tiles, sm_scale);
  return (int)cudaGetLastError();
}

template <bool kTiled>
int dispatch(const float* q, const float* k, const float* v, const int* lengths, float* out,
             float* lse, int B, int T, int H, int D, float sm_scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long BH = (long)B * H;
  switch (D) {
    case 16: return launch<16, kTiled>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, s);
    case 32: return launch<32, kTiled>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, s);
    case 64: return launch<64, kTiled>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, s);
    case 128: return launch<128, kTiled>(q, k, v, lengths, out, lse, BH, T, H, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, out: [B*H, T, D] f32; lengths: [B] int32; lse: [B*H, T] f32.
// Head dims the kernels are instantiated for; the wrapper checks before calling.
int msfa_flash_fwd_single(const float* q, const float* k, const float* v, const int* lengths,
                          float* out, float* lse, int B, int T, int H, int D, float sm_scale,
                          void* stream) {
  return dispatch<false>(q, k, v, lengths, out, lse, B, T, H, D, sm_scale, stream);
}

int msfa_flash_fwd_tiled(const float* q, const float* k, const float* v, const int* lengths,
                         float* out, float* lse, int B, int T, int H, int D, float sm_scale,
                         void* stream) {
  return dispatch<true>(q, k, v, lengths, out, lse, B, T, H, D, sm_scale, stream);
}

// Dynamic shared memory per block of both forward kernels at head dim D.
int msfa_flash_fwd_smem_bytes(int D) {
  switch (D) {
    case 16: return (int)msfa_tc::fwd_smem_bytes<16>();
    case 32: return (int)msfa_tc::fwd_smem_bytes<32>();
    case 64: return (int)msfa_tc::fwd_smem_bytes<64>();
    case 128: return (int)msfa_tc::fwd_smem_bytes<128>();
    default: return -1;
  }
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
