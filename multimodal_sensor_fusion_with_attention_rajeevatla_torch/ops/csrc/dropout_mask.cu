// Dropout keep-mask generator: Philox4x32-10 written out, for Hopper (sm_90a).
//
// Replaces: multimodal_sensor_fusion_with_attention_rajeevatla_tpu/ops/pallas_mlp.py
//   dropout_keep_mask (inner kernel `kern`): a uint8 Bernoulli(keep_prob) mask,
//   keep an element iff a uniform 32-bit word is below
//   thr = min(round(keep_prob * 2^32), 2^32 - 1), compared unsigned.
//
// The TPU kernel seeds its hardware generator once per row tile; Hopper has
// no such unit, so this is a counter-based generator (Salmon et al., SC'11):
//   key     = (seed[0] ^ purpose * 0x9E3779B9, seed[1])
//   counter = (g & 0xffffffff, g >> 32, 0, 0),  g = element index / 4
// One Philox call gives four words, hence the four mask bytes 4g .. 4g+3, so
// the stream depends on (seed, purpose, element index) alone and not on the
// launch geometry or the mask's row width. The two seed words are read from
// device memory: the caller draws them on the card and never waits for them.
// The stream is the port's own: it is neither the TPU's nor torch.rand's.
//
// What bounds it on the H100: bytes (one byte written per element; 33.6 MB
// for a [16384, 2048] mask is 0.010 ms at 3.35 TB/s). Each thread makes four
// Philox calls (about 10 * 4 multiplies each) and stores 16 bytes at once;
// the ragged end of the mask is stored byte by byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;
constexpr int kGroupsPerThread = 4;  // 16 mask bytes per thread

__device__ __forceinline__ void philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                              uint32_t c3, uint32_t k0, uint32_t k1,
                                              uint32_t (&out)[4]) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += kW0; k1 += kW1;
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

// The four mask bytes of group g, packed little-endian into one word.
__device__ __forceinline__ uint32_t group_bytes(unsigned long long g, uint32_t k0, uint32_t k1,
                                                uint32_t thr, int all_keep) {
  uint32_t w[4];
  philox4x32_10((uint32_t)g, (uint32_t)(g >> 32), 0u, 0u, k0, k1, w);
  uint32_t packed = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) packed |= (uint32_t)(all_keep || w[j] < thr) << (8 * j);
  return packed;
}

__global__ void __launch_bounds__(kThreads)
dropout_mask_kernel(const int* __restrict__ seed, unsigned char* __restrict__ out,
                    long long total, uint32_t purpose, uint32_t thr, int all_keep) {
  const uint32_t k0 = (uint32_t)seed[0] ^ (purpose * kW0);
  const uint32_t k1 = (uint32_t)seed[1];
  const long long groups = (total + 3) / 4;
  const long long first = ((long long)blockIdx.x * kThreads + threadIdx.x) * kGroupsPerThread;
  if (first >= groups) return;
  if ((first + kGroupsPerThread) * 4 <= total) {  // 16 whole bytes, 16-byte aligned
    uint4 v;
    v.x = group_bytes(first + 0, k0, k1, thr, all_keep);
    v.y = group_bytes(first + 1, k0, k1, thr, all_keep);
    v.z = group_bytes(first + 2, k0, k1, thr, all_keep);
    v.w = group_bytes(first + 3, k0, k1, thr, all_keep);
    *reinterpret_cast<uint4*>(out + first * 4) = v;
    return;
  }
  for (long long g = first; g < groups && g < first + kGroupsPerThread; ++g) {
    const uint32_t packed = group_bytes(g, k0, k1, thr, all_keep);
    for (int j = 0; j < 4; ++j) {
      const long long e = g * 4 + j;
      if (e < total) out[e] = (unsigned char)((packed >> (8 * j)) & 1u);
    }
  }
}

}  // namespace

extern "C" {

// seed: [2] int32 on the device; out: [total] uint8, 16-byte aligned (a
// freshly allocated tensor is). thr is the unsigned 32-bit keep threshold;
// all_keep != 0 keeps every element (keep_prob >= 1).
int msfa_dropout_mask(const int* seed, unsigned char* out, long long total, unsigned purpose,
                      unsigned thr, int all_keep, void* stream) {
  if (total <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const long long groups = (total + 3) / 4;
  const long long per_block = (long long)kThreads * kGroupsPerThread;
  const long long blocks = (groups + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dropout_mask_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, out, total, purpose, thr, all_keep);
  return (int)cudaGetLastError();
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
