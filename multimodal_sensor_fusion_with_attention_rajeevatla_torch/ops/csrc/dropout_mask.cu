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
// One launch writes up to kMaxMasks masks of one seed (a transformer layer's
// attention, hidden and residual masks): each mask has its own output,
// element count and purpose, and its own range of blocks, sized in
// proportion to its bytes so that the masks finish together.
//
// What bounds it on the H100: integer operations, then bytes. A Philox call
// is 10 rounds of two 32x32->64-bit products and two three-input XORs
// (LOP3), 19 products where the counter's words c2 = c3 = 0 (the first
// round's product of c2 is zero); a mask of N elements makes N / 4 calls and
// writes N bytes. At [16384, 2048] that is 8.39 M calls against 33.6 MB
// (0.010 ms at 3.35 TB/s). A product takes the IMAD pipe for two 32-bit
// results of its 64 a clock per SM (an H100 80GB HBM3 ran 62 a clock for
// products written as IMAD.HI and IMAD, scripts/dropout_mask_variants.py);
// chip_smoke.py works the integer bound from the function, 38 IMAD results a
// call: 0.019 ms at [16384, 2048], where the kernel takes 0.032 a call
// alone (PERF.md, row 9). The design:
// - the walk over whole 16-byte chunks is one straight loop: four calls a
//   chunk, one 16-byte store (coalesced across the warp), no ragged case
//   inside; the one thread whose walk reaches the mask's ragged end stores
//   it byte by byte after the loop;
// - the grid is as many blocks as the card holds at once, each walking its
//   mask with a stride, so the seed load is paid once a thread and no
//   partial last wave is left (one pass of blocks: 5-7% slower);
// - one chunk (four independent calls) in flight a thread (two: the same
//   or 2-3% slower; four: 10-22% slower);
// - the round keys held, computed once a thread, and each product written
//   as __umulhi and a low multiply; adding the keys in each call, or one
//   (uint64_t)a * b a product, moved the time by 3% at most either way,
//   the sign changing from build to build: the compiler emits IMAD.WIDE.U32
//   for most products of either form and keeps the keys in uniform
//   registers
// (scripts/dropout_mask_variants.py, three runs on the same card). The
// stream is the parent design's, byte for byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr int kRounds = 10;
constexpr int kThreads = 256;
constexpr int kChunksInFlight = 1;  // 16-byte chunks a thread computes at once (4 calls each)
constexpr int kMaxMasks = 3;
constexpr long long kMaxChunks = 1ll << 31;  // chunk indices are 32-bit

struct MaskSet {
  unsigned char* out[kMaxMasks];
  long long total[kMaxMasks];    // elements
  uint32_t purpose[kMaxMasks];
  int first_block[kMaxMasks + 1];  // mask i runs blocks [first_block[i], first_block[i + 1])
  int count;
};

// (hi, lo) of the 32x32->64-bit product a * b (the compiler mostly fuses the
// two into one IMAD.WIDE.U32)
__device__ __forceinline__ void mulhilo(uint32_t a, uint32_t b, uint32_t& hi, uint32_t& lo) {
  hi = __umulhi(a, b);
  lo = a * b;
}

// the round keys of both key words, key[0][r] = k0 + r kW0 and key[1][r] =
// k1 + r kW1, computed once a thread
using RoundKeys = uint32_t[2][kRounds];

// the four mask bytes of group g = (g0, g1) (counter (g0, g1, 0, 0)), packed
// little-endian
__device__ __forceinline__ uint32_t group_bytes(uint32_t g0, uint32_t g1, const RoundKeys& key,
                                                uint32_t thr) {
  uint32_t c0 = g0, c1 = g1, c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    uint32_t hi0, lo0, hi1, lo1;
    mulhilo(kM0, c0, hi0, lo0);
    mulhilo(kM1, c2, hi1, lo1);
    c0 = hi1 ^ c1 ^ key[0][r];
    c2 = hi0 ^ c3 ^ key[1][r];
    c1 = lo1;
    c3 = lo0;
  }
  return (uint32_t)(c0 < thr) | (uint32_t)(c1 < thr) << 8 | (uint32_t)(c2 < thr) << 16 |
         (uint32_t)(c3 < thr) << 24;
}

// the 16 bytes of chunk c (groups 4c .. 4c + 3, element 16c on)
__device__ __forceinline__ uint4 chunk_bytes(uint32_t c, const RoundKeys& key, uint32_t thr,
                                             int all_keep) {
  if (all_keep) return make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
  const uint32_t g0 = c << 2, g1 = c >> 30;  // g = 4c + j as two 32-bit words
  return make_uint4(group_bytes(g0, g1, key, thr), group_bytes(g0 | 1u, g1, key, thr),
                    group_bytes(g0 | 2u, g1, key, thr), group_bytes(g0 | 3u, g1, key, thr));
}

__global__ void __launch_bounds__(kThreads)
dropout_mask_kernel(const int* __restrict__ seed, MaskSet set, uint32_t thr, int all_keep) {
  // this block's mask, picked by selects (no dynamic index into the parameters)
  unsigned char* __restrict__ out = set.out[0];
  long long total = set.total[0];
  uint32_t purpose = set.purpose[0];
  int begin = 0, end = set.first_block[1];
#pragma unroll
  for (int i = 1; i < kMaxMasks; ++i)
    if (i < set.count && (int)blockIdx.x >= set.first_block[i]) {
      out = set.out[i];
      total = set.total[i];
      purpose = set.purpose[i];
      begin = set.first_block[i];
      end = set.first_block[i + 1];
    }
  const uint32_t whole = (uint32_t)(total / 16), stride = (uint32_t)(end - begin) * kThreads;
  const uint32_t first = ((uint32_t)blockIdx.x - begin) * kThreads + threadIdx.x;
  RoundKeys key;
  key[0][0] = (uint32_t)seed[0] ^ (purpose * kW0);
  key[1][0] = (uint32_t)seed[1];
#pragma unroll
  for (int r = 1; r < kRounds; ++r) {
    key[0][r] = key[0][r - 1] + kW0;
    key[1][r] = key[1][r - 1] + kW1;
  }
  uint4* __restrict__ out16 = reinterpret_cast<uint4*>(out);
  // whole chunks: kChunksInFlight at once, each one 16-byte store
  for (uint32_t c = first; c < whole; c += kChunksInFlight * stride) {
    uint4 v[kChunksInFlight];
#pragma unroll
    for (int i = 0; i < kChunksInFlight; ++i)
      v[i] = chunk_bytes(c + i * stride, key, thr, all_keep);
#pragma unroll
    for (int i = 0; i < kChunksInFlight; ++i)
      if (c + i * stride < whole) out16[c + i * stride] = v[i];
  }
  // the ragged end, byte by byte, by the one thread whose walk reaches it
  if (total % 16 != 0 && first == whole % stride) {
    const uint4 v = chunk_bytes(whole, key, thr, all_keep);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 15; ++e)
      if (16ll * whole + e < total)
        out[16ll * whole + e] = (unsigned char)((words[e / 4] >> (8 * (e % 4))) & 1u);
  }
}

// blocks the card holds at once (per device, read once)
int resident_blocks() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dropout_mask_kernel, kThreads,
                                                      0) != cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

extern "C" {

// `count` (1 .. 3) masks of one seed in one launch, mask i at out<i> (total<i>
// elements, purpose<i>; the slots past `count` are not read): scalar
// arguments, so the caller builds no array a launch. seed: [2] int32 on the
// device; each out: uint8 on the device, 16-byte aligned (a freshly
// allocated tensor is), each total > 0. thr is the unsigned 32-bit keep
// threshold; all_keep != 0 keeps every element (keep_prob >= 1).
int msfa_dropout_masks(const int* seed, int count, unsigned char* out0, long long total0,
                       unsigned purpose0, unsigned char* out1, long long total1,
                       unsigned purpose1, unsigned char* out2, long long total2,
                       unsigned purpose2, unsigned thr, int all_keep, void* stream) {
  static_assert(kMaxMasks == 3, "one argument triple a mask");
  unsigned char* const outs[kMaxMasks] = {out0, out1, out2};
  const long long totals[kMaxMasks] = {total0, total1, total2};
  const unsigned purposes[kMaxMasks] = {purpose0, purpose1, purpose2};
  if (count < 1 || count > kMaxMasks) return (int)cudaErrorInvalidValue;
  const int capacity = resident_blocks();
  if (capacity <= 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  MaskSet set = {};
  set.count = count;
  long long all_chunks = 0;
  for (int i = 0; i < count; ++i) {
    if (totals[i] <= 0 || (totals[i] + 15) / 16 >= kMaxChunks) return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(outs[i]) % 16 != 0) return (int)cudaErrorMisalignedAddress;
    all_chunks += (totals[i] + 15) / 16;
  }
  for (int i = 0; i < count; ++i) {
    const long long chunks = (totals[i] + 15) / 16;
    // its share of the card's resident blocks, no more than one pass needs
    const long long one_pass = (chunks + (long long)kThreads * kChunksInFlight - 1) /
                               ((long long)kThreads * kChunksInFlight);
    long long blocks = capacity * chunks / all_chunks;
    blocks = blocks < 1 ? 1 : (blocks > one_pass ? one_pass : blocks);
    set.out[i] = outs[i];
    set.total[i] = totals[i];
    set.purpose[i] = purposes[i];
    set.first_block[i + 1] = set.first_block[i] + (int)blocks;
  }
  for (int i = count + 1; i <= kMaxMasks; ++i) set.first_block[i] = set.first_block[count];
  dropout_mask_kernel<<<set.first_block[count], kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, set, thr, all_keep);
  return (int)cudaGetLastError();
}

// the launch's shape, printed by chip_smoke.py beside the kernel's bound:
// info[0] threads a block, [1] Philox calls a thread's loop iteration makes,
// [2] blocks the card holds at once
int msfa_dropout_mask_info(int* info) {
  info[0] = kThreads;
  info[1] = 4 * kChunksInFlight;
  info[2] = resident_blocks();
  return info[2] > 0 ? 0 : (int)cudaErrorInvalidValue;
}

const char* msfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
