// f32-accurate products on the TF32 tensor cores (3xTF32) and asynchronous
// tile copies, shared by the attention kernels (flash_attention.cu,
// packed_attention_bwd.cu) for Hopper (sm_90a).
//
// TF32 keeps 10 mantissa bits, so one TF32 product per f32 product misses the
// port's f32 limits (1e-4 max abs on an attention forward). Each f32 operand
// is split as a = hi + lo with hi = tf32(a) and lo = a - hi (read as TF32),
// and a*b is taken as lo*hi' + hi*lo' + hi*hi' with f32 accumulation (the
// dropped lo*lo' term and lo's cut bits are ~2^-21 of the product): three
// mma.sync m16n8k8 TF32 products per f32 product, so the unit's f32-class
// peak on the H100 is 495 / 3 = 165 TFLOP/s against 67 TFLOP/s on the CUDA
// cores.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 for lane
// (g = lane / 4, t = lane % 4), as (row, column):
//   A (16 x 8, m x k): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, k x n):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8, m x n): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product sums over k, so any order of k that A and B share gives the same
// result. Where A comes from an accumulator (P, dS) the kernels take logical
// k = t as column 2t and k = t + 4 as column 2t + 1 of the 8-wide tile: then
// a0..a3 are c0, c2, c1, c3 of the accumulator, with no shuffle, and B is read
// from rows 2t and 2t + 1 ("k down the column" below).
//
// Shared tiles are row-major with a row stride of (columns + kPad) floats: a
// multiple of 16 bytes, cp.async's unit. For the row lengths used here (16,
// 32, 64, 128) both load patterns touch 32 distinct banks per warp:
//   k along a row:    row g, columns t and t + 4     bank 4g + t (stride 20: 20g + t)
//   k down a column:  rows 2t and 2t + 1, column g   bank 8t + g (+ 4 on the odd row)
//
// bf16 operands (the mixed_precision entries). A tile may hold bf16 values,
// staged as they lie in device memory (half the bytes), rows padded by 16
// bytes as well (kPadOf<E>). A bf16 value is exact in TF32 (8 significant
// bits of TF32's 11): its hi is its bits shifted up by 16 and its lo is zero,
// so a product with a bf16 side drops that side's lo term (mma_n): two TF32
// products for an f32 x bf16 product, one for bf16 x bf16, each the same sum
// as the three of mma3 on the f32 copies (the dropped terms are exact zeros).
// Two lanes that read one 32-bit word of a bf16 tile get it broadcast; the
// patterns above stay free of bank conflicts at strides of 40 (k along a
// row) and D + 8 elements.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msfa_tc {

constexpr int kPad = 4;  // floats of padding per shared row

// Elements of padding per shared row of element type E (16 bytes), and
// whether an operand of that type carries a lo part (f32) or none (bf16).
template <typename E>
constexpr int kPadOf = 16 / (int)sizeof(E);
template <typename E>
constexpr bool kHasLo = sizeof(E) == 4;

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

// hi: x rounded to TF32 (half a TF32 ulp added to the bits, the low 13 bits
// cleared); lo: x - hi, exact in f32, whose low 13 bits the tensor core does
// not read (it takes a .tf32 operand's top 19 bits). Integer and FP32 pipes
// only: cvt.rna.tf32.f32 runs on the conversion pipe, and with it the split,
// not the tensor cores, set the pace of both kernels.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A bf16 element as a TF32 operand: exact, its bits shifted up, lo 0.
__device__ __forceinline__ void split(__nv_bfloat16 x, uint32_t& hi, uint32_t& lo) {
  hi = (uint32_t)__bfloat16_as_ushort(x) << 16;
  lo = 0u;
}

template <typename E>
__device__ __forceinline__ FragA split_a(E a0, E a1, E a2, E a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

template <typename E>
__device__ __forceinline__ FragB split_b(E b0, E b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// One f32 value's bits as a bf16 pair's halves: a 32-bit word of a bf16 tile
// holds the element at the lower address in its low half.
__device__ __forceinline__ uint32_t bf16_lo_half(uint32_t w) { return w << 16; }
__device__ __forceinline__ uint32_t bf16_hi_half(uint32_t w) { return w & 0xffff0000u; }

// d += a * b on one m16n8k8 TF32 tensor-core product.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b on one m16n8k8 TF32 product, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// d = a * b at f32 accuracy, from a zero accumulator.
__device__ __forceinline__ void mma3_zero(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32_zero(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// d += a * b at f32 accuracy: the two small terms first, then hi * hi.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// mma3 (kZero: mma3_zero) without the terms of a side that has no lo (a bf16
// operand, kALo / kBLo false): the same terms in the same order, the dropped
// ones exact zeros, so the same sum from one, two or three TF32 products.
template <bool kALo, bool kBLo, bool kZero = false>
__device__ __forceinline__ void mma_n(float (&d)[4], const FragA& a, const FragB& b) {
  if constexpr (kALo && kBLo) {
    if constexpr (kZero) mma3_zero(d, a, b); else mma3(d, a, b);
  } else if constexpr (kALo) {
    if constexpr (kZero) mma_tf32_zero(d, a.lo, b.hi); else mma_tf32(d, a.lo, b.hi);
    mma_tf32(d, a.hi, b.hi);
  } else if constexpr (kBLo) {
    if constexpr (kZero) mma_tf32_zero(d, a.hi, b.lo); else mma_tf32(d, a.hi, b.lo);
    mma_tf32(d, a.hi, b.hi);
  } else {
    if constexpr (kZero) mma_tf32_zero(d, a.hi, b.hi); else mma_tf32(d, a.hi, b.hi);
  }
}

// The loaders take a tile of f32 or bf16 elements (E), ld in elements.
// A, k along a row: the tile holds A as [m][k]; rows m0+g, m0+g+8, columns k0+t, k0+t+4.
template <typename E>
__device__ __forceinline__ FragA load_a_rowk(const E* s, int ld, int m0, int k0, int g, int t) {
  const E* p = s + (m0 + g) * ld + k0 + t;
  return split_a(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
}

// A, k down a column: the tile holds A transposed, [k][m]; logical k = t is
// row k0+2t and k = t+4 row k0+2t+1; columns m0+g, m0+g+8.
template <typename E>
__device__ __forceinline__ FragA load_a_colk(const E* s, int ld, int m0, int k0, int g, int t) {
  const E* p = s + (k0 + 2 * t) * ld + m0 + g;
  return split_a(p[0], p[8], p[ld], p[ld + 8]);
}

// B, k along a row: the tile holds B transposed, [n][k]; row n0+g, columns k0+t, k0+t+4.
template <typename E>
__device__ __forceinline__ FragB load_b_rowk(const E* s, int ld, int n0, int k0, int g, int t) {
  const E* p = s + (n0 + g) * ld + k0 + t;
  return split_b(p[0], p[4]);
}

// B, k down a column: the tile holds B as [k][n]; rows k0+2t, k0+2t+1
// (logical k = t, t+4), column n0+g. Pairs with load_a_colk and acc_as_a.
template <typename E>
__device__ __forceinline__ FragB load_b_colk(const E* s, int ld, int k0, int n0, int g, int t) {
  const E* p = s + (k0 + 2 * t) * ld + n0 + g;
  return split_b(p[0], p[ld]);
}

// An accumulator tile c (16 x 8) as the A operand of the next product, its 8
// columns the k-step (logical k = t is column 2t, k = t+4 column 2t+1).
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

// 16-byte asynchronous copy global -> shared; with `full` false the 16 bytes
// are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 16 : 0)
               : "memory");
}

// 4-byte asynchronous copy, zero-filled when `full` is false.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage `rows` rows of D elements (f32 or bf16) into a shared tile of stride
// D + kPadOf<E>: row r comes from src + r * src_stride for r < valid and is
// zero-filled past it (`safe` is any readable address, handed to the copies
// that read nothing).
template <int D, typename E>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, long src_stride, int rows,
                                           int valid, const E* safe, int tid, int nthreads) {
  constexpr int kPer = 16 / (int)sizeof(E);  // elements a 16-byte copy moves
  constexpr int kChunks = D / kPer;
  for (int i = tid; i < rows * kChunks; i += nthreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const bool ok = r < valid;
    cp_async16(dst + r * (D + kPadOf<E>) + c, ok ? src + r * src_stride + c : safe, ok);
  }
}

// A value into an output of type T (f32, or bf16 rounded to nearest even),
// and two neighbouring ones (8 or 4 bytes, aligned).
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

}  // namespace msfa_tc
