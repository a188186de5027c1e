// Row-tile building blocks of the feed-forward kernels (ffw.cu).
//
// One block of 256 threads owns 32 whole rows of x [N, D] in shared memory
// and walks d_ff in 64-wide chunks; the weights W1 [D, F] and W2 [F, D]
// (both stored [in, out]) stream through one shared buffer in 32-deep
// slices. Warp w owns rows 4w .. 4w+3; lane l owns hidden columns l, l+32 of
// a chunk and output columns l + 32 j. The four products of a chunk:
//
//   chunk_pre  pre  = x W1[:, chunk]              (forward, and recomputed)
//   chunk_out  acc += h W2[chunk, :]              (forward)
//   chunk_dhd  dhd  = dy W2[chunk, :]^T           (backward)
//   chunk_dx   dx  += dpre W1[:, chunk]^T         (backward)
//
// f32 on the CUDA cores, every sum in a fixed order: the forward and the
// backward's recomputation give the same bits for the same inputs.

#pragma once

#include <cuda_runtime.h>

namespace msfa {
namespace ffw {

constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr int kK = 32;   // depth of one streamed weight slice
constexpr int kFC = 64;  // d_ff chunk

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int D>
__host__ __device__ constexpr int wbuf_floats() {
  // W1 slice [kK][kFC], W2 slice [kK][D], W2^T slice [kFC][kK+1], W1^T slice [D][kK+1]
  return cmax(cmax(kK * kFC, kK * D), cmax(kFC * (kK + 1), D * (kK + 1)));
}

template <int D>
constexpr int fwd_smem_floats() {
  return kRows * D + wbuf_floats<D>() + kRows * (kFC + 1);
}

template <int D>
constexpr int bwd_smem_floats() {
  // Xs, Wb, Hs, DYs
  return kRows * D + wbuf_floats<D>() + kRows * (kFC + 1) + kRows * (D + 1);
}

// pre[i][jj] = (x W1)[row warp*4+i][c0 + lane + 32 jj] for one 64-wide chunk.
template <int D>
__device__ __forceinline__ void chunk_pre(const float* Xs, const float* __restrict__ w1,
                                          int F, int c0, float* Wb, float (&pre)[4][2]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) pre[i][0] = pre[i][1] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kK) {
    __syncthreads();
    for (int e = tid; e < kK * kFC; e += kThreads) {
      const int kk = e / kFC, f = e % kFC;
      Wb[e] = w1[(long)(k0 + kk) * F + c0 + f];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      const float w0 = Wb[kk * kFC + lane], w1v = Wb[kk * kFC + lane + 32];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = Xs[(warp * 4 + i) * D + k0 + kk];
        pre[i][0] = fmaf(xv, w0, pre[i][0]);
        pre[i][1] = fmaf(xv, w1v, pre[i][1]);
      }
    }
  }
}

// acc[i][j] += Hs[row warp*4+i][:] W2[c0 .. c0+64][lane + 32 j]
template <int D>
__device__ __forceinline__ void chunk_out(const float* Hs, const float* __restrict__ w2,
                                          int c0, float* Wb, float (&acc)[4][D / 32]) {
  constexpr int DJ = D / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int kk0 = 0; kk0 < kFC; kk0 += kK) {
    __syncthreads();
    for (int e = tid; e < kK * D; e += kThreads) Wb[e] = w2[(long)(c0 + kk0) * D + e];
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      float wv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) wv[j] = Wb[kk * D + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hv = Hs[(warp * 4 + i) * (kFC + 1) + kk0 + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(hv, wv[j], acc[i][j]);
      }
    }
  }
}

// dhd[i][jj] = (dy W2^T)[row warp*4+i][c0 + lane + 32 jj]; DYs holds the
// block's dy rows with a row stride of D + 1.
template <int D>
__device__ __forceinline__ void chunk_dhd(const float* DYs, const float* __restrict__ w2,
                                          int c0, float* Wb, float (&dhd)[4][2]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) dhd[i][0] = dhd[i][1] = 0.f;
  for (int o0 = 0; o0 < D; o0 += kK) {
    __syncthreads();
    for (int e = tid; e < kFC * kK; e += kThreads) {
      const int f = e / kK, oo = e % kK;
      Wb[f * (kK + 1) + oo] = w2[(long)(c0 + f) * D + o0 + oo];
    }
    __syncthreads();
#pragma unroll 8
    for (int oo = 0; oo < kK; ++oo) {
      const float w0 = Wb[lane * (kK + 1) + oo], w1v = Wb[(lane + 32) * (kK + 1) + oo];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dyv = DYs[(warp * 4 + i) * (D + 1) + o0 + oo];
        dhd[i][0] = fmaf(dyv, w0, dhd[i][0]);
        dhd[i][1] = fmaf(dyv, w1v, dhd[i][1]);
      }
    }
  }
}

// dxa[i][j] += Hs[row warp*4+i][:] W1[lane + 32 j][c0 .. c0+64]^T, Hs = dpre of the chunk
template <int D>
__device__ __forceinline__ void chunk_dx(const float* Hs, const float* __restrict__ w1,
                                         int F, int c0, float* Wb, float (&dxa)[4][D / 32]) {
  constexpr int DJ = D / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int f0 = 0; f0 < kFC; f0 += kK) {
    __syncthreads();
    for (int e = tid; e < D * kK; e += kThreads) {
      const int ii = e / kK, ff = e % kK;
      Wb[ii * (kK + 1) + ff] = w1[(long)ii * F + c0 + f0 + ff];
    }
    __syncthreads();
#pragma unroll 8
    for (int ff = 0; ff < kK; ++ff) {
      float wv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) wv[j] = Wb[(lane + 32 * j) * (kK + 1) + ff];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dpv = Hs[(warp * 4 + i) * (kFC + 1) + f0 + ff];
#pragma unroll
        for (int j = 0; j < DJ; ++j) dxa[i][j] = fmaf(dpv, wv[j], dxa[i][j]);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void load_rows(const float* __restrict__ x, int row0, int N, float* Xs) {
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int n = row0 + e / D;
    Xs[e] = n < N ? x[(long)row0 * D + e] : 0.f;
  }
}

// Forward of one row tile through acc = hd W2 (before bias and residual);
// optionally keeps pre and hd in scratch for a backward.
template <int D, bool kKeep>
__device__ __forceinline__ void ffw_tile(const float* Xs, const float* __restrict__ w1,
                                         const float* __restrict__ b1,
                                         const float* __restrict__ w2,
                                         const unsigned char* __restrict__ fmask,
                                         float* __restrict__ pre_out, float* __restrict__ hd_out,
                                         int row0, int N, int F, float inv_keep, float* Wb,
                                         float* Hs, float (&acc)[4][D / 32]) {
  constexpr int DJ = D / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < F; c0 += kFC) {
    float pre[4][2];
    chunk_pre<D>(Xs, w1, F, c0, Wb, pre);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = row0 + warp * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int f = lane + 32 * jj;
        const float p = pre[i][jj] + b1[c0 + f];
        float h = fmaxf(p, 0.f);
        if (fmask) h *= (n < N ? (float)fmask[(long)n * F + c0 + f] : 0.f) * inv_keep;
        if (kKeep && n < N) {
          pre_out[(long)n * F + c0 + f] = p;
          hd_out[(long)n * F + c0 + f] = h;
        }
        Hs[(warp * 4 + i) * (kFC + 1) + f] = h;
      }
    }
    chunk_out<D>(Hs, w2, c0, Wb, acc);
  }
}

}  // namespace ffw
}  // namespace msfa
