// Cross-block reductions of the feed-forward backward (ffw.cu, the
// fused_mlp route).
//
// The TPU backward kernel carries its weight-gradient sums (dW1, dW2, db1) in
// VMEM output blocks across a grid that runs in order on one core. Blocks on
// Hopper run in parallel and in no order, so the port takes those sums in a
// second pass, deterministically and without atomics:
//
//   atb_partial_kernel   C_s = A[rows of split s]^T . B[rows of split s]
//                        (a weight gradient such as dW2 = hd^T dout), one
//                        [I, O] partial per split of the N rows;
//   colsum_partial_kernel one [O] partial column sum per split of the rows
//                        (db1 = sum over rows of dpre);
//   reduce_splits_kernel out[e] = sum_s part[s][e], the splits in order.
//
// What bounds them: atb is a product of 2*N*I*O operations on operands that
// stream once from device memory (N*(I+O) floats); at the training shapes
// (N = 16384, I x O = 256 x 2048) that is 17.2 GFLOP against 151 MB, so
// operations. Each block owns a 64 x 64 output tile in registers (4 x 4 per
// thread) and streams 16-row slices of A and B through shared memory; the
// row splits put 4 to 16 blocks on each output tile so that the grid fills
// the 132 SMs. f32 on the CUDA cores, as the rest of ffw.cu; the
// residual-LayerNorm kernels take their sums on the tensor cores
// (residual_ln.cuh).

#pragma once

#include <cuda_runtime.h>

namespace msfa {

constexpr int kAtbTile = 64;
constexpr int kAtbRows = 16;

__global__ void __launch_bounds__(256)
atb_partial_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ part, int N, int I, int O,
                   int rows_per_split) {
  __shared__ float As[kAtbRows][kAtbTile];
  __shared__ float Bs[kAtbRows][kAtbTile];
  const int i0 = blockIdx.x * kAtbTile;
  const int o0 = blockIdx.y * kAtbTile;
  const int split = blockIdx.z;
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output columns tx + 16 * j
  const int ty = tid >> 4;  // output rows ty * 4 + i

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = n_begin; n0 < n_end; n0 += kAtbRows) {
    __syncthreads();
    for (int e = tid; e < kAtbRows * kAtbTile; e += 256) {
      const int r = e / kAtbTile, c = e % kAtbTile, n = n0 + r;
      As[r][c] = (n < n_end && i0 + c < I) ? A[(long)n * I + i0 + c] : 0.f;
      Bs[r][c] = (n < n_end && o0 + c < O) ? B[(long)n * O + o0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kAtbRows; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[r][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  float* out = part + (long)split * I * O;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty * 4 + i;
    if (row >= I) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = o0 + tx + 16 * j;
      if (col < O) out[(long)row * O + col] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(256)
colsum_partial_kernel(const float* __restrict__ B, float* __restrict__ part,
                      int N, int O, int rows_per_split) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int split = blockIdx.y;
  if (col >= O) return;
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  float s = 0.f;
  for (int n = n_begin; n < n_end; ++n) s += B[(long)n * O + col];
  part[(long)split * O + col] = s;
}

__global__ void __launch_bounds__(256)
reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out,
                     int splits, long width) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= width) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(long)k * width + e];
  out[e] = s;
}

// out[I, O] = A^T B over all N rows: partials per row split, then their sum.
// part holds splits * I * O floats (the wrapper allocates it).
inline cudaError_t atb(const float* A, const float* B, float* out, float* part,
                       int N, int I, int O, int splits, cudaStream_t stream) {
  const int rows_per_split = (N + splits - 1) / splits;
  const dim3 grid((I + kAtbTile - 1) / kAtbTile, (O + kAtbTile - 1) / kAtbTile, splits);
  atb_partial_kernel<<<grid, 256, 0, stream>>>(A, B, part, N, I, O, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long width = (long)I * O;
  reduce_splits_kernel<<<(unsigned)((width + 255) / 256), 256, 0, stream>>>(part, out, splits, width);
  return cudaGetLastError();
}

// out[O] = sum over the N rows of B[N, O]; part holds splits * O floats.
inline cudaError_t colsum(const float* B, float* out, float* part, int N, int O,
                          int splits, cudaStream_t stream) {
  const int rows_per_split = (N + splits - 1) / splits;
  const dim3 grid((O + 255) / 256, splits);
  colsum_partial_kernel<<<grid, 256, 0, stream>>>(B, part, N, O, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_splits_kernel<<<(O + 255) / 256, 256, 0, stream>>>(part, out, splits, O);
  return cudaGetLastError();
}

}  // namespace msfa
