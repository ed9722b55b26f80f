// Deterministic sums of per-ray scalar cotangents over the grid, shared by
// the adjoints (rk4_bwd.cu, dopri_bwd.cu).  The TPU revisits one output
// block in grid order; CUDA blocks run in no order, so each block sums its
// threads' terms in shared memory in a fixed tree into its own row of a
// (n_blocks, ncol) buffer, and `sum_blocks` adds the rows in a fixed order.
// No atomics: the sums are the same bit for bit from run to run.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSumThreads = 128;   // the adjoints' block size

// One block's fixed-tree sum of v over its threads; thread 0 returns it.
__device__ __forceinline__ float block_sum(float* red, float v) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int half = kSumThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// One block: column q of out = sum over b of partial[b, q], each thread
// summing a fixed stride of rows in order, then a fixed tree over the
// threads.  The first NGRAD columns are scalar cotangents: columns
// 0..NGRAD-2 go to gscal[0..NGRAD-2] and column NGRAD-1 to gscal[9] (the
// spin, a); the rest go to the (K, 4) gsph.  The other NSCAL entries get
// zero: they enter the step only through comparisons.
template <int NGRAD>
__global__ void __launch_bounds__(kSumThreads)
    sum_blocks(const float* __restrict__ partial, int n_blocks, int ncol,
               float* __restrict__ gscal, float* __restrict__ gsph) {
  constexpr int kLast = 9;   // the spin's entry of the NSCAL = 10 vector
  __shared__ float red[kSumThreads];
  for (int q = 0; q < ncol; ++q) {
    float acc = 0.0f;
    for (int b = threadIdx.x; b < n_blocks; b += kSumThreads) {
      acc += partial[static_cast<long long>(b) * ncol + q];
    }
    const float v = block_sum(red, acc);
    if (threadIdx.x == 0) {
      if (q < NGRAD) {
        gscal[q < NGRAD - 1 ? q : kLast] = v;
      } else {
        gsph[q - NGRAD] = v;
      }
    }
  }
  if (threadIdx.x >= NGRAD - 1 && threadIdx.x < kLast) gscal[threadIdx.x] = 0.0f;
}

}  // namespace
