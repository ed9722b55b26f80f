// The deterministic fixed-point scatter of bilinear texture cotangents,
// shared by the texture sampler's backward (tex_bwd.cu) and the shading
// backward (shade_bwd.cu).  tex_bwd.cu's source note gives the design:
// terms g w scaled by 2^k into int64 (k from the largest finite |g| and
// the number of rays, `fixed_exponent`), the lanes of a warp grouped by
// their texel cell with __match_any_sync and one leader lane a group
// adding the group's sums with atomics, non-finite terms as flags, and
// `tex_bwd_finish` turning the sums and flags into float32.  Integer adds
// give the same bits in any order, so two runs are bitwise equal.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kScatterThreads = 256;

// 2^k scales terms of magnitude <= max_abs, n of them to a texel, into
// int64 with room: n max_abs 2^k < 2^62.  0 when max_abs is 0.
__device__ __forceinline__ int fixed_exponent(float max_abs, int n) {
  if (!(max_abs > 0.0f)) return 0;
  int e;
  frexpf(max_abs, &e);           // max_abs < 2^e
  const int b = 32 - __clz(n);   // n < 2^b
  return 62 - b - e;
}

// The flag of a non-finite term: 1 NaN, 2 +inf, 4 -inf.
__device__ __forceinline__ unsigned nonfinite_flag(float v) {
  return isnan(v) ? 1u : (v > 0.0f ? 2u : 4u);
}

// One warp's scatter: lane adds gval(c) wgt[k] to channel c of texel t[k]
// (k = 0..3, c = 0..nc-1) of `acc` (texel-major, nc channels) at the
// fixed-point `scale`.  `key` groups the lanes whose four texels are the
// same (dead lanes pass ~0 and `live` false); `part` is this warp's
// [4][32] shared scratch.  Every lane of the warp calls it.
template <typename G>
__device__ __forceinline__ void scatter_quads(
    bool live, const long long t[4], unsigned long long key,
    const float wgt[4], int nc, G&& gval, double scale,
    unsigned long long* __restrict__ acc, unsigned* __restrict__ flags,
    long long (*part)[32]) {
  const int lane = threadIdx.x & 31;
  const unsigned group = __match_any_sync(0xffffffffu, key);
  const bool leader = live && lane == __ffs(group) - 1;
  for (int c = 0; c < nc; ++c) {
    const float gc = live ? gval(c) : 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = __fmul_rn(gc, wgt[k]);
      long long q = 0;
      if (isfinite(v)) {
        q = __double2ll_rn(static_cast<double>(v) * scale);
      } else {
        const long long o = t[k] * nc + c;
        atomicOr(&flags[o >> 3], nonfinite_flag(v) << (4 * (o & 7)));
      }
      part[k][lane] = q;
    }
    __syncwarp();
    if (leader) {
      long long s[4] = {0, 0, 0, 0};
      for (unsigned m = group; m != 0; m &= m - 1) {
        const int j = __ffs(m) - 1;
#pragma unroll
        for (int k = 0; k < 4; ++k) s[k] += part[k][j];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (s[k] != 0) {
          atomicAdd(&acc[t[k] * nc + c],
                    static_cast<unsigned long long>(s[k]));
        }
      }
    }
    __syncwarp();
  }
}

__global__ void tex_bwd_finish(const long long* __restrict__ acc,
                               const unsigned* __restrict__ flags,
                               const unsigned* __restrict__ stat, int n,
                               long long total, float* __restrict__ dtex) {
  const double inv =
      scalbn(1.0, -fixed_exponent(__uint_as_float(*stat), n));
  for (long long i = static_cast<long long>(blockIdx.x) * kScatterThreads +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kScatterThreads) {
    const unsigned f = (flags[i >> 3] >> (4 * (i & 7))) & 7u;
    float v = __double2float_rn(__ll2double_rn(acc[i]) * inv);
    if (f != 0) {
      v = (f & 1u) || (f & 6u) == 6u ? __int_as_float(0x7fffffff)
          : (f & 2u)                 ? __int_as_float(0x7f800000)
                                     : __int_as_float(0xff800000);
    }
    dtex[i] = v;
  }
}

// Blocks of a grid-stride pass over `total` entries: 8 blocks an SM.
inline int grid_stride_blocks(long long total) {
  constexpr long long kMaxBlocks = 132 * 8;
  const long long blocks = (total + kScatterThreads - 1) / kScatterThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace
