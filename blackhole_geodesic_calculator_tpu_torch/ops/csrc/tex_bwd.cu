// Backward of the texture sampler's bilinear lookup (scene/texture.py
// `_SampleBpy`), for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package's backward of `sample_bpy` is
// XLA's quad scatter (JAX scene/texture.py:144-203, `_sample_bpy_bwd`); the
// port's plain path (texture.py `sample_bpy_bwd_plain`) is four accumulating
// `index_put_` into (H, W, C), each of which sorts its N int64 indices and
// then adds up every run of equal indices one element after another.  In
// the 1024^2 x 5-spp orbit fit the sky's 5.24M rays fall in 144k texel
// cells, 36 a cell on average and 50,796 in the busiest (a pole row), so
// the longest runs are long, and the plain backward took 31-48 ms a step
// on an H100 (PERF.md).
//
// Bound: bytes.  One thread per ray reads, once, what the forward saved --
// the four corner colours (4 C floats), tx, ty -- and the cotangent g (C
// floats), and writes dx and dy: 76 B a ray for C = 3.  With the texture
// cotangent it also reads the four int64 corner indices (32 B) and the
// call writes the (H, W, C) float32 `dtex`.  For the orbit fit's six calls
// a step (the learned sky, the frozen disk and four moons) at 5.24M rays
// that is about 2.6 GB, 0.8 ms at 3.35 TB/s.
//
// What the design does about it:
// * The coordinate cotangents are one pass with no reduction across rays:
//   dx = 0.5 w sum_c g ((c01 - c00)(1 - ty) + (c11 - c10) ty) and
//   dy = -0.5 h sum_c g ((c10 - c00)(1 - tx) + (c11 - c01) tx), each
//   operation rounded as the plain path's tensor operations round them
//   (no fused multiply-adds), the channels added in order.
// * The texture cotangent is a scatter-add of 4 C terms a ray into (H, W,
//   C).  Rays arrive in pixel order, so a warp's 32 rays fall in a few
//   texel cells.  The lanes are grouped by their cell's key (yi0, yi1,
//   xi0, which fix all four corners) with __match_any_sync; each group's
//   terms are added up in shared memory and one leader lane a group adds
//   them to the four corners with atomics: in the orbit fit 3 lanes a
//   group, 1.3 atomics a ray and channel instead of 4, which takes much
//   of the contention on the busiest texels' L2 addresses off them.
// * The sums are repeatable: fixed point in int64.  `tex_bwd_absmax` takes
//   m = max |g| over the finite entries (a max is the same in any order).
//   With m < 2^e and N < 2^b, every term is scaled by 2^k, k = 62 - b - e
//   (`fixed_exponent`; cuda_kernel.tex_bwd_exponent is its host mirror),
//   and rounded to an integer: a texel's sum is at most N m 2^k < 2^62 in
//   magnitude, so it cannot overflow, and integer adds give the same bits
//   in any order, so two runs are bitwise equal.  The quantum, N m 2^-62,
//   is about 1e-12 m at N = 5.2M: finer than float32's rounding of the
//   same sums except in texels whose sum is below about 1e-5 m times
//   their count of terms, where the error is absolute, at most half a
//   quantum a term.  `tex_bwd_finish` converts the int64 sums to float32
//   dtex.
// * A non-finite term (g infinite or NaN) is not summed: it sets a NaN,
//   +inf or -inf flag of its texel and channel (4 bits each, atomicOr),
//   and the texel comes out NaN, +inf or -inf as the plain path's float
//   sum would.  If m is 0 every finite term is 0 and dtex is zeros.
// * The int64 sums, the flags and m live in one transient scratch buffer
//   that the wrapper zeroes: 8.5 bytes a texel and channel, over twice the
//   float32 dtex (13.4 MB for a 512 x 1024 sky, which fits the 50 MB L2;
//   3.4 GB for an 8k x 16k equirect), freed when the backward returns.
//
// Plain C interface (loaded with ctypes): `bhgc_tex_bwd` launches the
// kernels on the given stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>

#include "tex_scatter.cuh"

namespace {

constexpr int kThreads = kScatterThreads;
constexpr int kWarps = kThreads / 32;

__global__ void tex_bwd_absmax(const float* __restrict__ g, long long total,
                               unsigned* __restrict__ stat) {
  unsigned m = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * kThreads) {
    const float a = fabsf(g[i]);
    // finite |g| only; a nonnegative float orders as its bits do
    if (a <= 3.402823466e38f) m = max(m, __float_as_uint(a));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(stat, m);
}

template <bool DTEX>
__global__ void tex_bwd_kernel(
    const float* __restrict__ c00, const float* __restrict__ c01,
    const float* __restrict__ c10, const float* __restrict__ c11,
    const float* __restrict__ tx_in, const float* __restrict__ ty_in,
    const long long* __restrict__ xi0, const long long* __restrict__ xi1,
    const long long* __restrict__ yi0, const long long* __restrict__ yi1,
    const float* __restrict__ g, int n, int nc, int w, float sx, float sy,
    float* __restrict__ dx, float* __restrict__ dy,
    unsigned long long* __restrict__ acc, unsigned* __restrict__ flags,
    const unsigned* __restrict__ stat) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  float tx = 0.0f, ty = 0.0f;
  if (live) {
    tx = tx_in[i];
    ty = ty_in[i];
  }
  const float ax = __fsub_rn(1.0f, tx), ay = __fsub_rn(1.0f, ty);
  const long long row = static_cast<long long>(i) * nc;
  if (live) {
    float fx = 0.0f, fy = 0.0f;
    for (int c = 0; c < nc; ++c) {
      const float v00 = c00[row + c], v01 = c01[row + c];
      const float v10 = c10[row + c], v11 = c11[row + c];
      const float gc = g[row + c];
      const float tdx = __fmul_rn(
          gc, __fadd_rn(__fmul_rn(__fsub_rn(v01, v00), ay),
                        __fmul_rn(__fsub_rn(v11, v10), ty)));
      const float tdy = __fmul_rn(
          gc, __fadd_rn(__fmul_rn(__fsub_rn(v10, v00), ax),
                        __fmul_rn(__fsub_rn(v11, v01), tx)));
      fx = __fadd_rn(fx, tdx);
      fy = __fadd_rn(fy, tdy);
    }
    dx[i] = __fmul_rn(fx, sx);
    dy[i] = __fmul_rn(fy, sy);
  }
  if constexpr (DTEX) {
    __shared__ long long part[kWarps][4][32];
    long long t[4] = {0, 0, 0, 0};   // texel of each corner
    unsigned long long key = ~0ull;  // dead lanes group among themselves
    if (live) {
      const long long y0 = yi0[i], y1 = yi1[i], x0 = xi0[i], x1 = xi1[i];
      t[0] = y0 * w + x0;
      t[1] = y0 * w + x1;
      t[2] = y1 * w + x0;
      t[3] = y1 * w + x1;
      // xi1 follows from xi0 and yi1 - yi0 is 0 or 1
      key = static_cast<unsigned long long>(t[0]) << 1 |
            static_cast<unsigned long long>(y1 - y0);
    }
    // the plain path's weights, in its order: (1-tx)(1-ty), tx(1-ty),
    // (1-tx)ty, tx ty
    const float wgt[4] = {__fmul_rn(ax, ay), __fmul_rn(tx, ay),
                          __fmul_rn(ax, ty), __fmul_rn(tx, ty)};
    const double scale =
        scalbn(1.0, fixed_exponent(__uint_as_float(*stat), n));
    scatter_quads(live, t, key, wgt, nc,
                  [&](int c) { return g[row + c]; }, scale, acc, flags,
                  part[threadIdx.x >> 5]);
  }
}

}  // namespace

// dx, dy (n,) of the n rays; with `dtex` not null also the texture's
// (H, W, C) cotangent, through `scratch`: total + ceil(total / 16) + 1
// int64 words, zeroed, for total = H W C -- the sums, the flags (4 bits
// an entry), m (cuda_kernel.tex_bwd sizes it).  sx = 0.5 w, sy = -0.5 h.
extern "C" int bhgc_tex_bwd(const void* c00, const void* c01,
                            const void* c10, const void* c11, const void* tx,
                            const void* ty, const void* xi0, const void* xi1,
                            const void* yi0, const void* yi1, const void* g,
                            int n, int nc, int h, int w, float sx, float sy,
                            void* dx, void* dy, void* scratch, void* dtex,
                            void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
  const auto* gf = static_cast<const float*>(g);
  if (dtex == nullptr) {
    tex_bwd_kernel<false><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(c00), static_cast<const float*>(c01),
        static_cast<const float*>(c10), static_cast<const float*>(c11),
        static_cast<const float*>(tx), static_cast<const float*>(ty),
        nullptr, nullptr, nullptr, nullptr, gf, n, nc, w, sx, sy,
        static_cast<float*>(dx), static_cast<float*>(dy), nullptr, nullptr,
        nullptr);
    return static_cast<int>(cudaGetLastError());
  }
  const long long total = static_cast<long long>(h) * w * nc;
  auto* acc = static_cast<unsigned long long*>(scratch);
  auto* flags = reinterpret_cast<unsigned*>(acc + total);
  auto* stat = reinterpret_cast<unsigned*>(acc + total + (total + 15) / 16);
  tex_bwd_absmax<<<grid_stride_blocks(static_cast<long long>(n) * nc),
                   kThreads, 0, s>>>(gf, static_cast<long long>(n) * nc,
                                     stat);
  tex_bwd_kernel<true><<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(c00), static_cast<const float*>(c01),
      static_cast<const float*>(c10), static_cast<const float*>(c11),
      static_cast<const float*>(tx), static_cast<const float*>(ty),
      static_cast<const long long*>(xi0), static_cast<const long long*>(xi1),
      static_cast<const long long*>(yi0), static_cast<const long long*>(yi1),
      gf, n, nc, w, sx, sy, static_cast<float*>(dx), static_cast<float*>(dy),
      acc, flags, stat);
  tex_bwd_finish<<<grid_stride_blocks(total), kThreads, 0, s>>>(
      reinterpret_cast<const long long*>(acc), flags, stat, n, total,
      static_cast<float*>(dtex));
  return static_cast<int>(cudaGetLastError());
}
