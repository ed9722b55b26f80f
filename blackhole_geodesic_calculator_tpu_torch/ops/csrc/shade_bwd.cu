// The shading backward, for Hopper (sm_90a): the VJP of shade.cu for the
// colour cotangent, each ray by its own branch, recomputed from the
// forward's inputs.
//
// Replaces no Pallas kernel.  The plain path's backward is autograd's
// replay of the dense shading (scene/shading.py), node by node: in the
// 1024^2 x 5-spp orbit fit 368 operations, 9.4 ms a step on an H100, over
// the saved corner colours, weights and int64 indices of six texture
// lookups, about 0.46 GB each (PERF.md).
//
// Bound: bytes.  A ray reads its state and cotangent (48 B) and writes
// the cotangents of x, p and E (28 B): 0.40 GB, 0.12 ms at 3.35 TB/s for
// 5.24M rays; a texture that needs its cotangent adds 24 B a ray of
// records and the scatter.
//
// What the design does about it:
// * `shade_bwd_kernel`, one thread a ray, recomputes the ray's branch with
//   shade.cuh's forward code (the same roundings, so the same texel) and
//   applies its VJP: the sky's through the equirect coordinates, the
//   normalisation and rk4_step.cuh's rhs_vjp (dx/dlambda's cotangent only);
//   the disk's through its profile, lookup and redshift; the sphere's
//   through its lookup, normal and Lambert lights.  It writes the per-ray
//   cotangents of x, p and E.
// * The scene's cotangents -- the kNSh scalars, the (K, 8) sphere table,
//   the (L, 3) lights -- are per-ray terms summed over the grid without
//   atomics: each warp sums a column by a fixed shuffle tree, each block
//   its warps in order into its own entry of a (columns, blocks) buffer,
//   and `shade_bwd_sums` adds a column's entries in a fixed order (one
//   block a column, coalesced), so they are the same bit for bit from run
//   to run.  A ray adds to its own sphere's row only; a light's column
//   recomputes the ray's Lambert term of that light.
// * Where a texture needs its cotangent, the kernel writes the ray's
//   record -- which texture (the sky, the disk, sphere k), the lookup's
//   coordinates and its colour cotangent -- and the largest finite |term|
//   (atomicMax on the float's bits: a max is the same in any order);
//   `shade_tex_scatter` then scatters the records' bilinear terms with
//   tex_scatter.cuh's fixed-point warp-aggregated adds into one int64
//   buffer over every texture that needs it, and `tex_bwd_finish` turns it
//   into float32: bitwise repeatable, as tex_bwd.cu.
//
// Plain C interface (loaded with ctypes): `bhgc_shade_bwd` launches the
// kernel and the column sums, `bhgc_shade_tex` the texture scatter and its
// finish, each on the given stream, returning cudaGetLastError() as an
// int.

#include "shade.cuh"
#include "tex_scatter.cuh"

namespace {

constexpr int kChunk = kShadeThreads;   // columns a block sums at a time

// Which textures need their cotangent (a record) and where each texture's
// texels start in the scatter's buffer: the sky, the disk, the spheres'
// stack (sphere k at off[2] + k h w).
struct TexSlots {
  long long off[3];
  int h[3], w[3];
  int need[3];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

// The block's column sums, pushed one column at a time by every thread in
// the same order: a fixed shuffle tree a warp, then the warps in order, into
// entry (column, block) of `partial`.
struct ColumnSums {
  float (*red)[kChunk];
  float* partial;
  int used = 0, base = 0;

  __device__ void push(float v) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5][used] = v;
    if (++used == kChunk) flush();
  }

  __device__ void flush() {
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < used) {
      float s = 0.0f;
      for (int w = 0; w < kShadeWarps; ++w) s += red[w][threadIdx.x];
      partial[static_cast<long long>(base + threadIdx.x) * gridDim.x +
              blockIdx.x] = s;
    }
    __syncthreads();
    base += used;
    used = 0;
  }
};

template <bool KERR, bool SKY, int DISK, int SPH>
__global__ void __launch_bounds__(kShadeThreads)
    shade_bwd_kernel(ShadeScene sc, TexSlots ts,
                     const float* __restrict__ x_in,
                     const float* __restrict__ p_in,
                     const float* __restrict__ E_in,
                     const int* __restrict__ st_in,
                     const int* __restrict__ obj_in,
                     const float* __restrict__ g_in, float* __restrict__ gx_out,
                     float* __restrict__ gp_out, float* __restrict__ gE_out,
                     float* __restrict__ partial, int* __restrict__ rec_slot,
                     float* __restrict__ rec_uv, float* __restrict__ rec_g,
                     unsigned* __restrict__ stat, int n) {
  __shared__ float red[kShadeWarps][kChunk];
  const int i = blockIdx.x * kShadeThreads + threadIdx.x;
  const bool live = i < n;
  const long long j = 3LL * i;
  const Sc s = load_sc(sc.scal);
  float x[3] = {0.0f, 0.0f, 0.0f}, p[3] = {0.0f, 0.0f, 0.0f}, E = 0.0f;
  float gx[3] = {0.0f, 0.0f, 0.0f}, gp[3] = {0.0f, 0.0f, 0.0f}, gE = 0.0f;
  float gs[kNSh];
#pragma unroll
  for (int q = 0; q < kNSh; ++q) gs[q] = 0.0f;
  float g_row[kSphCols];
#pragma unroll
  for (int q = 0; q < kSphCols; ++q) g_row[q] = 0.0f;
  int k = -1;   // the ray's sphere
  // what a light's columns recompute: the normal, the Lambert base colour
  // and the Lambert colour's cotangent
  float nrm[3] = {0.0f, 0.0f, 0.0f}, base[3] = {0.0f, 0.0f, 0.0f};
  float g_lam[3] = {0.0f, 0.0f, 0.0f};
  int slot = -1;
  float ru = 0.0f, rv = 0.0f, rg[3] = {0.0f, 0.0f, 0.0f};

  const int br = live ? branch<DISK, SPH>(st_in[i]) : kBrBlack;
  if (br == kBrSky || br == kBrDisk || br == kBrSph) {
    const float g[3] = {g_in[j], g_in[j + 1], g_in[j + 2]};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[c] = x_in[j + c];
      p[c] = p_in[j + c];
    }
    E = E_in[i];
    if (br == kBrSph) {
      if constexpr (SPH != kSphNone) {
        const SphRay z = sph_ray<SPH>(sc, s, x, obj_in[i]);
        float g_em[3];
        sph_vjp<SPH>(sc, s, x, z, g, gx, gs, g_row, g_em, g_lam);
        k = z.k;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          nrm[c] = z.nrm[c];
          base[c] = z.base[c];
        }
        if (ts.need[2]) {
          slot = 2 + z.k;
          ru = z.u;
          rv = z.v;
#pragma unroll
          for (int c = 0; c < 3; ++c) rg[c] = g_em[c];
        }
      }
    } else if (br == kBrDisk) {
      if constexpr (DISK != kDiskNone) {
        const DiskRay z = disk_ray<DISK>(s, sc.disk, x, p, E);
        float g_rgb[3];
        disk_vjp<DISK>(s, sc.disk, x, p, E, z, g, gx, gp, gE, gs, g_rgb);
        if (ts.need[1]) {
          slot = 1;
          ru = z.tx;
          rv = z.s;
#pragma unroll
          for (int c = 0; c < 3; ++c) rg[c] = g_rgb[c];
        }
      }
    } else if (SKY) {
      const SkyRay r = sky_ray<KERR>(s, sc.sky, x, p, E);
      float du, dv, gd[3], gv[3];
      sample_vjp(sc.sky.p, sc.sky.h, sc.sky.w, r.q, g, du, dv);
      equirect_vjp(r.d, du, dv, gd);
      unit_vjp(r.v, r.nv, r.nc, gd, gv);
      Scalars scl{};
      scl.mass = s.v[kMass];
      scl.spin = s.v[kSpin];
      const float y[6] = {x[0], x[1], x[2], p[0], p[1], p[2]};
      const float gk[6] = {gv[0], gv[1], gv[2], 0.0f, 0.0f, 0.0f};
      float gab[6];
      rhs_vjp<KERR>(scl, E, y, gk, gab, gE, gs[kMass], gs[kSpin]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        gx[c] = gab[c];
        gp[c] = gab[3 + c];
      }
      if (ts.need[0]) {
        slot = 0;
        ru = r.u;
        rv = r.w;
#pragma unroll
        for (int c = 0; c < 3; ++c) rg[c] = g[c];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gx_out[j + c] = gx[c];
      gp_out[j + c] = gp[c];
    }
    gE_out[i] = gE;
    if (rec_slot != nullptr) {
      rec_slot[i] = slot;
      rec_uv[2LL * i] = ru;
      rec_uv[2LL * i + 1] = rv;
#pragma unroll
      for (int c = 0; c < 3; ++c) rec_g[j + c] = rg[c];
    }
  }
  if (stat != nullptr) {
    // the largest finite |term| of the records; a nonnegative float orders
    // as its bits do
    unsigned m = 0;
    if (slot >= 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float a = fabsf(rg[c]);
        if (a <= 3.402823466e38f) m = max(m, __float_as_uint(a));
      }
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0 && m != 0) atomicMax(stat, m);
  }

  // the scene's cotangents: scalars, sphere rows, light positions
  ColumnSums cols{red, partial};
#pragma unroll
  for (int q = 0; q < kNSh; ++q) cols.push(gs[q]);
  if constexpr (SPH != kSphNone) {
    for (int kk = 0; kk < sc.n_sph; ++kk) {
#pragma unroll
      for (int q = 0; q < kSphCols; ++q) cols.push(kk == k ? g_row[q] : 0.0f);
    }
  }
  if constexpr (SPH == kSphLights) {
    for (int l = 0; l < sc.n_lights; ++l) {
      float g_lv[3] = {0.0f, 0.0f, 0.0f};
      if (k >= 0) {
        const LightRay t = light_ray(sc, s, x, nrm, l);
        float gb[3] = {0.0f, 0.0f, 0.0f}, gn[3] = {0.0f, 0.0f, 0.0f};
        float gli = 0.0f;
        light_vjp(s, t, nrm, base, g_lam, gb, gli, gn, g_lv);
      }
      cols.push(g_lv[0]);
      cols.push(g_lv[1]);
      cols.push(g_lv[2]);
    }
  }
  if (cols.used > 0) cols.flush();
}

// out[q] = the sum of column q of the (ncol, n_blocks) buffer, one block a
// column: each thread a fixed stride of entries in order, then a fixed
// tree over the threads.
__global__ void __launch_bounds__(kShadeThreads)
    shade_bwd_sums(const float* __restrict__ partial, int n_blocks,
                   float* __restrict__ out) {
  __shared__ float red[kShadeThreads];
  const float* col = partial + static_cast<long long>(blockIdx.x) * n_blocks;
  float acc = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += kShadeThreads) acc += col[b];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kShadeThreads / 2; half > 0; half >>= 1) {
    if (static_cast<int>(threadIdx.x) < half) {
      red[threadIdx.x] += red[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

// The records' bilinear terms into `acc` (texel-major, 3 channels) at the
// fixed-point scale of `stat`'s largest |term| and the n rays.
__global__ void __launch_bounds__(kScatterThreads)
    shade_tex_scatter(const int* __restrict__ rec_slot,
                      const float* __restrict__ rec_uv,
                      const float* __restrict__ rec_g, int n, TexSlots ts,
                      unsigned long long* __restrict__ acc,
                      unsigned* __restrict__ flags,
                      const unsigned* __restrict__ stat) {
  __shared__ long long part[kScatterThreads / 32][4][32];
  const int i = blockIdx.x * kScatterThreads + threadIdx.x;
  const int slot = i < n ? rec_slot[i] : -1;
  const bool live = slot >= 0;
  long long t[4] = {0, 0, 0, 0};
  unsigned long long key = ~0ull;   // dead lanes group among themselves
  float wgt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    const int which = min(slot, 2);
    const int h = ts.h[which], w = ts.w[which];
    const long long off =
        ts.off[which] + (which == 2 ? static_cast<long long>(slot - 2) * h * w
                                    : 0LL);
    const Quad q = make_quad(h, w, rec_uv[2LL * i], rec_uv[2LL * i + 1]);
#pragma unroll
    for (int c = 0; c < 4; ++c) t[c] = off + q.t[c];
    // a texture's xi1 follows from xi0 and yi1 - yi0 is 0 or 1
    key = static_cast<unsigned long long>(t[0]) << 1 |
          static_cast<unsigned long long>(q.dy);
    const float ax = __fsub_rn(1.0f, q.tx), ay = __fsub_rn(1.0f, q.ty);
    wgt[0] = __fmul_rn(ax, ay);
    wgt[1] = __fmul_rn(q.tx, ay);
    wgt[2] = __fmul_rn(ax, q.ty);
    wgt[3] = __fmul_rn(q.tx, q.ty);
  }
  const double scale =
      scalbn(1.0, fixed_exponent(__uint_as_float(*stat), n));
  scatter_quads(live, t, key, wgt, 3,
                [&](int c) { return rec_g[3LL * i + c]; }, scale, acc, flags,
                part[threadIdx.x >> 5]);
}

}  // namespace

// Blocks of bhgc_shade_bwd's kernel: the wrapper allocates `partial` of
// (columns, bhgc_shade_bwd_blocks(n)) floats.
extern "C" int bhgc_shade_bwd_blocks(int n) {
  return (n + kShadeThreads - 1) / kShadeThreads;
}

// The cotangents gx, gp (n, 3) and gE (n,) of the n rays and, in `cols`,
// the ncol = kNSh + 8 K + 3 L column sums (the scalars, the sphere rows
// with spheres, the light positions with spheres and lights) for the
// colour cotangent g (n, 3).  The scene's arguments as bhgc_shade_fwd's;
// need_sky, need_disk, need_moon (the spheres' textures) ask for the
// records: rec_slot (n,), rec_uv (n, 2), rec_g (n, 3) and the largest
// |term| at `stat` (zeroed by the caller), all null when no texture needs
// its cotangent.
extern "C" int bhgc_shade_bwd(const void* scal, const void* sph, int n_sph,
                              const void* lights, int n_lights,
                              const void* sky, int sky_h, int sky_w,
                              const void* disk_tex, int disk_h, int disk_w,
                              const void* moon, int moon_h, int moon_w,
                              int kerr, int disk, int sph_mode,
                              int need_sky, int need_disk, int need_moon,
                              const void* x,
                              const void* p, const void* E, const void* st,
                              const void* obj, const void* g, void* gx,
                              void* gp, void* gE, void* partial, int ncol,
                              void* cols, void* rec_slot, void* rec_uv,
                              void* rec_g, void* stat, int n, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const ShadeScene sc{static_cast<const float*>(scal),
                      static_cast<const float*>(sph),
                      static_cast<const float*>(lights),
                      n_sph,
                      n_lights,
                      {static_cast<const float*>(sky), sky_h, sky_w},
                      {static_cast<const float*>(disk_tex), disk_h, disk_w},
                      {static_cast<const float*>(moon), moon_h, moon_w}};
  const TexSlots ts{{0, 0, 0},
                    {sky_h, disk_h, moon_h},
                    {sky_w, disk_w, moon_w},
                    {need_sky, need_disk, need_moon}};
  const int blocks = bhgc_shade_bwd_blocks(n);
  with_scene_variant(kerr, sky != nullptr, disk, sph_mode,
                     [&](auto kr, auto sk, auto dk, auto sp) {
    shade_bwd_kernel<decltype(kr)::value, decltype(sk)::value,
                     decltype(dk)::value, decltype(sp)::value>
        <<<blocks, kShadeThreads, 0, s>>>(
        sc, ts, static_cast<const float*>(x), static_cast<const float*>(p),
        static_cast<const float*>(E), static_cast<const int*>(st),
        static_cast<const int*>(obj), static_cast<const float*>(g),
        static_cast<float*>(gx), static_cast<float*>(gp),
        static_cast<float*>(gE), static_cast<float*>(partial),
        static_cast<int*>(rec_slot), static_cast<float*>(rec_uv),
        static_cast<float*>(rec_g), static_cast<unsigned*>(stat), n);
  });
  shade_bwd_sums<<<ncol, kShadeThreads, 0, s>>>(
      static_cast<const float*>(partial), blocks, static_cast<float*>(cols));
  return static_cast<int>(cudaGetLastError());
}

// The texture cotangents of bhgc_shade_bwd's records: `dtex` (total_texels,
// 3) floats over the textures that need theirs, the sky's texels from
// sky_off, the disk's from disk_off, the spheres' stack from moon_off,
// through `scratch`: 3 T + ceil(3 T / 16) + 1 int64 words,
// zeroed, T = total_texels -- the sums, the flags, and the largest |term|
// bhgc_shade_bwd wrote at its end.
extern "C" int bhgc_shade_tex(const void* rec_slot, const void* rec_uv,
                              const void* rec_g, int n, int sky_h,
                              int sky_w, long long sky_off, int disk_h,
                              int disk_w, long long disk_off, int moon_h,
                              int moon_w, long long moon_off,
                              long long total_texels, void* scratch,
                              void* dtex, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const TexSlots ts{{sky_off, disk_off, moon_off},
                    {sky_h, disk_h, moon_h},
                    {sky_w, disk_w, moon_w},
                    {1, 1, 1}};
  const long long total = 3 * total_texels;
  auto* acc = static_cast<unsigned long long*>(scratch);
  auto* flags = reinterpret_cast<unsigned*>(acc + total);
  auto* stat = reinterpret_cast<unsigned*>(acc + total + (total + 15) / 16);
  const int blocks = (n + kScatterThreads - 1) / kScatterThreads;
  shade_tex_scatter<<<blocks, kScatterThreads, 0, s>>>(
      static_cast<const int*>(rec_slot), static_cast<const float*>(rec_uv),
      static_cast<const float*>(rec_g), n, ts, acc, flags, stat);
  tex_bwd_finish<<<grid_stride_blocks(total), kScatterThreads, 0, s>>>(
      reinterpret_cast<const long long*>(acc), flags, stat, n, total,
      static_cast<float*>(dtex));
  return static_cast<int>(cudaGetLastError());
}
