// The shading forward, for Hopper (sm_90a): the final direction and the
// shading of every ray, each by its own status, in one launch.
//
// Replaces no Pallas kernel.  The JAX package's shading is XLA's dense
// fusion of scene/shading.py; the port's plain path (`final_direction` +
// `shade`, scene/shading.py) runs every shader over every ray and selects
// by status: the sky is sampled for every ray, the disk and its g^beaming
// too, and each of the K spheres' textures K times, each lookup in a dozen
// PyTorch operations and a gather per corner.  In the 1024^2 x 5-spp orbit
// fit that took 11.9 ms a step on an H100 in 331 operations, and its
// autograd 9.4 ms more (PERF.md).
//
// Bound: bytes.  A ray reads its final state (x, p, E, status, hit object:
// 36 B) and writes its colour (12 B): 0.25 GB, 0.08 ms at 3.35 TB/s for
// 5.24M rays.  The textures (6 MB each at 512 x 1024) stay in the 50 MB L2.
//
// What the design does about it: one thread a ray, the branch of its
// status (shade.cuh `branch`) and no other: the velocity, the equirect
// coordinates and one bilinear lookup for the sky; the disk's profile,
// lookup and, with a beaming exponent, its redshift; the hit sphere's own
// texture once, and the Lambert lights with their shadow segments.  The
// scene's features are compile-time switches -- Kerr or Schwarzschild
// velocity (KERR), a sky or none (SKY), no disk, a plain or a beaming disk
// (DISK), no spheres, spheres, or spheres and lights (SPH) -- so a variant
// carries the code of what its scene holds and no more.  The scene's
// scalars, sphere table and lights are read with __ldg (the same for the
// whole warp).
//
// Plain C interface (loaded with ctypes): `bhgc_shade_fwd` launches the
// kernel on the given stream and returns cudaGetLastError() as an int.

#include "shade.cuh"

namespace {

template <bool KERR, bool SKY, int DISK, int SPH>
__global__ void __launch_bounds__(kShadeThreads)
    shade_fwd_kernel(ShadeScene sc, const float* __restrict__ x_in,
                     const float* __restrict__ p_in,
                     const float* __restrict__ E_in,
                     const int* __restrict__ st_in,
                     const int* __restrict__ obj_in, float* __restrict__ out,
                     int n) {
  const int i = blockIdx.x * kShadeThreads + threadIdx.x;
  if (i >= n) return;
  const long long j = 3LL * i;
  float c[3] = {0.0f, 0.0f, 0.0f};
  const int br = branch<DISK, SPH>(st_in[i]);
  if (br == kBrError) {
    c[0] = 1.0f;
  } else if (br != kBrBlack) {
    const Sc s = load_sc(sc.scal);
    const float x[3] = {x_in[j], x_in[j + 1], x_in[j + 2]};
    if (br == kBrSph) {
      if constexpr (SPH != kSphNone) {
        sph_color(sph_ray<SPH>(sc, s, x, obj_in[i]), c);
      }
    } else {
      const float p[3] = {p_in[j], p_in[j + 1], p_in[j + 2]};
      const float E = E_in[i];
      if (br == kBrDisk) {
        if constexpr (DISK != kDiskNone) {
          disk_color<DISK>(disk_ray<DISK>(s, sc.disk, x, p, E), c);
        }
      } else if (SKY) {
        const SkyRay r = sky_ray<KERR>(s, sc.sky, x, p, E);
        sample(sc.sky.p, r.q, c);
      }
    }
  }
  out[j] = c[0];
  out[j + 1] = c[1];
  out[j + 2] = c[2];
}

}  // namespace

// The (n, 3) colours of the n rays (x, p (n, 3), E, status, hit_obj (n,)).
// scal: the kNSh scalars; sph (n_sph, 8), lights (n_lights, 3); each
// texture (h, w, 3) and the spheres' (n_sph, mh, mw, 3), null when the
// scene has none.  kerr, disk (0 none, 1 plain, 2 beaming) and sph (0
// none, 1 spheres, 2 spheres and lights) choose the variant.
extern "C" int bhgc_shade_fwd(const void* scal, const void* sph, int n_sph,
                              const void* lights, int n_lights,
                              const void* sky, int sky_h, int sky_w,
                              const void* disk_tex, int disk_h, int disk_w,
                              const void* moon, int moon_h, int moon_w,
                              int kerr, int disk, int sph_mode,
                              const void* x, const void* p, const void* E,
                              const void* st, const void* obj, void* out,
                              int n, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const ShadeScene sc{static_cast<const float*>(scal),
                      static_cast<const float*>(sph),
                      static_cast<const float*>(lights),
                      n_sph,
                      n_lights,
                      {static_cast<const float*>(sky), sky_h, sky_w},
                      {static_cast<const float*>(disk_tex), disk_h, disk_w},
                      {static_cast<const float*>(moon), moon_h, moon_w}};
  const int blocks = (n + kShadeThreads - 1) / kShadeThreads;
  with_scene_variant(kerr, sky != nullptr, disk, sph_mode,
                     [&](auto kr, auto sk, auto dk, auto sp) {
    shade_fwd_kernel<decltype(kr)::value, decltype(sk)::value,
                     decltype(dk)::value, decltype(sp)::value>
        <<<blocks, kShadeThreads, 0, s>>>(
        sc, static_cast<const float*>(x), static_cast<const float*>(p),
        static_cast<const float*>(E), static_cast<const int*>(st),
        static_cast<const int*>(obj), static_cast<float*>(out), n);
  });
  return static_cast<int>(cudaGetLastError());
}
