// The per-ray shading and its VJP, shared by the shading forward
// (shade.cu) and backward (shade_bwd.cu): each ray takes the branch of its
// status, as `shade` (scene/shading.py) selects over its dense shaders:
//
//   ERROR                 red
//   CAPTURED, INSIDE_H.   black
//   OBJECT (with spheres) the emission texture at the normal's spherical UV
//                         mixed with the Lambert lights (LIGHTS) and their
//                         shadow segments against the spheres and horizon
//   DISK (with a disk)    the Gaussian-profile textured disk, times
//                         g^beaming where the disk has a beaming exponent
//   any other status      the sky at the unit coordinate velocity (the
//                         right-hand side's dx/dlambda, rk4_step.cuh `rhs`);
//                         black without a sky.
//
// ops/shade_adjoint.py is the plain PyTorch statement of these functions,
// line for line; the CPU tests hold it against autograd of
// integrate.final_direction + shade.
//
// Numerics: float32, no fast math.  The library's IEEE acosf, atan2f,
// atanf, expf, powf and sqrtf; the velocity takes rhs's reciprocal square
// roots (the integrator's forward form), its VJP rhs_vjp's IEEE forms.  The
// texture coordinates, the bilinear weights and colours are rounded
// operation by operation (__fmul_rn, ...), as PyTorch's elementwise
// kernels round them, so no fused multiply-add moves a texel between the
// forward and the backward's recompute; a division by pi is a product with
// float32 1/pi, as PyTorch's division of a CUDA tensor by a Python scalar.
// clamp and clamp_min pass NaN through, as PyTorch's do.

#pragma once

#include <cuda_runtime.h>

#include "rk4_step.cuh"

namespace {

constexpr int kShadeThreads = 256;
constexpr int kShadeWarps = kShadeThreads / 32;
constexpr int kInsideHorizon = 6;

// The scalar vector (shade_adjoint.py NSH and its layout).
constexpr int kNSh = 11;
constexpr int kMass = 0, kSpin = 1, kRIn = 2, kROut = 3, kPhase = 4,
              kMean = 5, kStddev = 6, kIntensity = 7, kBeaming = 8,
              kOrbitDir = 9, kLightI = 10;
constexpr int kSphCols = 8;   // cx, cy, cz, radius, emission, albedo rgb

constexpr int kDiskNone = 0, kDiskPlain = 1, kDiskBeaming = 2;
constexpr int kSphNone = 0, kSphPlain = 1, kSphLights = 2;

constexpr float kNormFloor = 1e-20f;
constexpr float kAcosEps = 1e-6f;
constexpr float kAcosLo = static_cast<float>(-1.0 + 1e-6);
constexpr float kAcosHi = static_cast<float>(1.0 - 1e-6);
constexpr float kShadowEps = 1e-5f;
constexpr float kInvPi = 1.0f / static_cast<float>(3.14159265358979323846);
constexpr float kInv2Pi = 1.0f / static_cast<float>(6.28318530717958647692);
constexpr float kTwoPi = static_cast<float>(6.28318530717958647692);

// The branches.
constexpr int kBrSky = 0, kBrDisk = 1, kBrSph = 2, kBrBlack = 3,
              kBrError = 4;

// A texture (H, W, 3); the spheres' (K, H, W, 3) stack, sphere k at
// p + k H W 3.
struct Tex {
  const float* p;
  int h, w;
};

// What the kernels read of the scene; scal: the kNSh scalars.
struct ShadeScene {
  const float* scal;
  const float* sph;      // (n_sph, kSphCols)
  const float* lights;   // (n_lights, 3)
  int n_sph, n_lights;
  Tex sky, disk, moon;
};

struct Sc {
  float v[kNSh];
};

__device__ __forceinline__ Sc load_sc(const float* scal) {
  Sc s;
#pragma unroll
  for (int q = 0; q < kNSh; ++q) s.v[q] = __ldg(scal + q);
  return s;
}

// PyTorch's clamp and clamp_min: NaN passes through.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return v < lo ? lo : v;
}

template <int DISK, int SPH>
__device__ __forceinline__ int branch(int st) {
  if (st == kError) return kBrError;
  if (st == kCaptured || st == kInsideHorizon) return kBrBlack;
  if (SPH != kSphNone && st == kObject) return kBrSph;
  if (DISK != kDiskNone && st == kDisk) return kBrDisk;
  return kBrSky;
}

// --- the bilinear lookup (texture._SampleBpy) ---------------------------

struct Quad {
  float tx, ty;
  long long t[4];   // texels of c00, c01, c10, c11 (texel index, not x 3)
  int dy;           // yi1 - yi0
};

// A texel index from a floored coordinate: 0 for a non-finite one (no read
// outside the texture), capped at 2^30, far beyond any texture.
__device__ __forceinline__ long long texel_index(float f) {
  if (!isfinite(f)) return 0;
  return static_cast<long long>(fminf(fmaxf(f, -1073741824.0f),
                                      1073741824.0f));
}

__device__ __forceinline__ Quad make_quad(int h, int w, float u, float v) {
  const float fx = __fsub_rn(
      __fmul_rn(__fmul_rn(__fadd_rn(u, 1.0f), 0.5f), static_cast<float>(w)),
      0.5f);
  const float fy = __fsub_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(1.0f, v), 0.5f), static_cast<float>(h)),
      0.5f);
  const float x0f = floorf(fx), y0f = floorf(fy);
  Quad q;
  q.tx = __fsub_rn(fx, x0f);
  q.ty = __fsub_rn(fy, y0f);
  const long long x0 = texel_index(x0f), y0 = texel_index(y0f);
  long long xi0 = x0 % w, xi1 = (x0 + 1) % w;
  if (xi0 < 0) xi0 += w;
  if (xi1 < 0) xi1 += w;
  const long long yi0 = min(max(y0, 0LL), static_cast<long long>(h - 1));
  const long long yi1 = min(max(y0 + 1, 0LL), static_cast<long long>(h - 1));
  q.t[0] = yi0 * w + xi0;
  q.t[1] = yi0 * w + xi1;
  q.t[2] = yi1 * w + xi0;
  q.t[3] = yi1 * w + xi1;
  q.dy = static_cast<int>(yi1 - yi0);
  return q;
}

// The bilinear colour of the quad in texture p.
__device__ __forceinline__ void sample(const float* p, const Quad& q,
                                       float out[3]) {
  const float ax = __fsub_rn(1.0f, q.tx), ay = __fsub_rn(1.0f, q.ty);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float c00 = __ldg(p + 3 * q.t[0] + c), c01 = __ldg(p + 3 * q.t[1] + c);
    const float c10 = __ldg(p + 3 * q.t[2] + c), c11 = __ldg(p + 3 * q.t[3] + c);
    const float top = __fadd_rn(__fmul_rn(c00, ax), __fmul_rn(c01, q.tx));
    const float bot = __fadd_rn(__fmul_rn(c10, ax), __fmul_rn(c11, q.tx));
    out[c] = __fadd_rn(__fmul_rn(top, ay), __fmul_rn(bot, q.ty));
  }
}

// The coordinate cotangents (du, dv) of the lookup for the colour
// cotangent g (tex_bwd.cu's dx, dy, rounded alike).
__device__ __forceinline__ void sample_vjp(const float* p, int h, int w,
                                           const Quad& q, const float g[3],
                                           float& du, float& dv) {
  const float ax = __fsub_rn(1.0f, q.tx), ay = __fsub_rn(1.0f, q.ty);
  float fx = 0.0f, fy = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v00 = __ldg(p + 3 * q.t[0] + c), v01 = __ldg(p + 3 * q.t[1] + c);
    const float v10 = __ldg(p + 3 * q.t[2] + c), v11 = __ldg(p + 3 * q.t[3] + c);
    fx = __fadd_rn(fx, __fmul_rn(g[c], __fadd_rn(
                                           __fmul_rn(__fsub_rn(v01, v00), ay),
                                           __fmul_rn(__fsub_rn(v11, v10), q.ty))));
    fy = __fadd_rn(fy, __fmul_rn(g[c], __fadd_rn(
                                           __fmul_rn(__fsub_rn(v10, v00), ax),
                                           __fmul_rn(__fsub_rn(v11, v01), q.tx))));
  }
  du = __fmul_rn(fx, 0.5f * static_cast<float>(w));
  dv = __fmul_rn(fy, -0.5f * static_cast<float>(h));
}

// --- the sky ----------------------------------------------------------------

template <bool KERR>
__device__ __forceinline__ void velocity(const Sc& s, const float x[3],
                                         const float p[3], float E,
                                         float v[3]) {
  Scalars sc{};
  sc.mass = s.v[kMass];
  sc.spin = s.v[kSpin];
  float k[6];
  rhs<KERR>(sc, E, x[0], x[1], x[2], p[0], p[1], p[2], k);
  v[0] = k[0];
  v[1] = k[1];
  v[2] = k[2];
}

// v / max(|v|, floor); nv = |v|, nc = max(nv, floor).
__device__ __forceinline__ void unit(const float v[3], float d[3], float& nv,
                                     float& nc) {
  nv = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  nc = clamp_min_nan(nv, kNormFloor);
  d[0] = v[0] / nc;
  d[1] = v[1] / nc;
  d[2] = v[2] / nc;
}

__device__ __forceinline__ void unit_vjp(const float v[3], float nv, float nc,
                                         const float gd[3], float gv[3]) {
  const float g_nc = -(gd[0] * v[0] + gd[1] * v[1] + gd[2] * v[2]) / (nc * nc);
  const float k = nv >= kNormFloor ? g_nc / nv : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) gv[c] = gd[c] / nc + k * v[c];
}

// bpy coords of a unit direction in an equirect texture.
__device__ __forceinline__ void equirect(const float d[3], float& u,
                                         float& v) {
  const float cz = clamp_nan(d[2], kAcosLo, kAcosHi);
  const float theta = __fsub_rn(1.0f, __fmul_rn(acosf(cz), kInvPi));
  const bool deg = fabsf(d[0]) < kAcosEps && fabsf(d[1]) < kAcosEps;
  const float ay = deg ? 0.0f : d[1], ax = deg ? 1.0f : d[0];
  u = -__fmul_rn(atan2f(ay, ax), kInvPi);
  v = __fsub_rn(__fmul_rn(2.0f, theta), 1.0f);
}

__device__ __forceinline__ void equirect_vjp(const float d[3], float gu,
                                             float gv, float gd[3]) {
  const bool deg = fabsf(d[0]) < kAcosEps && fabsf(d[1]) < kAcosEps;
  const float ay = deg ? 0.0f : d[1], ax = deg ? 1.0f : d[0];
  const float g_at = -gu * kInvPi;
  const float r2 = ax * ax + ay * ay;
  gd[0] = deg ? 0.0f : -g_at * ay / r2;
  gd[1] = deg ? 0.0f : g_at * ax / r2;
  const float g_ac = -(2.0f * gv) * kInvPi;
  const float cz = clamp_nan(d[2], kAcosLo, kAcosHi);
  const bool inside = d[2] >= kAcosLo && d[2] <= kAcosHi;
  gd[2] = inside ? -g_ac / sqrtf(1.0f - cz * cz) : 0.0f;
}

// The sky's direction and lookup coordinates.
struct SkyRay {
  float v[3], d[3], nv, nc, u, w;
  Quad q;
};

template <bool KERR>
__device__ __forceinline__ SkyRay sky_ray(const Sc& s, const Tex& sky,
                                          const float x[3], const float p[3],
                                          float E) {
  SkyRay r;
  velocity<KERR>(s, x, p, E, r.v);
  unit(r.v, r.d, r.nv, r.nc);
  equirect(r.d, r.u, r.w);
  r.q = make_quad(sky.h, sky.w, r.u, r.w);
  return r;
}

// --- the disk ----------------------------------------------------------------

struct DiskRay {
  float rr, width, span, s, sy, rc, c, cc, tx, e, den, gauss, sq, inten;
  float rgb[3], base[3];
  Quad q;
  // g^beaming (DISK == kDiskBeaming)
  float g, big_g;
  // redshift intermediates
  float zr, r, sqr, sqm, big_n, omega, d2, r75, sd2, big_q, ut, lz, rel,
      relc, e_emit, ec;
  bool valid;
};

__device__ __forceinline__ void redshift(const Sc& s, const float x[3],
                                         const float p[3], float E,
                                         DiskRay& z) {
  const float a = s.v[kSpin], sd = s.v[kOrbitDir], m = s.v[kMass];
  z.zr = x[0] * x[0] + x[1] * x[1] - a * a;
  z.r = sqrtf(clamp_min_nan(z.zr, kR2Floor));
  z.sqr = sqrtf(z.r);
  z.sqm = sqrtf(clamp_min_nan(m, kNormFloor));
  z.big_n = z.r * z.sqr + sd * a * z.sqm;
  z.omega = sd * z.sqm / z.big_n;
  z.d2 = z.r * z.sqr - 3.0f * m * z.sqr + sd * 2.0f * a * z.sqm;
  z.r75 = powf(z.r, 0.75f);
  z.sd2 = sqrtf(clamp_min_nan(z.d2, kR2Floor));
  z.big_q = z.r75 * z.sd2;
  z.ut = z.big_n / z.big_q;
  z.lz = x[0] * p[1] - x[1] * p[0];
  z.rel = E - z.omega * z.lz;
  z.relc = clamp_min_nan(z.rel, kR2Floor);
  z.e_emit = z.ut * z.relc;
  z.ec = clamp_min_nan(z.e_emit, kR2Floor);
  z.valid = z.d2 > kR2Floor && z.rel > 0.0f;
  z.g = z.valid ? E / z.ec : 0.0f;
}

template <int DISK>
__device__ __forceinline__ DiskRay disk_ray(const Sc& s, const Tex& tex,
                                            const float x[3],
                                            const float p[3], float E) {
  DiskRay z;
  const float x0 = x[0], x1 = x[1];
  z.rr = __fsqrt_rn(__fadd_rn(__fmul_rn(x0, x0), __fmul_rn(x1, x1)));
  z.width = s.v[kROut] - s.v[kRIn];
  z.span = clamp_min_nan(z.width, kNormFloor);
  z.s = (z.rr - s.v[kRIn]) / z.span;
  z.sy = x1 >= 0.0f ? 1.0f : -1.0f;
  z.rc = clamp_min_nan(z.rr, kNormFloor);
  z.c = x0 / z.rc;
  z.cc = clamp_nan(z.c, kAcosLo, kAcosHi);
  z.tx = __fmul_rn(__fadd_rn(s.v[kPhase], __fmul_rn(acosf(z.cc), z.sy)),
                   kInvPi);
  z.e = z.s - s.v[kMean];
  z.den = 2.0f * (s.v[kStddev] * s.v[kStddev]);
  z.gauss = expf(-(z.e * z.e) / z.den);
  z.sq = sqrtf(kTwoPi * s.v[kStddev]);
  z.inten = s.v[kIntensity] * z.gauss / z.sq;
  z.q = make_quad(tex.h, tex.w, z.tx, z.s);
  sample(tex.p, z.q, z.rgb);
#pragma unroll
  for (int c = 0; c < 3; ++c) z.base[c] = z.rgb[c] * z.inten;
  z.g = 0.0f;
  z.big_g = 1.0f;
  if (DISK == kDiskBeaming) {
    redshift(s, x, p, E, z);
    z.big_g = powf(z.g, s.v[kBeaming]);
  }
  return z;
}

template <int DISK>
__device__ __forceinline__ void disk_color(const DiskRay& z, float out[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[c] = DISK == kDiskBeaming ? z.base[c] * z.big_g : z.base[c];
  }
}

// Adds redshift's VJP for gg to gx, gp, gE and gs (mass, spin, orbit_dir).
__device__ __forceinline__ void redshift_vjp(const Sc& s, const float x[3],
                                             const float p[3], float E,
                                             const DiskRay& z, float gg,
                                             float gx[3], float gp[3],
                                             float& gE, float gs[kNSh]) {
  if (!z.valid) return;
  const float a = s.v[kSpin], sd = s.v[kOrbitDir], m = s.v[kMass];
  gE += gg / z.ec;
  const float g_ee = z.e_emit >= kR2Floor ? -gg * E / (z.ec * z.ec) : 0.0f;
  const float g_ut = g_ee * z.relc;
  const float g_rel = z.rel >= kR2Floor ? g_ee * z.ut : 0.0f;
  gE += g_rel;
  const float g_omega = -g_rel * z.lz;
  const float g_lz = -g_rel * z.omega;
  gx[0] += g_lz * p[1];
  gx[1] += -g_lz * p[0];
  gp[0] += -g_lz * x[1];
  gp[1] += g_lz * x[0];
  float g_n = g_ut / z.big_q;
  const float g_q = -g_ut * z.big_n / (z.big_q * z.big_q);
  float g_r = g_q * z.sd2 * 0.75f * powf(z.r, -0.25f);
  const float g_d2 = z.d2 >= kR2Floor ? g_q * z.r75 / (2.0f * z.sd2) : 0.0f;
  // omega = sd sqm / N
  const float g_num = g_omega / z.big_n;
  g_n = g_n - g_num * (sd * z.sqm) / z.big_n;
  float g_sd = g_num * z.sqm;
  float g_sqm = g_num * sd;
  // d2 = r sqr - 3 m sqr + 2 sd a sqm
  g_r = g_r + g_d2 * z.sqr;
  float g_sqr = g_d2 * (z.r - 3.0f * m);
  float g_m = -3.0f * g_d2 * z.sqr;
  g_sd = g_sd + g_d2 * 2.0f * a * z.sqm;
  float g_a = g_d2 * 2.0f * sd * z.sqm;
  g_sqm = g_sqm + g_d2 * 2.0f * sd * a;
  // N = r sqr + sd a sqm
  g_r = g_r + g_n * z.sqr;
  g_sqr = g_sqr + g_n * z.r;
  g_sd = g_sd + g_n * a * z.sqm;
  g_a = g_a + g_n * sd * z.sqm;
  g_sqm = g_sqm + g_n * sd * a;
  // sqm = sqrt(max(m, floor)), sqr = sqrt(r), r = sqrt(max(zr, floor))
  g_m = g_m + (m >= kNormFloor ? g_sqm / (2.0f * z.sqm) : 0.0f);
  g_r = g_r + g_sqr / (2.0f * z.sqr);
  const float g_zr = z.zr >= kR2Floor ? g_r / (2.0f * z.r) : 0.0f;
  g_a = g_a - 2.0f * a * g_zr;
  gx[0] += 2.0f * x[0] * g_zr;
  gx[1] += 2.0f * x[1] * g_zr;
  gs[kMass] += g_m;
  gs[kSpin] += g_a;
  gs[kOrbitDir] += g_sd;
}

// The disk's VJP for the colour cotangent gc: adds to gx, gp, gE, gs;
// returns the lookup's colour cotangent in g_rgb (the texture's terms).
template <int DISK>
__device__ __forceinline__ void disk_vjp(const Sc& s, const Tex& tex,
                                         const float x[3], const float p[3],
                                         float E, const DiskRay& z,
                                         const float gc_in[3], float gx[3],
                                         float gp[3], float& gE,
                                         float gs[kNSh], float g_rgb[3]) {
  float gc[3] = {gc_in[0], gc_in[1], gc_in[2]};
  if (DISK == kDiskBeaming) {
    const float beam = s.v[kBeaming];
    const float g_big =
        gc[0] * z.base[0] + gc[1] * z.base[1] + gc[2] * z.base[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) gc[c] = gc[c] * z.big_g;
    const float gg =
        beam != 0.0f ? g_big * (beam * powf(z.g, beam - 1.0f)) : 0.0f;
    gs[kBeaming] +=
        (z.g != 0.0f || beam < 0.0f) ? g_big * z.big_g * logf(z.g) : 0.0f;
    redshift_vjp(s, x, p, E, z, gg, gx, gp, gE, gs);
  }
  const float g_inten = gc[0] * z.rgb[0] + gc[1] * z.rgb[1] + gc[2] * z.rgb[2];
#pragma unroll
  for (int c = 0; c < 3; ++c) g_rgb[c] = gc[c] * z.inten;
  const float inten_w = s.v[kIntensity];
  gs[kIntensity] += g_inten * z.gauss / z.sq;
  const float g_gauss = g_inten * inten_w / z.sq;
  const float g_sq = -g_inten * (inten_w * z.gauss) / (z.sq * z.sq);
  const float g_sdv = g_sq * kTwoPi / (2.0f * z.sq);
  const float g_t = g_gauss * z.gauss;
  const float g_e = g_t * (-2.0f * z.e) / z.den;
  const float g_den = g_t * (z.e * z.e) / (z.den * z.den);
  gs[kStddev] += g_sdv + g_den * 4.0f * s.v[kStddev];
  float du, dv;
  sample_vjp(tex.p, tex.h, tex.w, z.q, g_rgb, du, dv);
  const float g_s = g_e + dv;
  gs[kMean] += -g_e;
  gs[kPhase] += du * kInvPi;
  const float g_ac = du * kInvPi * z.sy;
  const bool inside = z.c >= kAcosLo && z.c <= kAcosHi;
  const float g_c = inside ? -g_ac / sqrtf(1.0f - z.cc * z.cc) : 0.0f;
  gx[0] += g_c / z.rc;
  float g_rr = z.rr >= kNormFloor ? -g_c * x[0] / (z.rc * z.rc) : 0.0f;
  g_rr = g_rr + g_s / z.span;
  const float g_span =
      z.width >= kNormFloor
          ? -g_s * (z.rr - s.v[kRIn]) / (z.span * z.span)
          : 0.0f;
  gs[kRIn] += -g_s / z.span - g_span;
  gs[kROut] += g_span;
  gx[0] += g_rr * x[0] / z.rr;
  gx[1] += g_rr * x[1] / z.rr;
}

// --- the spheres -----------------------------------------------------------

// Whether a sphere or the horizon (radius 2M at the origin) blocks the
// segment x -> x + ld dist (shading._occluded).
__device__ __forceinline__ bool occluded(const ShadeScene& sc, const Sc& s,
                                         const float x[3], const float ld[3],
                                         float dist) {
  float o[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = x[c] + ld[c] * kShadowEps;
  bool blocked = false;
  for (int k = 0; k <= sc.n_sph; ++k) {
    float cen[3] = {0.0f, 0.0f, 0.0f};
    float rad = 2.0f * s.v[kMass];
    if (k < sc.n_sph) {
      const float* row = sc.sph + kSphCols * k;
      cen[0] = __ldg(row);
      cen[1] = __ldg(row + 1);
      cen[2] = __ldg(row + 2);
      rad = __ldg(row + 3);
    }
    const float oc0 = o[0] - cen[0], oc1 = o[1] - cen[1], oc2 = o[2] - cen[2];
    const float b = oc0 * ld[0] + oc1 * ld[1] + oc2 * ld[2];
    const float c = (oc0 * oc0 + oc1 * oc1 + oc2 * oc2) - rad * rad;
    const float disc = b * b - c;
    const float sq = sqrtf(disc > 0.0f ? disc : 1.0f);
    const float t0 = -b - sq;
    blocked = blocked || (disc > 0.0f && t0 > kShadowEps && t0 < dist);
  }
  return blocked;
}

// Light j's Lambert terms at x with unit normal nrm.
struct LightRay {
  float lv[3], d2, dist, dc, ld[3], ndl, vis, ndlc, cj;
};

__device__ __forceinline__ LightRay light_ray(const ShadeScene& sc,
                                              const Sc& s, const float x[3],
                                              const float nrm[3], int j) {
  LightRay t;
#pragma unroll
  for (int c = 0; c < 3; ++c) t.lv[c] = __ldg(sc.lights + 3 * j + c) - x[c];
  t.d2 = t.lv[0] * t.lv[0] + t.lv[1] * t.lv[1] + t.lv[2] * t.lv[2];
  t.dist = sqrtf(t.d2);
  t.dc = clamp_min_nan(t.dist, kNormFloor);
#pragma unroll
  for (int c = 0; c < 3; ++c) t.ld[c] = t.lv[c] / t.dc;
  t.ndl = nrm[0] * t.ld[0] + nrm[1] * t.ld[1] + nrm[2] * t.ld[2];
  t.vis = occluded(sc, s, x, t.ld, t.dist) ? 0.0f : 1.0f;
  t.ndlc = clamp_min_nan(t.ndl, 0.0f);
  t.cj = s.v[kLightI] * t.vis * t.ndlc / t.d2;
  return t;
}

// Light j's Lambert transpose for the cotangent g_lam of the Lambert
// colour: adds to g_base, g_li, g_nrm; writes the cotangent of the
// light's position (that of x is its negative) to g_lv.
__device__ __forceinline__ void light_vjp(const Sc& s, const LightRay& t,
                                          const float nrm[3],
                                          const float base[3],
                                          const float g_lam[3],
                                          float g_base[3], float& g_li,
                                          float g_nrm[3], float g_lv[3]) {
  float g_cj = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g_base[c] += g_lam[c] * t.cj;
    g_cj += g_lam[c] * base[c];
  }
  g_li += g_cj * t.vis * t.ndlc / t.d2;
  const float g_ndlc = g_cj * s.v[kLightI] * t.vis / t.d2;
  float g_d2 = -g_cj * t.cj / t.d2;
  const float g_ndl = t.ndl >= 0.0f ? g_ndlc : 0.0f;
  float g_ld[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g_nrm[c] += g_ndl * t.ld[c];
    g_ld[c] = g_ndl * nrm[c];
  }
  const float g_dist =
      t.dist >= kNormFloor
          ? -(g_ld[0] * t.lv[0] + g_ld[1] * t.lv[1] + g_ld[2] * t.lv[2]) /
                (t.dc * t.dc)
          : 0.0f;
  g_d2 = g_d2 + g_dist / (2.0f * t.dist);
#pragma unroll
  for (int c = 0; c < 3; ++c) g_lv[c] = g_ld[c] / t.dc + 2.0f * t.lv[c] * g_d2;
}

struct SphRay {
  int k;
  float nvec[3], nrm[3], nn, nc, cz, den, q, u, v, em[3], lam[3], base[3],
      w;
  Quad quad;
};

template <int SPH>
__device__ __forceinline__ SphRay sph_ray(const ShadeScene& sc, const Sc& s,
                                          const float x[3], int obj) {
  SphRay z;
  z.k = min(max(obj, 0), sc.n_sph - 1);
  const float* row = sc.sph + kSphCols * z.k;
#pragma unroll
  for (int c = 0; c < 3; ++c) z.nvec[c] = x[c] - __ldg(row + c);
  unit(z.nvec, z.nrm, z.nn, z.nc);
  z.cz = clamp_nan(z.nrm[2], kAcosLo, kAcosHi);
  const float th = acosf(z.cz);
  z.den = fabsf(z.nrm[0]) > kNormFloor ? z.nrm[0] : kNormFloor;
  z.q = z.nrm[1] / z.den;
  z.u = __fmul_rn(atanf(z.q), kInv2Pi);
  z.v = __fmul_rn(th, kInvPi);
  z.quad = make_quad(sc.moon.h, sc.moon.w, z.u, z.v);
  const float* tex =
      sc.moon.p + static_cast<long long>(z.k) * sc.moon.h * sc.moon.w * 3;
  sample(tex, z.quad, z.em);
  z.w = __ldg(row + 4);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    z.lam[c] = 0.0f;
    z.base[c] = __ldg(row + 5 + c) * s.v[kLightI];
  }
  if (SPH == kSphLights) {
    for (int j = 0; j < sc.n_lights; ++j) {
      const LightRay t = light_ray(sc, s, x, z.nrm, j);
#pragma unroll
      for (int c = 0; c < 3; ++c) z.lam[c] = z.lam[c] + z.base[c] * t.cj;
    }
  }
  return z;
}

__device__ __forceinline__ void sph_color(const SphRay& z, float out[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[c] = z.w * z.em[c] + (1.0f - z.w) * z.lam[c];
  }
}

// The sphere hit's VJP for the colour cotangent gc: adds to gx and
// gs[kLightI]; writes the cotangent of the ray's row of the sphere table
// to g_row, of the emission lookup's colour to g_em (the texture's terms)
// and of the Lambert colour to g_lam (the lights' position cotangents,
// light_vjp, come from it).
template <int SPH>
__device__ __forceinline__ void sph_vjp(const ShadeScene& sc, const Sc& s,
                                        const float x[3], const SphRay& z,
                                        const float gc[3], float gx[3],
                                        float gs[kNSh],
                                        float g_row[kSphCols],
                                        float g_em[3], float g_lam[3]) {
  g_row[4] = (gc[0] * z.em[0] + gc[1] * z.em[1] + gc[2] * z.em[2]) -
             (gc[0] * z.lam[0] + gc[1] * z.lam[1] + gc[2] * z.lam[2]);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    g_em[c] = gc[c] * z.w;
    g_lam[c] = gc[c] * (1.0f - z.w);
  }
  float g_nrm[3] = {0.0f, 0.0f, 0.0f}, g_base[3] = {0.0f, 0.0f, 0.0f};
  float g_li = 0.0f;
  if (SPH == kSphLights) {
    for (int j = 0; j < sc.n_lights; ++j) {
      const LightRay t = light_ray(sc, s, x, z.nrm, j);
      float g_lv[3];
      light_vjp(s, t, z.nrm, z.base, g_lam, g_base, g_li, g_nrm, g_lv);
#pragma unroll
      for (int c = 0; c < 3; ++c) gx[c] -= g_lv[c];
    }
  }
  const float* row = sc.sph + kSphCols * z.k;
#pragma unroll
  for (int c = 0; c < 3; ++c) g_row[5 + c] = g_base[c] * s.v[kLightI];
  g_li += g_base[0] * __ldg(row + 5) + g_base[1] * __ldg(row + 6) +
          g_base[2] * __ldg(row + 7);
  gs[kLightI] += g_li;
  const float* tex =
      sc.moon.p + static_cast<long long>(z.k) * sc.moon.h * sc.moon.w * 3;
  float du, dv;
  sample_vjp(tex, sc.moon.h, sc.moon.w, z.quad, g_em, du, dv);
  const float g_ph = du * kInv2Pi;
  const float g_th = dv * kInvPi;
  const bool inside = z.nrm[2] >= kAcosLo && z.nrm[2] <= kAcosHi;
  g_nrm[2] += inside ? -g_th / sqrtf(1.0f - z.cz * z.cz) : 0.0f;
  const float g_q = g_ph / (1.0f + z.q * z.q);
  g_nrm[1] += g_q / z.den;
  g_nrm[0] += fabsf(z.nrm[0]) > kNormFloor
                  ? -g_q * z.nrm[1] / (z.den * z.den)
                  : 0.0f;
  float g_nvec[3];
  unit_vjp(z.nvec, z.nn, z.nc, g_nrm, g_nvec);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gx[c] += g_nvec[c];
    g_row[c] = -g_nvec[c];
  }
  g_row[3] = 0.0f;
}

// Calls f(KERR, SKY, DISK, SPH) with the scene's features as
// std::integral_constants: the host entry points launch their kernel
// templates' instantiation through it.
template <typename F>
void with_scene_variant(int kerr, int sky, int disk, int sph, F&& f) {
  with_kerr(kerr, [&](auto kr) {
    auto pick_sky = [&](auto sk) {
      auto pick_disk = [&](auto dk) {
        if (sph == kSphLights) {
          f(kr, sk, dk, std::integral_constant<int, kSphLights>());
        } else if (sph == kSphPlain) {
          f(kr, sk, dk, std::integral_constant<int, kSphPlain>());
        } else {
          f(kr, sk, dk, std::integral_constant<int, kSphNone>());
        }
      };
      if (disk == kDiskBeaming) {
        pick_disk(std::integral_constant<int, kDiskBeaming>());
      } else if (disk == kDiskPlain) {
        pick_disk(std::integral_constant<int, kDiskPlain>());
      } else {
        pick_disk(std::integral_constant<int, kDiskNone>());
      }
    };
    if (sky) {
      pick_sky(std::true_type());
    } else {
      pick_sky(std::false_type());
    }
  });
}

}  // namespace
