// One fixed RK4 geodesic step and its exact adjoint, shared by the
// forward kernel (rk4_fwd.cu), the checkpointing forward (rk4_ckpt.cu) and
// the adjoint (rk4_bwd.cu), so the three run the same step code; the
// Dormand-Prince trip (dopri_trip.cuh) shares its right-hand sides, their
// VJPs, the classification and merge (classify_merge) and the events.
//
// The step is `_soa_step` of blackhole_geodesic_calculator_tpu/ops/
// pallas_kernel.py: the per-ray step size of `_dt_soa`, four evaluations of
// the right-hand side and `_events_merge`, the endpoint classification
// with, behind the compile-time switches DISK and SPH, the segment events
// of the z = 0 disk and of K spheres.  With both switches off the step is
// the event-free one, code and registers alike.  The compile-time switch
// KERR selects the spacetime (`kerr=` of `_build`, pallas_kernel.py:1379):
// off, `_rhs_schw_soa` and the Euclidean radius; on, the analytic Kerr
// right-hand side `_rhs_kerr_soa` (:84-142) and the floored Kerr-Schild
// radius `_ks_radius_soa` (:145-153) for the step size and the endpoint,
// with the sphere guard's band widened by |a| (:249-265).  A step computes
// the radius once, at its endpoint, and the next step's size reuses it
// (Ray::rad).
// The sphere table is K rows of [cx, cy, cz, radius] in the hole's frame,
// K a runtime argument; every thread reads it (`__ldg`, the rows are the
// same for the whole warp).  The adjoint is `_step_adjoint`
// (pallas_kernel.py:1025-1153), with the transpose of the event tail
// derived by hand; its plain PyTorch statement, line for line, is
// ops/adjoint.py, which the CPU tests hold against JAX.

#pragma once

#include <cuda_runtime.h>

#include <limits>
#include <type_traits>

// Witness builds (_build.built_with; chip_smoke.py holds the shipped
// kernels against them): BHGC_SPHERE_GUARD=0 drops the sphere guard, so
// its outputs show what the guard may not change; BHGC_IEEE_RECIPROCALS=1
// gives rsqrt_ftz and rcp_ftz (and dopri_trip.cuh's quot_ftz and step_u)
// their IEEE forms, so its outputs show what the special-function unit's
// approximations move.
#ifndef BHGC_SPHERE_GUARD
#define BHGC_SPHERE_GUARD 1
#endif
#ifndef BHGC_IEEE_RECIPROCALS
#define BHGC_IEEE_RECIPROCALS 0
#endif

namespace {

constexpr int kActive = 0;
constexpr int kCaptured = 1;
constexpr int kEscaped = 2;
constexpr int kBudget = 3;
constexpr int kDisk = 4;
constexpr int kObject = 5;
constexpr int kError = 7;

constexpr int kNScal = 10;
constexpr float kR2Floor = 1e-12f;
constexpr float kMinNormal = std::numeric_limits<float>::min();

constexpr float kInf = std::numeric_limits<float>::infinity();

// Scalar vector layout (NSCAL = 10), the TPU kernel's:
// [mass, dt, dt_boost, r_ref, r_capture, r_escape, lam_max, r_in, r_out, a]
// inv_r_ref = 1 / r_ref, formed once for the step size (div_rn);
// [sph_lo, sph_hi] the radii the K spheres' surfaces span, formed once for
// the sphere guard (segment_events).
struct Scalars {
  float mass, dt, boost, r_ref, r_capture, r_escape, lam_max, r_in, r_out,
      spin, inv_r_ref, sph_lo, sph_hi;
};

// The scalars, and the span of the sphere table sph (K = n_sph rows of
// [cx, cy, cz, radius]): [min_k |c_k| - r_k, max_k |c_k| + r_k], widened
// by a relative 1e-6, far above its rounding, so that no sphere a segment
// can enter lies outside it.
__device__ __forceinline__ Scalars load_scalars(const float* scal,
                                                const float* sph,
                                                int n_sph) {
  Scalars sc;
  sc.mass = __ldg(scal + 0);
  sc.dt = __ldg(scal + 1);
  sc.boost = __ldg(scal + 2);
  sc.r_ref = __ldg(scal + 3);
  sc.r_capture = __ldg(scal + 4);
  sc.r_escape = __ldg(scal + 5);
  sc.lam_max = __ldg(scal + 6);
  sc.r_in = __ldg(scal + 7);
  sc.r_out = __ldg(scal + 8);
  sc.spin = __ldg(scal + 9);
  sc.inv_r_ref = 1.0f / sc.r_ref;
  float lo = kInf, hi = -kInf;
  for (int k = 0; k < n_sph; ++k) {
    const float cx = __ldg(sph + 4 * k), cy = __ldg(sph + 4 * k + 1);
    const float cz = __ldg(sph + 4 * k + 2), rad = __ldg(sph + 4 * k + 3);
    const float ck = sqrtf(cx * cx + cy * cy + cz * cz);
    lo = fminf(lo, ck - rad);
    hi = fmaxf(hi, ck + rad);
  }
  sc.sph_lo = lo - 1e-6f * fabsf(lo);
  sc.sph_hi = hi + 1e-6f * fabsf(hi);
  return sc;
}

// One ray's state in registers.  rad is the radius (radius<KERR>) of
// (x0, x1, x2) while the ray is ACTIVE: classify_merge leaves the
// endpoint's there, so the next step's size reuses it.
struct Ray {
  float x0, x1, x2, p0, p1, p2, lam, rad;
  int status, obj;
};

// 1/sqrt(x) and 1/x from the special-function unit with subnormals flushed
// (rsqrt.approx.ftz, rcp.approx.ftz): for a normal x the values of rsqrtf
// and __fdividef(1, x), without the instructions that rescale a subnormal
// x.  Their callers pass floored, normal arguments (rhs_kerr takes a zero
// or subnormal S^2 apart; the sphere guard floors |y - x|^2).  They
// depart from the port's rule of no fast math: PERF.md gives what they
// move in the Kerr forward, measured against a BHGC_IEEE_RECIPROCALS
// build, whose IEEE forms (1 / sqrtf, 1 / x) they replace.
__device__ __forceinline__ float rsqrt_ftz(float x) {
#if defined(__CUDA_ARCH__) && !BHGC_IEEE_RECIPROCALS
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return 1.0f / sqrtf(x);
#endif
}

__device__ __forceinline__ float rcp_ftz(float x) {
#if defined(__CUDA_ARCH__) && !BHGC_IEEE_RECIPROCALS
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return 1.0f / x;
#endif
}

// Schwarzschild Kerr-Schild Hamiltonian right-hand side (geodesic.py
// schwarzschild_rhs / pallas_kernel.py _rhs_schw_soa), state (a, b) = (x, p).
__device__ __forceinline__ void rhs_schw(float mass, float E, float a0,
                                         float a1, float a2, float b0,
                                         float b1, float b2, float k[6]) {
  const float r2 = fmaxf(a0 * a0 + a1 * a1 + a2 * a2, kR2Floor);
  const float inv_r = rsqrt_ftz(r2);
  const float inv_r2 = inv_r * inv_r;
  const float n0 = a0 * inv_r, n1 = a1 * inv_r, n2 = a2 * inv_r;
  const float u = (2.0f * mass) * inv_r;
  const float s = n0 * b0 + n1 * b1 + n2 * b2;
  const float w = E + s;
  const float uw = u * w;
  const float m_r2 = mass * inv_r2;
  const float cp = 2.0f * m_r2 * w;
  const float cn = m_r2 * w * (w + 2.0f * s);
  k[0] = b0 - uw * n0;
  k[1] = b1 - uw * n1;
  k[2] = b2 - uw * n2;
  k[3] = cp * b0 - cn * n0;
  k[4] = cp * b1 - cn * n1;
  k[5] = cp * b2 - cn * n2;
}

// Kerr-Schild Kerr Hamiltonian right-hand side (pallas_kernel.py
// _rhs_kerr_soa; ops/geodesic.py kerr_rhs_soa), spin a.  As there, but for
// its divisions and square roots: S and 1/S come from one reciprocal
// square root, r and 1/r from another, and 1/A, 1/D from the
// special-function unit's reciprocal (rsqrt_ftz, rcp_ftz) -- four MUFU
// operations, without the refinement, range check and slow path that an
// IEEE square root or division carries.  A ray meets the floors as there:
// r^2 >= 1e-12 and 1 / (r S) <= 1e12 (S^2 = 0 or subnormal, 1/S = inf,
// only at the ring singularity).
__device__ __forceinline__ void rhs_kerr(float mass, float spin, float E,
                                         float a0, float a1, float a2,
                                         float b0, float b1, float b2,
                                         float k[6]) {
  const float s2 = spin * spin;
  const float rho2 = a0 * a0 + a1 * a1 + a2 * a2;
  const float bq = rho2 - s2;
  const float S2 = bq * bq + 4.0f * s2 * a2 * a2;
  const float inv_S = rsqrt_ftz(S2);
  const float S = S2 >= kMinNormal ? S2 * inv_S : 0.0f;
  const float r2 = fmaxf(0.5f * (bq + S), kR2Floor);
  const float inv_r = rsqrt_ftz(r2);
  const float r = r2 * inv_r;
  const float inv_rS = fminf(inv_r * inv_S, 1.0f / kR2Floor);
  const float az = s2 * a2;
  const float dr0 = r2 * a0 * inv_rS;
  const float dr1 = r2 * a1 * inv_rS;
  const float dr2 = (r2 * a2 + az) * inv_rS;

  const float A = r2 + s2;
  const float inv_A = rcp_ftz(A);
  const float n0 = r * a0 + spin * a1;
  const float n1 = r * a1 - spin * a0;
  const float l0 = n0 * inv_A;
  const float l1 = n1 * inv_A;
  const float l2 = a2 * inv_r;
  const float D = r2 * r2 + az * a2;
  const float inv_D = rcp_ftz(D);
  const float H = mass * r * r2 * inv_D;

  const float w = E + l0 * b0 + l1 * b1 + l2 * b2;
  const float q = 2.0f * H;

  // dH/dx_i = M (3 r^2 D - 4 r^6) dr_i / D^2 - 2 M a^2 z r^3 d_i2 / D^2
  const float hcoef =
      mass * (3.0f * r2 * D - 4.0f * r2 * r2 * r2) * inv_D * inv_D;
  const float dH0 = hcoef * dr0;
  const float dH1 = hcoef * dr1;
  const float dH2 = hcoef * dr2 - 2.0f * mass * az * r * r2 * inv_D * inv_D;

  // dw_i = b_j dl_j/dx_i (quotient rule; dA/dx_i = 2 r dr_i)
  const float twoR_A2 = 2.0f * r * inv_A * inv_A;
  const float inv_r2 = inv_r * inv_r;
  const float dw0 = b0 * ((dr0 * a0 + r) * inv_A - n0 * twoR_A2 * dr0) +
                    b1 * ((dr0 * a1 - spin) * inv_A - n1 * twoR_A2 * dr0) +
                    b2 * (-a2 * dr0 * inv_r2);
  const float dw1 = b0 * ((dr1 * a0 + spin) * inv_A - n0 * twoR_A2 * dr1) +
                    b1 * ((dr1 * a1 + r) * inv_A - n1 * twoR_A2 * dr1) +
                    b2 * (-a2 * dr1 * inv_r2);
  const float dw2 = b0 * (dr2 * a0 * inv_A - n0 * twoR_A2 * dr2) +
                    b1 * (dr2 * a1 * inv_A - n1 * twoR_A2 * dr2) +
                    b2 * (inv_r - a2 * dr2 * inv_r2);

  const float w2 = w * w;
  const float qw = q * w;
  k[0] = b0 - qw * l0;
  k[1] = b1 - qw * l1;
  k[2] = b2 - qw * l2;
  k[3] = w2 * dH0 + qw * dw0;
  k[4] = w2 * dH1 + qw * dw1;
  k[5] = w2 * dH2 + qw * dw2;
}

// The right-hand side of the spacetime KERR selects.
template <bool KERR>
__device__ __forceinline__ void rhs(const Scalars& sc, float E, float a0,
                                    float a1, float a2, float b0, float b1,
                                    float b2, float k[6]) {
  if (KERR) {
    rhs_kerr(sc.mass, sc.spin, E, a0, a1, a2, b0, b1, b2, k);
  } else {
    rhs_schw(sc.mass, E, a0, a1, a2, b0, b1, b2, k);
  }
}

// |x|^2 as fma(x2, x2, fma(x1, x1, x0 x0)), every operation written out
// with its rounding (__fmul_rn, __fmaf_rn, ...): no inlining context can
// contract it otherwise, so the radius classify_merge leaves in Ray::rad
// equals the one computed afresh from the same point (rk4_bwd's recompute
// from a checkpoint, its sweep from the tape) bit for bit.
__device__ __forceinline__ float norm2_rn(float x0, float x1, float x2) {
  return __fmaf_rn(x2, x2, __fmaf_rn(x1, x1, __fmul_rn(x0, x0)));
}

// Kerr-Schild radius with r^2 floored at 1e-12 (_ks_radius_soa), rounded
// as written (norm2_rn).
__device__ __forceinline__ float ks_radius(float spin, float x0, float x1,
                                           float x2) {
  const float s2 = __fmul_rn(spin, spin);
  const float bq = __fsub_rn(norm2_rn(x0, x1, x2), s2);
  const float S2 =
      __fmaf_rn(bq, bq, __fmul_rn(__fmul_rn(4.0f, s2), __fmul_rn(x2, x2)));
  const float r2 = __fmul_rn(0.5f, __fadd_rn(bq, __fsqrt_rn(S2)));
  return __fsqrt_rn(fmaxf(r2, kR2Floor));
}

// The step-size and endpoint radius: Euclidean, or Kerr-Schild for KERR.
template <bool KERR>
__device__ __forceinline__ float radius(const Scalars& sc, float x0,
                                        float x1, float x2) {
  return KERR ? ks_radius(sc.spin, x0, x1, x2)
              : __fsqrt_rn(norm2_rn(x0, x1, x2));
}

// a / b correctly rounded, from inv_b = 1 / b correctly rounded: q =
// a inv_b and one correction by the exact residual a - b q (Markstein),
// the IEEE division's fast path without its reciprocal, range check and
// slow path; exact for a, b, a / b in the normal range, as r / r_ref is.
__device__ __forceinline__ float div_rn(float a, float b, float inv_b) {
  const float q = __fmul_rn(a, inv_b);
  return __fmaf_rn(__fmaf_rn(-b, q, a), inv_b, q);
}

// (r / r_ref)^power of the step-size schedule, before its clip to
// [1, boost], from ratio = r / r_ref.  PMODE: 0 -> power 1, 1 -> power
// 1.5 (sqrt form), 2 -> power 2, 3 -> general power.
template <int PMODE>
__device__ __forceinline__ float schedule(float ratio, float power) {
  if (PMODE == 1) {
    return ratio * sqrtf(fmaxf(ratio, 0.0f));
  } else if (PMODE == 2) {
    return ratio * ratio;
  } else if (PMODE == 3) {
    return powf(fmaxf(ratio, 1e-20f), power);
  }
  return ratio;
}

// Per-ray step size dt * clip((r / r_ref)^power, 1, boost) (_dt_soa) at
// radius ra.
template <int PMODE>
__device__ __forceinline__ float step_size(const Scalars& sc, float power,
                                           float ra) {
  const float rp =
      schedule<PMODE>(div_rn(ra, sc.r_ref, sc.inv_r_ref), power);
  return sc.dt * fminf(fmaxf(rp, 1.0f), sc.boost);
}

// Calls f(std::integral_constant<int, PMODE>()) with the step-size mode of
// `power`; the host entry points launch their kernel templates through it.
template <typename F>
void with_power_mode(float power, F&& f) {
  if (power == 1.0f) {
    f(std::integral_constant<int, 0>());
  } else if (power == 1.5f) {
    f(std::integral_constant<int, 1>());
  } else if (power == 2.0f) {
    f(std::integral_constant<int, 2>());
  } else {
    f(std::integral_constant<int, 3>());
  }
}

// Calls f(std::integral_constant<bool, KERR>()): the spacetime the host
// entry points launch.  Kerr is chosen by the caller's flag, never inferred
// from the spin's value: a spin of exactly 0 the caller passed is Kerr, as
// in the TPU kernel (`kerr=env.spin is not None`, pallas_kernel.py:1620).
template <typename F>
void with_kerr(int kerr, F&& f) {
  if (kerr) {
    f(std::integral_constant<bool, true>());
  } else {
    f(std::integral_constant<bool, false>());
  }
}

// Calls f(std::integral_constant<int, V>()) with V = 2 * has_disk +
// (n_sph > 0): the event variant the host entry points launch.
template <typename F>
void with_events(int has_disk, int n_sph, F&& f) {
  if (has_disk && n_sph > 0) {
    f(std::integral_constant<int, 3>());
  } else if (has_disk) {
    f(std::integral_constant<int, 2>());
  } else if (n_sph > 0) {
    f(std::integral_constant<int, 1>());
  } else {
    f(std::integral_constant<int, 0>());
  }
}

// The events of the segment x -> y (`_events_merge`, :211-270).
struct SegEvents {
  bool disk;          // the segment crosses z = 0 inside the annulus
  float t_disk;       // its fraction of the segment
  float d0, d1;       // the crossing point (z = 0)
  int sid;            // the first sphere entered, -1 for none
  float t_sph;        // its fraction of the segment (kInf for none)
};

// x + (y - x) t rounded after each operation, as the plain path computes
// it: the compiler may not fuse it into an FMA differently from kernel to
// kernel, so the kernels' event points agree bit for bit.
__device__ __forceinline__ float lerp_rn(float x, float y, float t) {
  return __fadd_rn(x, __fmul_rn(__fsub_rn(y, x), t));
}

// The events of the segment x -> y; rb is the endpoint radius (|y|, or for
// KERR the Kerr-Schild radius).  GUARD skips the K sphere quadratics when
// the segment cannot reach any sphere: every point of the segment lies
// within L = |y - x| of y, so sphere k (surface radii |c_k| -+ r_k) can be
// entered only if [|y| - L, |y| + L] meets [|c_k| - r_k, |c_k| + r_k].  The
// Kerr-Schild radius brackets |y| as rb <= |y| <= rb + |a|, so for KERR the
// band's upper end gains |a| of slack (`guard_spheres`, :249-268).  The
// test is conservative, so the result is the same bit for bit with or
// without it.
template <bool KERR, bool DISK, bool SPH, bool GUARD>
__device__ __forceinline__ SegEvents segment_events(
    const Scalars& sc, const float* __restrict__ sph, int n_sph, float x0,
    float x1, float x2, float y0, float y1, float y2, float rb) {
  SegEvents ev;
  ev.disk = false;
  ev.t_disk = kInf;
  ev.d0 = 0.0f;
  ev.d1 = 0.0f;
  // the crossing point and its radius only where the segment crosses
  // z = 0, which few steps of a warp do (nothing else reads them)
  if (DISK && ((y2 < 0.0f && x2 >= 0.0f) || (y2 > 0.0f && x2 <= 0.0f))) {
    const float denom = y2 - x2;
    const float t = -x2 / (fabsf(denom) > 0.0f ? denom : 1.0f);
    ev.d0 = lerp_rn(x0, y0, t);
    ev.d1 = lerp_rn(x1, y1, t);
    const float rr = sqrtf(ev.d0 * ev.d0 + ev.d1 * ev.d1);
    ev.disk = rr >= sc.r_in && rr <= sc.r_out;
    if (ev.disk) ev.t_disk = t;
  }
  ev.sid = -1;
  ev.t_sph = kInf;
  if (SPH) {
    const float dx0 = y0 - x0, dx1 = y1 - x1, dx2 = y2 - x2;
    const float aa = dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
    if (GUARD && BHGC_SPHERE_GUARD) {
      // |c_k| in [rb - L - r_k, rb_hi + L + r_k], compared in squares (no
      // square root a sphere), with L from the special-function unit;
      // L and the squares carry a relative slack of 1e-6, far above their
      // rounding, so the test keeps every sphere the exact one keeps
      const float L = aa * rsqrt_ftz(fmaxf(aa, kMinNormal)) * 1.000001f;
      const float lo = rb - L;
      const float hi = (KERR ? rb + fabsf(sc.spin) : rb) + L;
      // first the span of all the spheres: most steps end here
      if (lo > sc.sph_hi || hi < sc.sph_lo) return ev;
      bool possible = false;
      for (int k = 0; k < n_sph; ++k) {
        const float cx = __ldg(sph + 4 * k), cy = __ldg(sph + 4 * k + 1);
        const float cz = __ldg(sph + 4 * k + 2), rad = __ldg(sph + 4 * k + 3);
        const float c2 = cx * cx + cy * cy + cz * cz;
        const float lo_k = lo - rad, hi_k = hi + rad;
        possible = possible ||
                   ((lo_k <= 0.0f || c2 * 1.000001f >= lo_k * lo_k) &&
                    c2 * 0.999999f <= hi_k * hi_k);
      }
      if (!possible) return ev;
    }
    const float denom_a = aa > 0.0f ? 2.0f * aa : 1.0f;
    for (int k = 0; k < n_sph; ++k) {
      const float o0 = x0 - __ldg(sph + 4 * k);
      const float o1 = x1 - __ldg(sph + 4 * k + 1);
      const float o2 = x2 - __ldg(sph + 4 * k + 2);
      const float rad = __ldg(sph + 4 * k + 3);
      const float bb = 2.0f * (o0 * dx0 + o1 * dx1 + o2 * dx2);
      const float cc = o0 * o0 + o1 * o1 + o2 * o2 - rad * rad;
      const float disc = bb * bb - 4.0f * aa * cc;
      // the root and its division only where the segment's line meets the
      // sphere (integrate._sphere_events guards the sqrt instead); a later
      // sphere must come strictly earlier: ties go to the lowest k
      if (disc > 0.0f) {
        const float t = (-bb - sqrtf(disc)) / denom_a;
        if (t >= 0.0f && t <= 1.0f && t < ev.t_sph) {
          ev.t_sph = t;
          ev.sid = k;
        }
      }
    }
  }
  return ev;
}

// Endpoint classification, the segment events and the freeze merge of the
// step x -> y of an ACTIVE ray r, with endpoint momentum q and length dt
// (`_events_merge`, :272-317): never store a non-finite state; an event
// ray freezes at the interpolated event point.  Shared by rk4_step and
// dopri_trip (dopri_trip.cuh), so the two integrators classify alike.
// `inside`: the step sampled the horizon's interior deep enough that it
// crossed it (rk4_step, Kerr), so the ray is CAPTURED whatever its
// endpoint and events say.
template <bool KERR, bool DISK, bool SPH, bool GUARD>
__device__ __forceinline__ void classify_merge(const Scalars& sc,
                                               const float* __restrict__ sph,
                                               int n_sph, float dt, float y0,
                                               float y1, float y2, float q0,
                                               float q1, float q2, Ray& r,
                                               bool inside = false) {
  // Endpoint classification, lowest priority first (_events_merge); a
  // sphere entry overrides it, and a disk crossing no later on the segment
  // overrides that.
  const float rb = radius<KERR>(sc, y0, y1, y2);
  r.rad = rb;   // the next step's radius, if the ray stays ACTIVE
  // not fused with h = dt * clip(...): kernels that fuse differently would
  // part in the last bit of lam
  const float lam1 = __fadd_rn(r.lam, dt);
  const bool finite = isfinite(y0) && isfinite(y1) && isfinite(y2) &&
                      isfinite(q0) && isfinite(q1) && isfinite(q2);
  int st = lam1 >= sc.lam_max ? kBudget : kActive;
  if (rb >= sc.r_escape) st = kEscaped;
  if (rb <= sc.r_capture) st = kCaptured;
  if (!finite) st = kError;
  const SegEvents ev = segment_events<KERR, DISK, SPH, GUARD>(
      sc, sph, n_sph, r.x0, r.x1, r.x2, y0, y1, y2, rb);
  if (SPH && ev.sid >= 0) st = kObject;
  if (DISK && ev.disk && ev.t_disk <= ev.t_sph) st = kDisk;
  if (inside && finite) st = kCaptured;

  const float x0 = r.x0, x1 = r.x1, x2 = r.x2, lam0 = r.lam;
  if (finite) {
    r.x0 = y0; r.x1 = y1; r.x2 = y2;
    r.p0 = q0; r.p1 = q1; r.p2 = q2;
  }
  r.lam = lam1;
  r.status = st;
  if (SPH && st == kObject) {
    const float ts = ev.t_sph;
    r.x0 = lerp_rn(x0, y0, ts);
    r.x1 = lerp_rn(x1, y1, ts);
    r.x2 = lerp_rn(x2, y2, ts);
    r.lam = __fadd_rn(lam0, __fmul_rn(dt, ts));
    r.obj = ev.sid;
  }
  if (DISK && st == kDisk) {
    r.x0 = ev.d0;
    r.x1 = ev.d1;
    r.x2 = 0.0f;
    r.lam = __fadd_rn(lam0, __fmul_rn(dt, ev.t_disk));
  }
}

// One RK4 step of an ACTIVE ray with endpoint classification, the segment
// events and the freeze merge (classify_merge).  The step size reads the
// radius r.rad, which the caller sets before the first step and
// classify_merge after each.  Kerr: a step one of whose stage points lies
// within half the capture radius has crossed the horizon and captures the
// ray, wherever its endpoint lands: there, towards the ring singularity,
// a stage's right-hand side is so large that the endpoint can land
// outside again with a state no photon has; a photon's own step from
// outside the horizon does not reach that deep (ops/integrate.py
// `_fixed_step`).
template <int PMODE, bool KERR, bool DISK, bool SPH, bool GUARD>
__device__ __forceinline__ void rk4_step(const Scalars& sc, float power,
                                         float E,
                                         const float* __restrict__ sph,
                                         int n_sph, Ray& r) {
  const float h = step_size<PMODE>(sc, power, r.rad);

  float ka[6], kb[6], kc[6], kd[6];
  rhs<KERR>(sc, E, r.x0, r.x1, r.x2, r.p0, r.p1, r.p2, ka);
  const float c = 0.5f * h;
  rhs<KERR>(sc, E, r.x0 + c * ka[0], r.x1 + c * ka[1], r.x2 + c * ka[2],
            r.p0 + c * ka[3], r.p1 + c * ka[4], r.p2 + c * ka[5], kb);
  rhs<KERR>(sc, E, r.x0 + c * kb[0], r.x1 + c * kb[1], r.x2 + c * kb[2],
            r.p0 + c * kb[3], r.p1 + c * kb[4], r.p2 + c * kb[5], kc);
  rhs<KERR>(sc, E, r.x0 + h * kc[0], r.x1 + h * kc[1], r.x2 + h * kc[2],
            r.p0 + h * kc[3], r.p1 + h * kc[4], r.p2 + h * kc[5], kd);
  const float s6 = h * (1.0f / 6.0f);
  const float y0 = r.x0 + s6 * (ka[0] + 2.0f * (kb[0] + kc[0]) + kd[0]);
  const float y1 = r.x1 + s6 * (ka[1] + 2.0f * (kb[1] + kc[1]) + kd[1]);
  const float y2 = r.x2 + s6 * (ka[2] + 2.0f * (kb[2] + kc[2]) + kd[2]);
  const float q0 = r.p0 + s6 * (ka[3] + 2.0f * (kb[3] + kc[3]) + kd[3]);
  const float q1 = r.p1 + s6 * (ka[4] + 2.0f * (kb[4] + kc[4]) + kd[4]);
  const float q2 = r.p2 + s6 * (ka[5] + 2.0f * (kb[5] + kc[5]) + kd[5]);
  bool inside = false;
  if constexpr (KERR) {
    const float deep = 0.5f * sc.r_capture;
    inside = ks_radius(sc.spin, r.x0 + c * ka[0], r.x1 + c * ka[1],
                       r.x2 + c * ka[2]) <= deep ||
             ks_radius(sc.spin, r.x0 + c * kb[0], r.x1 + c * kb[1],
                       r.x2 + c * kb[2]) <= deep ||
             ks_radius(sc.spin, r.x0 + h * kc[0], r.x1 + h * kc[1],
                       r.x2 + h * kc[2]) <= deep;
  }
  classify_merge<KERR, DISK, SPH, GUARD>(sc, sph, n_sph, h, y0, y1, y2, q0,
                                         q1, q2, r, inside);
}

// ---------------------------------------------------------------------------
// The adjoint (ops/adjoint.py is its plain PyTorch statement).
// ---------------------------------------------------------------------------

// VJP of rhs_schw at (a, b) for the output cotangent g: writes the
// cotangent of (a, b) to gab and adds those of E and the mass to gE, gm.
__device__ __forceinline__ void rhs_schw_vjp(float mass, float E,
                                             const float y[6],
                                             const float g[6], float gab[6],
                                             float& gE, float& gm) {
  const float a0 = y[0], a1 = y[1], a2 = y[2];
  const float b0 = y[3], b1 = y[4], b2 = y[5];
  const float rr = a0 * a0 + a1 * a1 + a2 * a2;
  const float inv_r = rsqrtf(fmaxf(rr, kR2Floor));
  const float inv_r2 = inv_r * inv_r;
  const float n0 = a0 * inv_r, n1 = a1 * inv_r, n2 = a2 * inv_r;
  const float u = (2.0f * mass) * inv_r;
  const float s = n0 * b0 + n1 * b1 + n2 * b2;
  const float w = E + s;
  const float uw = u * w;
  const float m_r2 = mass * inv_r2;
  const float cp = 2.0f * m_r2 * w;
  const float cn = m_r2 * w * (w + 2.0f * s);

  // kx = b - uw n,  kp = cp b - cn n
  float gb0 = g[0] + cp * g[3], gb1 = g[1] + cp * g[4],
        gb2 = g[2] + cp * g[5];
  const float g_uw = -(g[0] * n0 + g[1] * n1 + g[2] * n2);
  const float g_cp = g[3] * b0 + g[4] * b1 + g[5] * b2;
  const float g_cn = -(g[3] * n0 + g[4] * n1 + g[5] * n2);
  float gn0 = -uw * g[0] - cn * g[3];
  float gn1 = -uw * g[1] - cn * g[4];
  float gn2 = -uw * g[2] - cn * g[5];
  // cp = 2 m_r2 w,  cn = m_r2 w (w + 2 s),  uw = u w
  const float g_mr2 = 2.0f * w * g_cp + w * (w + 2.0f * s) * g_cn;
  const float g_w =
      2.0f * m_r2 * g_cp + m_r2 * (2.0f * w + 2.0f * s) * g_cn + u * g_uw;
  const float g_s = 2.0f * m_r2 * w * g_cn + g_w;  // w = E + s
  const float g_u = w * g_uw;
  gE += g_w;
  // s = n . b
  gn0 += g_s * b0; gn1 += g_s * b1; gn2 += g_s * b2;
  gb0 += g_s * n0; gb1 += g_s * n1; gb2 += g_s * n2;
  // m_r2 = mass inv_r^2,  u = 2 mass inv_r,  n = a inv_r
  gm += inv_r2 * g_mr2 + 2.0f * inv_r * g_u;
  const float g_inv_r = 2.0f * mass * g_u + 2.0f * inv_r * (mass * g_mr2) +
                        gn0 * a0 + gn1 * a1 + gn2 * a2;
  // inv_r = rsqrt(max(rr, floor)): no gradient to a below the floor
  const float g_rr = rr > kR2Floor ? -0.5f * inv_r * inv_r2 * g_inv_r : 0.0f;
  gab[0] = inv_r * gn0 + 2.0f * a0 * g_rr;
  gab[1] = inv_r * gn1 + 2.0f * a1 * g_rr;
  gab[2] = inv_r * gn2 + 2.0f * a2 * g_rr;
  gab[3] = gb0;
  gab[4] = gb1;
  gab[5] = gb2;
}

// VJP of rhs_kerr at (a, b) for the output cotangent g (ops/adjoint.py
// rhs_kerr_vjp, line for line, but for 1/r, formed once and multiplied
// where that divides by r): writes the cotangent of (a, b) to gab and adds
// those of E, the mass and the spin to gE, gm, gsp.  dw_i is taken as
// C dr_i + e_i; no gradient passes below the r^2 and r S floors.
__device__ __forceinline__ void rhs_kerr_vjp(float mass, float spin, float E,
                                             const float y[6],
                                             const float g[6], float gab[6],
                                             float& gE, float& gm,
                                             float& gsp) {
  const float a0 = y[0], a1 = y[1], a2 = y[2];
  const float b0 = y[3], b1 = y[4], b2 = y[5];
  // --- forward ---
  const float s2 = spin * spin;
  const float rho2 = a0 * a0 + a1 * a1 + a2 * a2;
  const float bq = rho2 - s2;
  const float S = sqrtf(bq * bq + 4.0f * s2 * a2 * a2);
  const float r2raw = 0.5f * (bq + S);
  const float r2 = fmaxf(r2raw, kR2Floor);
  const float r = sqrtf(r2);
  const float inv_r = 1.0f / r;
  const float rS = r * S;
  const float inv_rS = 1.0f / fmaxf(rS, kR2Floor);
  const float az = s2 * a2;
  const float dr0 = r2 * a0 * inv_rS;
  const float dr1 = r2 * a1 * inv_rS;
  const float dr2 = (r2 * a2 + az) * inv_rS;
  const float inv_A = 1.0f / (r2 + s2);
  const float n0 = r * a0 + spin * a1;
  const float n1 = r * a1 - spin * a0;
  const float l0 = n0 * inv_A, l1 = n1 * inv_A, l2 = a2 * inv_r;
  const float D = r2 * r2 + az * a2;
  const float inv_D = 1.0f / D;
  const float inv_D2 = inv_D * inv_D;
  const float H = mass * r * r2 * inv_D;
  const float w = E + l0 * b0 + l1 * b1 + l2 * b2;
  const float q = 2.0f * H;
  const float P = 3.0f * r2 * D - 4.0f * r2 * r2 * r2;
  const float hcoef = mass * P * inv_D2;
  const float K = 2.0f * mass * az * r * r2 * inv_D2;
  const float dH0 = hcoef * dr0, dH1 = hcoef * dr1, dH2 = hcoef * dr2 - K;
  const float twoR_A2 = 2.0f * r * inv_A * inv_A;
  const float inv_r2 = 1.0f / r2;
  const float C = (b0 * a0 + b1 * a1) * inv_A -
                  (b0 * n0 + b1 * n1) * twoR_A2 - b2 * a2 * inv_r2;
  const float dw0 = C * dr0 + (b0 * r - b1 * spin) * inv_A;
  const float dw1 = C * dr1 + (b0 * spin + b1 * r) * inv_A;
  const float dw2 = C * dr2 + b2 * inv_r;
  const float w2 = w * w, qw = q * w;

  // --- reverse ---
  // kx = b - qw l,  kp = w2 dH + qw dw
  const float g_qw = -(g[0] * l0 + g[1] * l1 + g[2] * l2) + g[3] * dw0 +
                     g[4] * dw1 + g[5] * dw2;
  const float g_w2 = g[3] * dH0 + g[4] * dH1 + g[5] * dH2;
  float gb0 = g[0], gb1 = g[1], gb2 = g[2];
  float gl0 = -qw * g[0], gl1 = -qw * g[1], gl2 = -qw * g[2];
  const float gdH0 = w2 * g[3], gdH1 = w2 * g[4], gdH2 = w2 * g[5];
  const float gdw0 = qw * g[3], gdw1 = qw * g[4], gdw2 = qw * g[5];
  // w2 = w^2,  qw = q w
  const float g_w = 2.0f * w * g_w2 + q * g_qw;
  const float g_q = w * g_qw;
  // dw_i = C dr_i + e_i
  const float g_C = gdw0 * dr0 + gdw1 * dr1 + gdw2 * dr2;
  float gdr0 = gdw0 * C, gdr1 = gdw1 * C, gdr2 = gdw2 * C;
  float g_invA = gdw0 * (b0 * r - b1 * spin) + gdw1 * (b0 * spin + b1 * r);
  float g_r = (gdw0 * b0 + gdw1 * b1) * inv_A - gdw2 * b2 * inv_r2;
  float g_spin = (gdw1 * b0 - gdw0 * b1) * inv_A;
  gb0 = gb0 + (gdw0 * r + gdw1 * spin) * inv_A;
  gb1 = gb1 + (gdw1 * r - gdw0 * spin) * inv_A;
  gb2 = gb2 + gdw2 * inv_r;
  // C = (b0 a0 + b1 a1) inv_A - (b0 n0 + b1 n1) twoR_A2 - b2 a2 inv_r2
  gb0 = gb0 + g_C * (a0 * inv_A - n0 * twoR_A2);
  gb1 = gb1 + g_C * (a1 * inv_A - n1 * twoR_A2);
  gb2 = gb2 - g_C * a2 * inv_r2;
  float ga0 = g_C * b0 * inv_A, ga1 = g_C * b1 * inv_A;
  float ga2 = -g_C * b2 * inv_r2;
  g_invA = g_invA + g_C * (b0 * a0 + b1 * a1);
  float gn0 = -g_C * b0 * twoR_A2, gn1 = -g_C * b1 * twoR_A2;
  const float g_twoR = -g_C * (b0 * n0 + b1 * n1);
  const float g_invr2 = -g_C * b2 * a2;
  // dH_i = hcoef dr_i (dH2 - K)
  const float g_hcoef = gdH0 * dr0 + gdH1 * dr1 + gdH2 * dr2;
  gdr0 = gdr0 + gdH0 * hcoef;
  gdr1 = gdr1 + gdH1 * hcoef;
  gdr2 = gdr2 + gdH2 * hcoef;
  // K = 2 M az r r2 inv_D^2
  const float g_K = -gdH2;
  float g_mass = g_K * 2.0f * az * r * r2 * inv_D2;
  float g_az = g_K * 2.0f * mass * r * r2 * inv_D2;
  g_r = g_r + g_K * 2.0f * mass * az * r2 * inv_D2;
  float g_r2 = g_K * 2.0f * mass * az * r * inv_D2;
  float g_invD = g_K * 4.0f * mass * az * r * r2 * inv_D;
  // hcoef = M P inv_D^2,  P = 3 r2 D - 4 r2^3
  g_mass = g_mass + g_hcoef * P * inv_D2;
  const float g_P = g_hcoef * mass * inv_D2;
  g_invD = g_invD + g_hcoef * mass * P * 2.0f * inv_D;
  g_r2 = g_r2 + g_P * (3.0f * D - 12.0f * r2 * r2);
  float g_D = g_P * 3.0f * r2;
  // q = 2 H,  w = E + l.b
  const float g_H = 2.0f * g_q;
  gE += g_w;
  gl0 = gl0 + g_w * b0;
  gl1 = gl1 + g_w * b1;
  gl2 = gl2 + g_w * b2;
  gb0 = gb0 + g_w * l0;
  gb1 = gb1 + g_w * l1;
  gb2 = gb2 + g_w * l2;
  // H = M r r2 inv_D
  g_mass = g_mass + g_H * r * r2 * inv_D;
  g_r = g_r + g_H * mass * r2 * inv_D;
  g_r2 = g_r2 + g_H * mass * r * inv_D;
  g_invD = g_invD + g_H * mass * r * r2;
  // inv_D = 1 / D,  D = r2^2 + az a2
  g_D = g_D - g_invD * inv_D2;
  g_r2 = g_r2 + g_D * 2.0f * r2;
  g_az = g_az + g_D * a2;
  ga2 = ga2 + g_D * az;
  // l0 = n0 inv_A,  l1 = n1 inv_A,  l2 = a2 / r
  gn0 = gn0 + gl0 * inv_A;
  gn1 = gn1 + gl1 * inv_A;
  g_invA = g_invA + gl0 * n0 + gl1 * n1;
  ga2 = ga2 + gl2 * inv_r;
  g_r = g_r - gl2 * l2 * inv_r;
  // n0 = r a0 + a a1,  n1 = r a1 - a a0
  g_r = g_r + gn0 * a0 + gn1 * a1;
  ga0 = ga0 + gn0 * r - gn1 * spin;
  ga1 = ga1 + gn0 * spin + gn1 * r;
  g_spin = g_spin + gn0 * a1 - gn1 * a0;
  // twoR_A2 = 2 r inv_A^2,  inv_r2 = 1 / r2
  g_r = g_r + g_twoR * 2.0f * inv_A * inv_A;
  g_invA = g_invA + g_twoR * 4.0f * r * inv_A;
  g_r2 = g_r2 - g_invr2 * inv_r2 * inv_r2;
  // inv_A = 1 / A,  A = r2 + a^2
  const float g_A = -g_invA * inv_A * inv_A;
  g_r2 = g_r2 + g_A;
  float g_s2 = g_A;
  // dr0 = r2 a0 inv_rS,  dr1 = r2 a1 inv_rS,  dr2 = (r2 a2 + az) inv_rS
  g_r2 = g_r2 + (gdr0 * a0 + gdr1 * a1 + gdr2 * a2) * inv_rS;
  ga0 = ga0 + gdr0 * r2 * inv_rS;
  ga1 = ga1 + gdr1 * r2 * inv_rS;
  ga2 = ga2 + gdr2 * r2 * inv_rS;
  g_az = g_az + gdr2 * inv_rS;
  const float g_invrS =
      gdr0 * r2 * a0 + gdr1 * r2 * a1 + gdr2 * (r2 * a2 + az);
  // az = a^2 a2
  g_s2 = g_s2 + g_az * a2;
  ga2 = ga2 + g_az * s2;
  // inv_rS = 1 / max(r S, floor): no gradient below the floor
  const float g_rS = rS > kR2Floor ? -g_invrS * inv_rS * inv_rS : 0.0f;
  g_r = g_r + g_rS * S;
  float g_S = g_rS * r;
  // r = sqrt(r2)
  g_r2 = g_r2 + 0.5f * g_r * inv_r;
  // r2 = max((bq + S) / 2, floor): no gradient below the floor
  if (!(r2raw > kR2Floor)) g_r2 = 0.0f;
  float g_bq = 0.5f * g_r2;
  g_S = g_S + 0.5f * g_r2;
  // S = sqrt(bq^2 + 4 a^2 a2^2); S = 0 only on the ring singularity
  const float g_Sq = S > 0.0f ? 0.5f * g_S / S : 0.0f;
  g_bq = g_bq + 2.0f * bq * g_Sq;
  g_s2 = g_s2 + 4.0f * a2 * a2 * g_Sq;
  ga2 = ga2 + 8.0f * s2 * a2 * g_Sq;
  // bq = rho2 - a^2,  rho2 = a.a,  s2 = a^2
  g_s2 = g_s2 - g_bq;
  gab[0] = ga0 + 2.0f * a0 * g_bq;
  gab[1] = ga1 + 2.0f * a1 * g_bq;
  gab[2] = ga2 + 2.0f * a2 * g_bq;
  gab[3] = gb0;
  gab[4] = gb1;
  gab[5] = gb2;
  gm += g_mass;
  gsp += g_spin + 2.0f * spin * g_s2;
}

// The VJP of the spacetime KERR selects; gsp gets nothing without spin.
template <bool KERR>
__device__ __forceinline__ void rhs_vjp(const Scalars& sc, float E,
                                        const float y[6], const float g[6],
                                        float gab[6], float& gE, float& gm,
                                        float& gsp) {
  if (KERR) {
    rhs_kerr_vjp(sc.mass, sc.spin, E, y, g, gab, gE, gm, gsp);
  } else {
    rhs_schw_vjp(sc.mass, E, y, g, gab, gE, gm);
  }
}

// VJP of step_size for an ACTIVE ray: adds the cotangent of x to gx and
// those of dt, boost and r_ref to gs[1..3] and, for KERR, the spin's to
// gs[4].  The Kerr-Schild radius has dr/dx_i = (r^2 x_i + a^2 z delta_i2)
// / (r S) and dr/da = a (z^2 - r^2) / (r S) (pallas_kernel.py:87-88).
template <int PMODE, bool KERR>
__device__ __forceinline__ void step_size_vjp(const Scalars& sc, float power,
                                              float x0, float x1, float x2,
                                              float gh, float gx[6],
                                              float gs[5]) {
  float kr2 = 0.0f, kS = 0.0f;
  if (KERR) {
    const float rho2 = x0 * x0 + x1 * x1 + x2 * x2;
    const float bq = rho2 - sc.spin * sc.spin;
    kS = sqrtf(bq * bq + 4.0f * sc.spin * sc.spin * x2 * x2);
    kr2 = 0.5f * (bq + kS);
  }
  // the radius and schedule of step_size, so the clip's sides agree with
  // the forward's
  const float ra = radius<KERR>(sc, x0, x1, x2);
  const float ratio = div_rn(ra, sc.r_ref, sc.inv_r_ref);
  const float rp = schedule<PMODE>(ratio, power);
  const float lo = fmaxf(rp, 1.0f);
  const float c = fminf(lo, sc.boost);
  const float g_c = gh * sc.dt;
  gs[1] += gh * c;
  if (lo > sc.boost) gs[2] += g_c;
  if (rp > 1.0f && lo < sc.boost) {
    // inside the clip, so ratio > 1 and every derivative below is finite
    float drp = 1.0f;
    if (PMODE == 1) {
      const float sq = sqrtf(ratio);
      drp = sq + 0.5f * ratio / sq;
    } else if (PMODE == 2) {
      drp = 2.0f * ratio;
    } else if (PMODE == 3) {
      drp = power * powf(ratio, power - 1.0f);
    }
    const float g_ratio = g_c * drp;
    const float g_ra = g_ratio / sc.r_ref;
    gs[3] += -g_ratio * ratio / sc.r_ref;
    if (KERR) {
      const float den = ra * kS;
      if (kr2 > kR2Floor && den > 0.0f) {
        const float k = g_ra / den;
        gx[0] += k * kr2 * x0;
        gx[1] += k * kr2 * x1;
        gx[2] += k * (kr2 * x2 + sc.spin * sc.spin * x2);
        gs[4] += k * sc.spin * (x2 * x2 - kr2);
      }
    } else {
      const float k = g_ra / ra;
      gx[0] += k * x0;
      gx[1] += k * x1;
      gx[2] += k * x2;
    }
  }
}

// Transpose of the position merge of an ACTIVE, finite step x -> y
// (ops/adjoint.py events_vjp): g is the cotangent of the merged x'; writes
// the cotangents of the pre-step x to gx and of the endpoint y to gy, and,
// for a sphere entry, adds those of the entered sphere's [cx, cy, cz, r]
// to gsph and sets hit = its index.  Only the selected event carries a
// cotangent.
//   disk:   x' = (x + D t, 0), t = -x2 / D2, D = y - x;
//           dt/dx2 = (t - 1) / D2, dt/dy2 = -t / D2 (D2 != 0: it crossed)
//   sphere: x' = x + D t, t = (-bb - sq) / (2 aa), aa = D.D, bb = 2 o.D,
//           cc = o.o - r^2, o = x - c; dt/daa = (cc / sq - t) / aa,
//           dt/dbb = -(1 + bb / sq) / (2 aa), dt/dcc = 1 / sq
template <bool DISK, bool SPH>
__device__ __forceinline__ void events_vjp(const Scalars& sc,
                                           const float* __restrict__ sph,
                                           int n_sph, const float x[3],
                                           const float y[3], const float g[3],
                                           float gx[3], float gy[3],
                                           float gsph[4], int& hit) {
  // no guard: the endpoint radius is not read
  const SegEvents ev = segment_events<false, DISK, SPH, false>(
      sc, sph, n_sph, x[0], x[1], x[2], y[0], y[1], y[2], 0.0f);
  const bool sel_disk = DISK && ev.disk && ev.t_disk <= ev.t_sph;
  const bool sel_sph = SPH && ev.sid >= 0 && !sel_disk;
  const float D[3] = {y[0] - x[0], y[1] - x[1], y[2] - x[2]};
  if (sel_disk) {
    const float t = ev.t_disk;
    const float gt = g[0] * D[0] + g[1] * D[1];
    gx[0] = (1.0f - t) * g[0];
    gx[1] = (1.0f - t) * g[1];
    gy[0] = t * g[0];
    gy[1] = t * g[1];
    gx[2] = gt * (t - 1.0f) / D[2];
    gy[2] = -gt * t / D[2];
  } else if (sel_sph) {
    const int k = ev.sid;
    const float t = ev.t_sph;
    const float rad = __ldg(sph + 4 * k + 3);
    const float o[3] = {x[0] - __ldg(sph + 4 * k), x[1] - __ldg(sph + 4 * k + 1),
                        x[2] - __ldg(sph + 4 * k + 2)};
    const float gt = g[0] * D[0] + g[1] * D[1] + g[2] * D[2];
    const float aa = D[0] * D[0] + D[1] * D[1] + D[2] * D[2];
    const float bb = 2.0f * (o[0] * D[0] + o[1] * D[1] + o[2] * D[2]);
    const float cc = o[0] * o[0] + o[1] * o[1] + o[2] * o[2] - rad * rad;
    const float sq = sqrtf(bb * bb - 4.0f * aa * cc);
    const float g_aa = gt * (cc / sq - t) / aa;
    const float g_bb = -gt * (1.0f + bb / sq) / (2.0f * aa);
    const float g_cc = gt / sq;
    for (int i = 0; i < 3; ++i) {
      const float gD = 2.0f * g_aa * D[i] + 2.0f * g_bb * o[i];
      const float go = 2.0f * g_bb * D[i] + 2.0f * g_cc * o[i];
      gx[i] = (1.0f - t) * g[i] - gD + go;
      gy[i] = t * g[i] + gD;
      gsph[i] -= go;
    }
    gsph[3] -= 2.0f * rad * g_cc;
    hit = k;
  } else {
    for (int i = 0; i < 3; ++i) {
      gx[i] = 0.0f;
      gy[i] = g[i];
    }
  }
}

// Transpose of one rk4_step of an ACTIVE ray from the taped pre-step state
// y = (x, p).  g holds the cotangent of the step's (x', p') on entry and
// that of (x, p) on exit; the cotangents of E and of the scalars (mass, dt,
// boost, r_ref and, for KERR, the spin) are added to gE and gs[0..4], and a
// sphere entry adds the entered sphere's to gsph and sets hit (events_vjp).
// A step whose endpoint is not finite froze the ray (y' = y): g passes
// through and nothing is added.
//
// Stage i of the step (i = 0..3) evaluates the right-hand side at
// y + a_i h k_{i-1}, a = (0, 1/2, 1/2, 1), and the step adds h/6 w_i k_i,
// w = (1, 2, 2, 1).  Both the stage chain and its transpose are loops that
// are not unrolled, so the right-hand side and its VJP each have one call
// site: the code holds one copy of the (Kerr) VJP instead of four, and the
// stage values k_0, k_1 live in shared memory, `kbuf` (this thread's column
// of a [2][6][kThreads] block; column stride kThreads), not in registers.
// The stage chain computes what rk4_step computes, operation for operation.
template <int PMODE, bool KERR, bool DISK, bool SPH, int kThreads>
__device__ __forceinline__ void rk4_step_adjoint(
    const Scalars& sc, float power, float E, const float* __restrict__ sph,
    int n_sph, const float y[6], float g[6], float& gE, float gs[5],
    float gsph[4], int& hit, float* kbuf) {
  const float h =
      step_size<PMODE>(sc, power, radius<KERR>(sc, y[0], y[1], y[2]));
  const float c = 0.5f * h;

  // forward stage chain, as in rk4_step: k0, k1 to kbuf, k2 and k3 kept
  float k1[6], k2[6];   // k_{i-1} and k_{i-2} after stage i
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    float pt[6], k[6];
    const float a = i == 3 ? h : c;
#pragma unroll
    for (int q = 0; q < 6; ++q) pt[q] = i == 0 ? y[q] : y[q] + a * k1[q];
    rhs<KERR>(sc, E, pt[0], pt[1], pt[2], pt[3], pt[4], pt[5], k);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      if (i < 2) kbuf[(6 * i + q) * kThreads] = k[q];
      k2[q] = k1[q];
      k1[q] = k[q];
    }
  }
  // now k1 = k_3, k2 = k_2
  const float s6 = h * (1.0f / 6.0f);
  bool finite = true;
  float ks[6], yn[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    ks[q] = kbuf[q * kThreads] + 2.0f * (kbuf[(6 + q) * kThreads] + k2[q]) +
            k1[q];
    yn[q] = y[q] + s6 * ks[q];
    finite = finite && isfinite(yn[q]);
  }
  if (!finite) return;

  // transpose of the freeze and of the event points: gy to the RK4
  // endpoint, go to the pre-step state (momentum: the endpoint's)
  float gy[6], go[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < 6; ++q) gy[q] = g[q];
  if (DISK || SPH) {
    events_vjp<DISK, SPH>(sc, sph, n_sph, y, yn, g, go, gy, gsph, hit);
  }

  // transpose of the RK4 skeleton, stage 3 first: stage i's input
  // cotangent is h/6 w_i gy plus a_{i+1} h times stage i+1's output
  float gh = 0.0f;
#pragma unroll
  for (int q = 0; q < 6; ++q) gh += gy[q] * ks[q];
  gh *= 1.0f / 6.0f;
  float gm = 0.0f, gEs = 0.0f, gsp = 0.0f;
  float gk[6], gsum[6];
#pragma unroll 1
  for (int i = 3; i >= 0; --i) {
    float km[6], pt[6], gin[6];   // k_{i-1}, stage input, its cotangent
    const float a = i == 3 ? h : c;
    const float w = (i == 0 || i == 3) ? s6 : 2.0f * s6;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      km[q] = i == 3 ? k2[q] : (i > 0 ? kbuf[(6 * (i - 1) + q) * kThreads]
                                      : 0.0f);
      pt[q] = i == 0 ? y[q] : y[q] + a * km[q];
      gin[q] = w * gy[q];
      if (i < 3) gin[q] = gin[q] + (i == 2 ? h : c) * gk[q];
    }
    rhs_vjp<KERR>(sc, E, pt, gin, gk, gEs, gm, gsp);
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      gsum[q] = i == 3 ? gk[q] : gsum[q] + gk[q];
      acc += gk[q] * km[q];
    }
    if (i > 0) gh += i == 3 ? acc : 0.5f * acc;
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) g[q] = (gy[q] + gsum[q]) + go[q];
  gE += gEs;
  gs[0] += gm;
  if (KERR) gs[4] += gsp;

  // transpose of the per-ray step size
  step_size_vjp<PMODE, KERR>(sc, power, y[0], y[1], y[2], gh, g, gs);
}

}  // namespace
