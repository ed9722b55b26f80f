// One fixed RK4 geodesic step and its exact adjoint, shared by the
// forward kernel (rk4_fwd.cu), the checkpointing forward (rk4_ckpt.cu) and
// the adjoint (rk4_bwd.cu), so the three run the same step code.
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
// with the sphere guard's band widened by |a| (:249-265).
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

// Scalar vector layout (NSCAL = 10), the TPU kernel's:
// [mass, dt, dt_boost, r_ref, r_capture, r_escape, lam_max, r_in, r_out, a]
struct Scalars {
  float mass, dt, boost, r_ref, r_capture, r_escape, lam_max, r_in, r_out,
      spin;
};

__device__ __forceinline__ Scalars load_scalars(const float* scal) {
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
  return sc;
}

// One ray's state in registers.
struct Ray {
  float x0, x1, x2, p0, p1, p2, lam;
  int status, obj;
};

// Schwarzschild Kerr-Schild Hamiltonian right-hand side (geodesic.py
// schwarzschild_rhs / pallas_kernel.py _rhs_schw_soa), state (a, b) = (x, p).
__device__ __forceinline__ void rhs_schw(float mass, float E, float a0,
                                         float a1, float a2, float b0,
                                         float b1, float b2, float k[6]) {
  const float r2 = fmaxf(a0 * a0 + a1 * a1 + a2 * a2, kR2Floor);
  const float inv_r = rsqrtf(r2);
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
// _rhs_kerr_soa, line for line; ops/geodesic.py kerr_rhs_soa), spin a.
// sqrtf and the divisions stay IEEE-rounded (no --use_fast_math).
__device__ __forceinline__ void rhs_kerr(float mass, float spin, float E,
                                         float a0, float a1, float a2,
                                         float b0, float b1, float b2,
                                         float k[6]) {
  const float rho2 = a0 * a0 + a1 * a1 + a2 * a2;
  const float bq = rho2 - spin * spin;
  const float S = sqrtf(bq * bq + 4.0f * spin * spin * a2 * a2);
  const float r2 = fmaxf(0.5f * (bq + S), kR2Floor);
  const float r = sqrtf(r2);
  const float inv_rS = 1.0f / fmaxf(r * S, kR2Floor);
  const float az = spin * spin * a2;
  const float dr0 = r2 * a0 * inv_rS;
  const float dr1 = r2 * a1 * inv_rS;
  const float dr2 = (r2 * a2 + az) * inv_rS;

  const float A = r2 + spin * spin;
  const float inv_A = 1.0f / A;
  const float l0 = (r * a0 + spin * a1) * inv_A;
  const float l1 = (r * a1 - spin * a0) * inv_A;
  const float l2 = a2 / r;
  const float D = r2 * r2 + az * a2;
  const float inv_D = 1.0f / D;
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
  const float n0 = r * a0 + spin * a1;
  const float n1 = r * a1 - spin * a0;
  const float inv_r2 = 1.0f / r2;
  const float dw0 = b0 * ((dr0 * a0 + r) * inv_A - n0 * twoR_A2 * dr0) +
                    b1 * ((dr0 * a1 - spin) * inv_A - n1 * twoR_A2 * dr0) +
                    b2 * (-a2 * dr0 * inv_r2);
  const float dw1 = b0 * ((dr1 * a0 + spin) * inv_A - n0 * twoR_A2 * dr1) +
                    b1 * ((dr1 * a1 + r) * inv_A - n1 * twoR_A2 * dr1) +
                    b2 * (-a2 * dr1 * inv_r2);
  const float dw2 = b0 * (dr2 * a0 * inv_A - n0 * twoR_A2 * dr2) +
                    b1 * (dr2 * a1 * inv_A - n1 * twoR_A2 * dr2) +
                    b2 * (1.0f / r - a2 * dr2 * inv_r2);

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

// Kerr-Schild radius with r^2 floored at 1e-12 (_ks_radius_soa).
__device__ __forceinline__ float ks_radius(float spin, float x0, float x1,
                                           float x2) {
  const float rho2 = x0 * x0 + x1 * x1 + x2 * x2;
  const float bq = rho2 - spin * spin;
  const float r2 =
      0.5f * (bq + sqrtf(bq * bq + 4.0f * spin * spin * x2 * x2));
  return sqrtf(fmaxf(r2, kR2Floor));
}

// The step-size and endpoint radius: Euclidean, or Kerr-Schild for KERR.
template <bool KERR>
__device__ __forceinline__ float radius(const Scalars& sc, float x0,
                                        float x1, float x2) {
  return KERR ? ks_radius(sc.spin, x0, x1, x2)
              : sqrtf(x0 * x0 + x1 * x1 + x2 * x2);
}

// Per-ray step size dt * clip((r / r_ref)^power, 1, boost) (_dt_soa).
// PMODE: 0 -> power 1, 1 -> power 1.5 (sqrt form), 2 -> power 2,
// 3 -> general power.
template <int PMODE, bool KERR>
__device__ __forceinline__ float step_size(const Scalars& sc, float power,
                                           float x0, float x1, float x2) {
  const float ra = radius<KERR>(sc, x0, x1, x2);
  float ratio = ra / sc.r_ref;
  if (PMODE == 1) {
    ratio = ratio * sqrtf(fmaxf(ratio, 0.0f));
  } else if (PMODE == 2) {
    ratio = ratio * ratio;
  } else if (PMODE == 3) {
    ratio = powf(fmaxf(ratio, 1e-20f), power);
  }
  return sc.dt * fminf(fmaxf(ratio, 1.0f), sc.boost);
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

constexpr float kInf = std::numeric_limits<float>::infinity();

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
  if (DISK) {
    const bool crossed = (y2 < 0.0f && x2 >= 0.0f) || (y2 > 0.0f && x2 <= 0.0f);
    const float denom = y2 - x2;
    const float t = -x2 / (fabsf(denom) > 0.0f ? denom : 1.0f);
    ev.d0 = lerp_rn(x0, y0, t);
    ev.d1 = lerp_rn(x1, y1, t);
    const float rr = sqrtf(ev.d0 * ev.d0 + ev.d1 * ev.d1);
    ev.disk = crossed && rr >= sc.r_in && rr <= sc.r_out;
    if (ev.disk) ev.t_disk = t;
  }
  ev.sid = -1;
  ev.t_sph = kInf;
  if (SPH) {
    const float dx0 = y0 - x0, dx1 = y1 - x1, dx2 = y2 - x2;
    const float aa = dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
    if (GUARD) {
      const float L = sqrtf(aa);
      const float rb_hi = KERR ? rb + fabsf(sc.spin) : rb;
      bool possible = false;
      for (int k = 0; k < n_sph; ++k) {
        const float cx = __ldg(sph + 4 * k), cy = __ldg(sph + 4 * k + 1);
        const float cz = __ldg(sph + 4 * k + 2), rad = __ldg(sph + 4 * k + 3);
        const float ck = sqrtf(cx * cx + cy * cy + cz * cz);
        possible = possible || (rb - L <= ck + rad && rb_hi + L >= ck - rad);
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
      // the guarded sqrt of integrate._sphere_events
      const float sq = sqrtf(disc > 0.0f ? disc : 1.0f);
      const float t = (-bb - sq) / denom_a;
      // a later sphere must come strictly earlier: ties go to the lowest k
      if (disc > 0.0f && t >= 0.0f && t <= 1.0f && t < ev.t_sph) {
        ev.t_sph = t;
        ev.sid = k;
      }
    }
  }
  return ev;
}

// One RK4 step of an ACTIVE ray with endpoint classification, the segment
// events and the freeze merge (never store a non-finite state; an event
// ray freezes at the interpolated event point).
template <int PMODE, bool KERR, bool DISK, bool SPH, bool GUARD>
__device__ __forceinline__ void rk4_step(const Scalars& sc, float power,
                                         float E,
                                         const float* __restrict__ sph,
                                         int n_sph, Ray& r) {
  const float h = step_size<PMODE, KERR>(sc, power, r.x0, r.x1, r.x2);

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

  // Endpoint classification, lowest priority first (_events_merge); a
  // sphere entry overrides it, and a disk crossing no later on the segment
  // overrides that.
  const float rb = radius<KERR>(sc, y0, y1, y2);
  // not fused with h = dt * clip(...): kernels that fuse differently would
  // part in the last bit of lam
  const float lam1 = __fadd_rn(r.lam, h);
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
    r.lam = __fadd_rn(lam0, __fmul_rn(h, ts));
    r.obj = ev.sid;
  }
  if (DISK && st == kDisk) {
    r.x0 = ev.d0;
    r.x1 = ev.d1;
    r.x2 = 0.0f;
    r.lam = __fadd_rn(lam0, __fmul_rn(h, ev.t_disk));
  }
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
// rhs_kerr_vjp, line for line): writes the cotangent of (a, b) to gab and
// adds those of E, the mass and the spin to gE, gm, gsp.  dw_i is taken as
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
  const float rS = r * S;
  const float inv_rS = 1.0f / fmaxf(rS, kR2Floor);
  const float az = s2 * a2;
  const float dr0 = r2 * a0 * inv_rS;
  const float dr1 = r2 * a1 * inv_rS;
  const float dr2 = (r2 * a2 + az) * inv_rS;
  const float inv_A = 1.0f / (r2 + s2);
  const float n0 = r * a0 + spin * a1;
  const float n1 = r * a1 - spin * a0;
  const float l0 = n0 * inv_A, l1 = n1 * inv_A, l2 = a2 / r;
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
  const float dw2 = C * dr2 + b2 / r;
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
  gb2 = gb2 + gdw2 / r;
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
  ga2 = ga2 + gl2 / r;
  g_r = g_r - gl2 * l2 / r;
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
  g_r2 = g_r2 + 0.5f * g_r / r;
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
  float ra, kr2 = 0.0f, kS = 0.0f;
  if (KERR) {
    const float rho2 = x0 * x0 + x1 * x1 + x2 * x2;
    const float bq = rho2 - sc.spin * sc.spin;
    kS = sqrtf(bq * bq + 4.0f * sc.spin * sc.spin * x2 * x2);
    kr2 = 0.5f * (bq + kS);
    ra = sqrtf(fmaxf(kr2, kR2Floor));
  } else {
    ra = sqrtf(x0 * x0 + x1 * x1 + x2 * x2);
  }
  const float ratio = ra / sc.r_ref;
  float rp = ratio;
  if (PMODE == 1) {
    rp = ratio * sqrtf(fmaxf(ratio, 0.0f));
  } else if (PMODE == 2) {
    rp = ratio * ratio;
  } else if (PMODE == 3) {
    rp = powf(fmaxf(ratio, 1e-20f), power);
  }
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
template <int PMODE, bool KERR, bool DISK, bool SPH>
__device__ __forceinline__ void rk4_step_adjoint(
    const Scalars& sc, float power, float E, const float* __restrict__ sph,
    int n_sph, const float y[6], float g[6], float& gE, float gs[5],
    float gsph[4], int& hit) {
  const float h = step_size<PMODE, KERR>(sc, power, y[0], y[1], y[2]);

  // forward stage chain, as in rk4_step
  float ka[6], kb[6], kc[6], kd[6], pt[6];
  rhs<KERR>(sc, E, y[0], y[1], y[2], y[3], y[4], y[5], ka);
  const float c = 0.5f * h;
  for (int i = 0; i < 6; ++i) pt[i] = y[i] + c * ka[i];
  rhs<KERR>(sc, E, pt[0], pt[1], pt[2], pt[3], pt[4], pt[5], kb);
  for (int i = 0; i < 6; ++i) pt[i] = y[i] + c * kb[i];
  rhs<KERR>(sc, E, pt[0], pt[1], pt[2], pt[3], pt[4], pt[5], kc);
  for (int i = 0; i < 6; ++i) pt[i] = y[i] + h * kc[i];
  rhs<KERR>(sc, E, pt[0], pt[1], pt[2], pt[3], pt[4], pt[5], kd);
  const float s6 = h * (1.0f / 6.0f);
  bool finite = true;
  float yn[6];
  for (int i = 0; i < 6; ++i) {
    const float ks = ka[i] + 2.0f * (kb[i] + kc[i]) + kd[i];
    yn[i] = y[i] + s6 * ks;
    finite = finite && isfinite(yn[i]);
  }
  if (!finite) return;

  // transpose of the freeze and of the event points: gy to the RK4
  // endpoint, go to the pre-step state (momentum: the endpoint's)
  float gy[6], go[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 6; ++i) gy[i] = g[i];
  if (DISK || SPH) {
    events_vjp<DISK, SPH>(sc, sph, n_sph, y, yn, g, go, gy, gsph, hit);
  }

  // transpose of the RK4 skeleton
  float gh = 0.0f;
  for (int i = 0; i < 6; ++i)
    gh += gy[i] * (ka[i] + 2.0f * (kb[i] + kc[i]) + kd[i]);
  gh *= 1.0f / 6.0f;
  float gm = 0.0f, gEs = 0.0f, gsp = 0.0f;
  float gin[6], gd[6], gc[6], gb[6], ga[6];
  // stage d (input y + h kc)
  for (int i = 0; i < 6; ++i) {
    pt[i] = y[i] + h * kc[i];
    gin[i] = s6 * gy[i];
  }
  rhs_vjp<KERR>(sc, E, pt, gin, gd, gEs, gm, gsp);
  float acc = 0.0f;
  for (int i = 0; i < 6; ++i) acc += gd[i] * kc[i];
  gh += acc;
  // stage c (input y + h/2 kb)
  for (int i = 0; i < 6; ++i) {
    pt[i] = y[i] + c * kb[i];
    gin[i] = 2.0f * s6 * gy[i] + h * gd[i];
  }
  rhs_vjp<KERR>(sc, E, pt, gin, gc, gEs, gm, gsp);
  acc = 0.0f;
  for (int i = 0; i < 6; ++i) acc += gc[i] * kb[i];
  gh += 0.5f * acc;
  // stage b (input y + h/2 ka)
  for (int i = 0; i < 6; ++i) {
    pt[i] = y[i] + c * ka[i];
    gin[i] = 2.0f * s6 * gy[i] + 0.5f * h * gc[i];
  }
  rhs_vjp<KERR>(sc, E, pt, gin, gb, gEs, gm, gsp);
  acc = 0.0f;
  for (int i = 0; i < 6; ++i) acc += gb[i] * ka[i];
  gh += 0.5f * acc;
  // stage a (input y)
  for (int i = 0; i < 6; ++i) gin[i] = s6 * gy[i] + 0.5f * h * gb[i];
  rhs_vjp<KERR>(sc, E, y, gin, ga, gEs, gm, gsp);
  for (int i = 0; i < 6; ++i)
    g[i] = (gy[i] + (gd[i] + gc[i] + gb[i] + ga[i])) + go[i];
  gE += gEs;
  gs[0] += gm;
  if (KERR) gs[4] += gsp;

  // transpose of the per-ray step size
  step_size_vjp<PMODE, KERR>(sc, power, y[0], y[1], y[2], gh, g, gs);
}

}  // namespace
