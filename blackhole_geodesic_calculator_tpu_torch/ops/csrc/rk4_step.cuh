// One fixed RK4 geodesic step and its exact adjoint, shared by the
// forward kernel (rk4_fwd.cu), the checkpointing forward (rk4_ckpt.cu) and
// the adjoint (rk4_bwd.cu), so the three run the same step code.
//
// The step is `_soa_step` of blackhole_geodesic_calculator_tpu/ops/
// pallas_kernel.py in its Schwarzschild, event-free variant: the per-ray
// step size of `_dt_soa`, four evaluations of `_rhs_schw_soa` and the
// endpoint classification of `_events_merge`.  The adjoint is
// `_step_adjoint` (pallas_kernel.py:1025-1153); its plain PyTorch statement,
// line for line, is ops/adjoint.py, which the CPU tests hold against JAX.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kActive = 0;
constexpr int kCaptured = 1;
constexpr int kEscaped = 2;
constexpr int kBudget = 3;
constexpr int kError = 7;

constexpr int kNScal = 10;
constexpr float kR2Floor = 1e-12f;

// Scalar vector layout (NSCAL = 10), the TPU kernel's:
// [mass, dt, dt_boost, r_ref, r_capture, r_escape, lam_max, r_in, r_out, a]
struct Scalars {
  float mass, dt, boost, r_ref, r_capture, r_escape, lam_max;
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
  return sc;
}

// One ray's state in registers.
struct Ray {
  float x0, x1, x2, p0, p1, p2, lam;
  int status;
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

// Per-ray step size dt * clip((r / r_ref)^power, 1, boost) (_dt_soa).
// PMODE: 0 -> power 1, 1 -> power 1.5 (sqrt form), 2 -> power 2,
// 3 -> general power.
template <int PMODE>
__device__ __forceinline__ float step_size(const Scalars& sc, float power,
                                           float x0, float x1, float x2) {
  const float ra = sqrtf(x0 * x0 + x1 * x1 + x2 * x2);
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

// One RK4 step of an ACTIVE ray with endpoint classification and the
// freeze merge (never store a non-finite state).
template <int PMODE>
__device__ __forceinline__ void rk4_step(const Scalars& sc, float power,
                                         float E, Ray& r) {
  const float h = step_size<PMODE>(sc, power, r.x0, r.x1, r.x2);

  float ka[6], kb[6], kc[6], kd[6];
  rhs_schw(sc.mass, E, r.x0, r.x1, r.x2, r.p0, r.p1, r.p2, ka);
  const float c = 0.5f * h;
  rhs_schw(sc.mass, E, r.x0 + c * ka[0], r.x1 + c * ka[1], r.x2 + c * ka[2],
           r.p0 + c * ka[3], r.p1 + c * ka[4], r.p2 + c * ka[5], kb);
  rhs_schw(sc.mass, E, r.x0 + c * kb[0], r.x1 + c * kb[1], r.x2 + c * kb[2],
           r.p0 + c * kb[3], r.p1 + c * kb[4], r.p2 + c * kb[5], kc);
  rhs_schw(sc.mass, E, r.x0 + h * kc[0], r.x1 + h * kc[1], r.x2 + h * kc[2],
           r.p0 + h * kc[3], r.p1 + h * kc[4], r.p2 + h * kc[5], kd);
  const float s6 = h * (1.0f / 6.0f);
  const float y0 = r.x0 + s6 * (ka[0] + 2.0f * (kb[0] + kc[0]) + kd[0]);
  const float y1 = r.x1 + s6 * (ka[1] + 2.0f * (kb[1] + kc[1]) + kd[1]);
  const float y2 = r.x2 + s6 * (ka[2] + 2.0f * (kb[2] + kc[2]) + kd[2]);
  const float q0 = r.p0 + s6 * (ka[3] + 2.0f * (kb[3] + kc[3]) + kd[3]);
  const float q1 = r.p1 + s6 * (ka[4] + 2.0f * (kb[4] + kc[4]) + kd[4]);
  const float q2 = r.p2 + s6 * (ka[5] + 2.0f * (kb[5] + kc[5]) + kd[5]);

  // Endpoint classification, lowest priority first (_events_merge).
  const float rb = sqrtf(y0 * y0 + y1 * y1 + y2 * y2);
  const float lam1 = r.lam + h;
  const bool finite = isfinite(y0) && isfinite(y1) && isfinite(y2) &&
                      isfinite(q0) && isfinite(q1) && isfinite(q2);
  int st = lam1 >= sc.lam_max ? kBudget : kActive;
  if (rb >= sc.r_escape) st = kEscaped;
  if (rb <= sc.r_capture) st = kCaptured;
  if (!finite) st = kError;

  if (finite) {
    r.x0 = y0; r.x1 = y1; r.x2 = y2;
    r.p0 = q0; r.p1 = q1; r.p2 = q2;
  }
  r.lam = lam1;
  r.status = st;
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

// VJP of step_size for an ACTIVE ray: adds the cotangent of x to gx and
// those of dt, boost and r_ref to gs[1..3].
template <int PMODE>
__device__ __forceinline__ void step_size_vjp(const Scalars& sc, float power,
                                              float x0, float x1, float x2,
                                              float gh, float gx[6],
                                              float gs[4]) {
  const float ra = sqrtf(x0 * x0 + x1 * x1 + x2 * x2);
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
    const float k = g_ra / ra;
    gx[0] += k * x0;
    gx[1] += k * x1;
    gx[2] += k * x2;
  }
}

// Transpose of one rk4_step of an ACTIVE ray from the taped pre-step state
// y = (x, p).  g holds the cotangent of the step's (x', p') on entry and
// that of (x, p) on exit; the cotangents of E and of the scalars (mass, dt,
// boost, r_ref) are added to gE and gs.  A step whose endpoint is not
// finite froze the ray (y' = y): g passes through and nothing is added.
template <int PMODE>
__device__ __forceinline__ void rk4_step_adjoint(const Scalars& sc,
                                                 float power, float E,
                                                 const float y[6], float g[6],
                                                 float& gE, float gs[4]) {
  const float h = step_size<PMODE>(sc, power, y[0], y[1], y[2]);

  // forward stage chain, as in rk4_step
  float ka[6], kb[6], kc[6], kd[6], pt[6];
  rhs_schw(sc.mass, E, y[0], y[1], y[2], y[3], y[4], y[5], ka);
  const float c = 0.5f * h;
  for (int i = 0; i < 6; ++i) pt[i] = y[i] + c * ka[i];
  rhs_schw(sc.mass, E, pt[0], pt[1], pt[2], pt[3], pt[4], pt[5], kb);
  for (int i = 0; i < 6; ++i) pt[i] = y[i] + c * kb[i];
  rhs_schw(sc.mass, E, pt[0], pt[1], pt[2], pt[3], pt[4], pt[5], kc);
  for (int i = 0; i < 6; ++i) pt[i] = y[i] + h * kc[i];
  rhs_schw(sc.mass, E, pt[0], pt[1], pt[2], pt[3], pt[4], pt[5], kd);
  const float s6 = h * (1.0f / 6.0f);
  bool finite = true;
  for (int i = 0; i < 6; ++i) {
    const float ks = ka[i] + 2.0f * (kb[i] + kc[i]) + kd[i];
    finite = finite && isfinite(y[i] + s6 * ks);
  }
  if (!finite) return;

  // transpose of the RK4 skeleton; gy = g (the freeze passes it on whole)
  float gh = 0.0f;
  for (int i = 0; i < 6; ++i)
    gh += g[i] * (ka[i] + 2.0f * (kb[i] + kc[i]) + kd[i]);
  gh *= 1.0f / 6.0f;
  float gm = 0.0f, gEs = 0.0f;
  float gin[6], gd[6], gc[6], gb[6], ga[6];
  // stage d (input y + h kc)
  for (int i = 0; i < 6; ++i) {
    pt[i] = y[i] + h * kc[i];
    gin[i] = s6 * g[i];
  }
  rhs_schw_vjp(sc.mass, E, pt, gin, gd, gEs, gm);
  float acc = 0.0f;
  for (int i = 0; i < 6; ++i) acc += gd[i] * kc[i];
  gh += acc;
  // stage c (input y + h/2 kb)
  for (int i = 0; i < 6; ++i) {
    pt[i] = y[i] + c * kb[i];
    gin[i] = 2.0f * s6 * g[i] + h * gd[i];
  }
  rhs_schw_vjp(sc.mass, E, pt, gin, gc, gEs, gm);
  acc = 0.0f;
  for (int i = 0; i < 6; ++i) acc += gc[i] * kb[i];
  gh += 0.5f * acc;
  // stage b (input y + h/2 ka)
  for (int i = 0; i < 6; ++i) {
    pt[i] = y[i] + c * ka[i];
    gin[i] = 2.0f * s6 * g[i] + 0.5f * h * gc[i];
  }
  rhs_schw_vjp(sc.mass, E, pt, gin, gb, gEs, gm);
  acc = 0.0f;
  for (int i = 0; i < 6; ++i) acc += gb[i] * ka[i];
  gh += 0.5f * acc;
  // stage a (input y)
  for (int i = 0; i < 6; ++i) gin[i] = s6 * g[i] + 0.5f * h * gb[i];
  rhs_schw_vjp(sc.mass, E, y, gin, ga, gEs, gm);
  for (int i = 0; i < 6; ++i) g[i] += gd[i] + gc[i] + gb[i] + ga[i];
  gE += gEs;
  gs[0] += gm;

  // transpose of the per-ray step size
  step_size_vjp<PMODE>(sc, power, y[0], y[1], y[2], gh, g, gs);
}

}  // namespace
