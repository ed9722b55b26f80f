// One fixed RK4 geodesic step and its exact adjoint, shared by the
// forward kernel (rk4_fwd.cu), the checkpointing forward (rk4_ckpt.cu) and
// the adjoint (rk4_bwd.cu), so the three run the same step code.
//
// The step is `_soa_step` of blackhole_geodesic_calculator_tpu/ops/
// pallas_kernel.py in its Schwarzschild variants: the per-ray step size of
// `_dt_soa`, four evaluations of `_rhs_schw_soa` and `_events_merge`, the
// endpoint classification with, behind the compile-time switches DISK and
// SPH, the segment events of the z = 0 disk and of K spheres.  With both
// switches off the step is the event-free one, code and registers alike.
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
  float mass, dt, boost, r_ref, r_capture, r_escape, lam_max, r_in, r_out;
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

// The events of the segment x -> y; rb = |y|.  GUARD skips the K sphere
// quadratics when the segment cannot reach any sphere: every point of the
// segment lies within L = |y - x| of y, so sphere k (surface radii
// |c_k| -+ r_k) can be entered only if [rb - L, rb + L] meets
// [|c_k| - r_k, |c_k| + r_k].  The test is conservative, so the result is
// the same bit for bit with or without it (`guard_spheres`, :249-268).
template <bool DISK, bool SPH, bool GUARD>
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
      bool possible = false;
      for (int k = 0; k < n_sph; ++k) {
        const float cx = __ldg(sph + 4 * k), cy = __ldg(sph + 4 * k + 1);
        const float cz = __ldg(sph + 4 * k + 2), rad = __ldg(sph + 4 * k + 3);
        const float ck = sqrtf(cx * cx + cy * cy + cz * cz);
        possible = possible || (rb - L <= ck + rad && rb + L >= ck - rad);
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
template <int PMODE, bool DISK, bool SPH, bool GUARD>
__device__ __forceinline__ void rk4_step(const Scalars& sc, float power,
                                         float E,
                                         const float* __restrict__ sph,
                                         int n_sph, Ray& r) {
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

  // Endpoint classification, lowest priority first (_events_merge); a
  // sphere entry overrides it, and a disk crossing no later on the segment
  // overrides that.
  const float rb = sqrtf(y0 * y0 + y1 * y1 + y2 * y2);
  // not fused with h = dt * clip(...): kernels that fuse differently would
  // part in the last bit of lam
  const float lam1 = __fadd_rn(r.lam, h);
  const bool finite = isfinite(y0) && isfinite(y1) && isfinite(y2) &&
                      isfinite(q0) && isfinite(q1) && isfinite(q2);
  int st = lam1 >= sc.lam_max ? kBudget : kActive;
  if (rb >= sc.r_escape) st = kEscaped;
  if (rb <= sc.r_capture) st = kCaptured;
  if (!finite) st = kError;
  const SegEvents ev = segment_events<DISK, SPH, GUARD>(
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
  const float rb = sqrtf(y[0] * y[0] + y[1] * y[1] + y[2] * y[2]);
  const SegEvents ev = segment_events<DISK, SPH, false>(
      sc, sph, n_sph, x[0], x[1], x[2], y[0], y[1], y[2], rb);
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
// boost, r_ref) are added to gE and gs, and a sphere entry adds the entered
// sphere's to gsph and sets hit (events_vjp).  A step whose endpoint is not
// finite froze the ray (y' = y): g passes through and nothing is added.
template <int PMODE, bool DISK, bool SPH>
__device__ __forceinline__ void rk4_step_adjoint(
    const Scalars& sc, float power, float E, const float* __restrict__ sph,
    int n_sph, const float y[6], float g[6], float& gE, float gs[4],
    float gsph[4], int& hit) {
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
  float gm = 0.0f, gEs = 0.0f;
  float gin[6], gd[6], gc[6], gb[6], ga[6];
  // stage d (input y + h kc)
  for (int i = 0; i < 6; ++i) {
    pt[i] = y[i] + h * kc[i];
    gin[i] = s6 * gy[i];
  }
  rhs_schw_vjp(sc.mass, E, pt, gin, gd, gEs, gm);
  float acc = 0.0f;
  for (int i = 0; i < 6; ++i) acc += gd[i] * kc[i];
  gh += acc;
  // stage c (input y + h/2 kb)
  for (int i = 0; i < 6; ++i) {
    pt[i] = y[i] + c * kb[i];
    gin[i] = 2.0f * s6 * gy[i] + h * gd[i];
  }
  rhs_schw_vjp(sc.mass, E, pt, gin, gc, gEs, gm);
  acc = 0.0f;
  for (int i = 0; i < 6; ++i) acc += gc[i] * kb[i];
  gh += 0.5f * acc;
  // stage b (input y + h/2 ka)
  for (int i = 0; i < 6; ++i) {
    pt[i] = y[i] + c * ka[i];
    gin[i] = 2.0f * s6 * gy[i] + 0.5f * h * gc[i];
  }
  rhs_schw_vjp(sc.mass, E, pt, gin, gb, gEs, gm);
  acc = 0.0f;
  for (int i = 0; i < 6; ++i) acc += gb[i] * ka[i];
  gh += 0.5f * acc;
  // stage a (input y)
  for (int i = 0; i < 6; ++i) gin[i] = s6 * gy[i] + 0.5f * h * gb[i];
  rhs_schw_vjp(sc.mass, E, y, gin, ga, gEs, gm);
  for (int i = 0; i < 6; ++i)
    g[i] = (gy[i] + (gd[i] + gc[i] + gb[i] + ga[i])) + go[i];
  gE += gEs;
  gs[0] += gm;

  // transpose of the per-ray step size
  step_size_vjp<PMODE>(sc, power, y[0], y[1], y[2], gh, g, gs);
}

}  // namespace
