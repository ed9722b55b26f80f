// One adaptive Dormand-Prince 5(4) trip and its exact adjoint, shared by
// the forward kernel (dopri_fwd.cu), the checkpointing forward
// (dopri_ckpt.cu) and the adjoint (dopri_bwd.cu).
//
// The trip is `_dopri_trip` of blackhole_geodesic_calculator_tpu/ops/
// pallas_kernel.py (:390-470): the embedded step of length h from the ray's
// state (scipy's RK45 tableau), its scaled RMS error, accept if the error
// is at most 1 or h is at most min_step, the classification, events and
// freeze merge of an accepted step (classify_merge of rk4_step.cuh, so the
// two integrators classify alike), and the 0.2-power controller's next h,
// clip(h clip(0.9 errn^-0.2, 0.2, 5), min_step, max_step), for a ray still
// ACTIVE.  A trip is one attempt: a rejected one only shrinks h.  The
// controller's constants are runtime arguments (Controller); the spacetime
// and the events are the compile-time switches of rk4_step.cuh.
//
// The adjoint is the transpose of the trip derived by hand, what the TPU
// kernel takes with a whole-trip `jax.vjp` (`_dopri_trip_adjoint`,
// :702-746); its plain PyTorch statement, line for line, is
// `dopri_trip_vjp` of ops/adjoint.py, which the CPU tests hold against
// JAX.  Accept, reject and the event selectors are decisions; the
// controller is differentiated, so the cotangent of the next h reaches the
// state through the error norm, on a rejected trip too.

#pragma once

#include "rk4_step.cuh"

namespace {

// The step controller's constants (`rtol`, `atol`, `min_step`, `max_step`
// of the IntegratorConfig; an infinite max_step comes as 1e30).
struct Controller {
  float rtol, atol, min_step, max_step;
};

// The Dormand-Prince tableau, each coefficient the float nearest to the
// rational (as the plain path rounds Python's doubles): a_ij, the
// fifth-order weights b_i and the error weights e_i = b_i - b*_i.
#define BHGC_DP_A                                                            \
  {{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},                                     \
   {float(1.0 / 5.0), 0.0f, 0.0f, 0.0f, 0.0f, 0.0f},                         \
   {float(3.0 / 40.0), float(9.0 / 40.0), 0.0f, 0.0f, 0.0f, 0.0f},           \
   {float(44.0 / 45.0), float(-56.0 / 15.0), float(32.0 / 9.0), 0.0f, 0.0f,  \
    0.0f},                                                                   \
   {float(19372.0 / 6561.0), float(-25360.0 / 2187.0),                       \
    float(64448.0 / 6561.0), float(-212.0 / 729.0), 0.0f, 0.0f},             \
   {float(9017.0 / 3168.0), float(-355.0 / 33.0), float(46732.0 / 5247.0),   \
    float(49.0 / 176.0), float(-5103.0 / 18656.0), 0.0f},                    \
   {float(35.0 / 384.0), 0.0f, float(500.0 / 1113.0), float(125.0 / 192.0), \
    float(-2187.0 / 6784.0), float(11.0 / 84.0)}}
#define BHGC_DP_B                                                            \
  {float(35.0 / 384.0), 0.0f, float(500.0 / 1113.0), float(125.0 / 192.0),   \
   float(-2187.0 / 6784.0), float(11.0 / 84.0), 0.0f}
#define BHGC_DP_E                                                            \
  {float(35.0 / 384.0 - 5179.0 / 57600.0), 0.0f,                             \
   float(500.0 / 1113.0 - 7571.0 / 16695.0),                                 \
   float(125.0 / 192.0 - 393.0 / 640.0),                                     \
   float(-2187.0 / 6784.0 - -92097.0 / 339200.0),                            \
   float(11.0 / 84.0 - 187.0 / 2100.0), float(0.0 - 1.0 / 40.0)}

__host__ __device__ constexpr float dp_a(int i, int j) {
  constexpr float a[7][6] = BHGC_DP_A;
  return a[i][j];
}

__host__ __device__ constexpr float dp_b(int i) {
  constexpr float b[7] = BHGC_DP_B;
  return b[i];
}

__host__ __device__ constexpr float dp_e(int i) {
  constexpr float e[7] = BHGC_DP_E;
  return e[i];
}

// The same tableau for loops over the stages that are not unrolled, which
// index it at run time (a warp reads one entry: the constant cache
// broadcasts it).
__constant__ float kDpA[7][6] = BHGC_DP_A;
__constant__ float kDpB[7] = BHGC_DP_B;
__constant__ float kDpE[7] = BHGC_DP_E;

// a_ij, b_i, e_i from the constant tables when the stage loop runs (TABLE)
// or as constants the unrolled code folds.
template <bool TABLE>
__device__ __forceinline__ float tab_a(int i, int j) {
  if constexpr (TABLE) return kDpA[i][j]; else return dp_a(i, j);
}
template <bool TABLE>
__device__ __forceinline__ float tab_b(int i) {
  if constexpr (TABLE) return kDpB[i]; else return dp_b(i);
}
template <bool TABLE>
__device__ __forceinline__ float tab_e(int i) {
  if constexpr (TABLE) return kDpE[i]; else return dp_e(i);
}

// Six 6-vectors of one thread: in shared memory (SMEM, this thread's
// column of a [36][kThreads] block, so a warp's accesses fall in 32 banks)
// or in registers, which the unrolled stage code indexes with constants.
template <bool SMEM, int kThreads>
struct StageSlots {
  float* col;
  float reg[SMEM ? 1 : 36];
  __device__ __forceinline__ float& operator()(int i, int c) {
    if constexpr (SMEM) return col[(6 * i + c) * kThreads];
    else return reg[6 * i + c];
  }
};

// Stage point i of the trip from y with step dt: y + sum_j (dt a_ij) k_j,
// summed in j order as `_dopri_trip` does.
__device__ __forceinline__ void stage_point(const float y[6], float dt, int i,
                                            const float k[7][6],
                                            float pt[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) pt[c] = y[c];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    if (j < i && dp_a(i, j) != 0.0f) {
      const float s = dt * dp_a(i, j);
#pragma unroll
      for (int c = 0; c < 6; ++c) pt[c] = pt[c] + s * k[j][c];
    }
  }
}

// The seven stages k_0..k_6 of the trip from y with step dt.
template <bool KERR>
__device__ __forceinline__ void dopri_stages(const Scalars& sc, float E,
                                             const float y[6], float dt,
                                             float k[7][6]) {
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    float pt[6];
    stage_point(y, dt, i, k, pt);
    rhs<KERR>(sc, E, pt[0], pt[1], pt[2], pt[3], pt[4], pt[5], k[i]);
  }
}

// The weighted sums c5 = sum_i b_i k_i and ce = sum_i e_i k_i.
__device__ __forceinline__ void dopri_combine(const float k[7][6],
                                              float c5[6], float ce[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    float s5 = 0.0f, se = 0.0f;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      if (dp_b(i) != 0.0f) s5 = s5 + dp_b(i) * k[i][c];
      if (dp_e(i) != 0.0f) se = se + dp_e(i) * k[i][c];
    }
    c5[c] = s5;
    ce[c] = se;
  }
}

// The scale of component c of the error norm: atol + rtol max(|y|, |y5|).
__device__ __forceinline__ float err_scale(const Controller& ctl, float y,
                                           float y5) {
  return ctl.atol + ctl.rtol * fmaxf(fabsf(y), fabsf(y5));
}

// The controller's factor clip(0.9 errn^-0.2, 0.2, 5); 0.9 (1e-10)^-0.2 = 90
// clipped to 5 where errn = 0.
__device__ __forceinline__ float step_factor(float errn) {
  const float u = 0.9f * powf(errn > 0.0f ? errn : 1e-10f, -0.2f);
  return fminf(fmaxf(u, 0.2f), 5.0f);
}

// One Dormand-Prince trip of an ACTIVE ray r with step h: on acceptance the
// ray moves (classify_merge: classification, events, freeze), and if it is
// still ACTIVE after the trip h becomes the controller's next step.  GUARD
// as for rk4_step: the sphere guard, which changes no result.
template <bool KERR, bool DISK, bool SPH, bool GUARD>
__device__ __forceinline__ void dopri_trip(const Scalars& sc,
                                           const Controller& ctl, float E,
                                           const float* __restrict__ sph,
                                           int n_sph, Ray& r, float& h) {
  const float y[6] = {r.x0, r.x1, r.x2, r.p0, r.p1, r.p2};
  float k[7][6], c5[6], ce[6], y5[6];
  dopri_stages<KERR>(sc, E, y, h, k);
  dopri_combine(k, c5, ce);
  float err2 = 0.0f;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    y5[c] = y[c] + h * c5[c];
    const float e = (h * ce[c]) / err_scale(ctl, y[c], y5[c]);
    err2 = err2 + e * e;
  }
  err2 = err2 * (1.0f / 6.0f);
  const float errn = err2 > 0.0f ? sqrtf(err2) : 0.0f;
  if (errn <= 1.0f || h <= ctl.min_step) {
    classify_merge<KERR, DISK, SPH, GUARD>(sc, sph, n_sph, h, y5[0], y5[1],
                                           y5[2], y5[3], y5[4], y5[5], r);
  }
  if (r.status == kActive) {
    h = fminf(fmaxf(h * step_factor(errn), ctl.min_step), ctl.max_step);
  }
}

// d max(a, b) / d a as jax.vjp takes it: 1, 1/2 at a tie, 0.
__device__ __forceinline__ float dmax(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// d min(a, b) / d a: 1, 1/2 at a tie, 0.
__device__ __forceinline__ float dmin(float a, float b) {
  return a < b ? 1.0f : (a == b ? 0.5f : 0.0f);
}

// d|v|/dv as jax.vjp takes it: +1 at v = 0.
__device__ __forceinline__ float dabs(float v) {
  return v >= 0.0f ? 1.0f : -1.0f;
}

// Transpose of one dopri_trip of an ACTIVE ray from the taped pre-trip
// state y = (x, p), step h and affine parameter lam (ops/adjoint.py
// dopri_trip_vjp; the stages' cotangents gathered per stage, below).  g and
// gh hold the cotangents of the trip's (x', p') and h' on entry and those
// of (x, p) and h on exit; the cotangents of E, the mass and (KERR) the
// spin are added to gE, gs[0] and gs[1], and a sphere entry adds the
// entered sphere's to gsph and sets hit (events_vjp).  A trip whose step is
// not finite leaves the state and h as they were or makes them NaN: g and
// gh pass through, nothing is added.
//
// The seven stages are a loop, and so are their transposes.  For KERR the
// loops are not unrolled, so the Kerr right-hand side and its VJP each have
// one call site (one copy of the Kerr VJP in the code, not seven), and the
// stage values k_0..k_5 and the stages' input cotangents live in shared
// memory (`kbuf`, `gbuf`: this thread's columns of two [36][kThreads]
// blocks).  The Schwarzschild right-hand side is small: its loops are
// unrolled and those values stay in registers.  Stage i's cotangent is
// gathered when it is transposed, b_i g_c5 + e_i g_ce + dt sum_{l > i}
// a_li g_l (g_l the cotangent of stage l's input), and the step's
// cotangent gains k_i . sum_l a_li g_l.  The stage chain computes what
// dopri_stages and dopri_combine compute, operation for operation, so the
// trip's accept and events are the recompute's.
template <bool KERR, bool DISK, bool SPH, int kThreads>
__device__ __forceinline__ void dopri_trip_adjoint(
    const Scalars& sc, const Controller& ctl, float E,
    const float* __restrict__ sph, int n_sph, const float y[6], float h,
    float lam, float g[6], float& gh, float& gE, float gs[2], float gsph[4],
    int& hit, float* kbuf, float* gbuf) {
  // --- forward, as in dopri_trip ---
  const float dt = h;
  StageSlots<KERR, kThreads> k{kbuf}, gin{gbuf};
  float c5[6], ce[6], y5[6], scale[6], r[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    c5[c] = 0.0f;
    ce[c] = 0.0f;
  }
#pragma unroll(KERR ? 1 : 7)
  for (int i = 0; i < 7; ++i) {
    float pt[6], ki[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) pt[c] = y[c];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float a = tab_a<KERR>(i, j);
      if (j < i && a != 0.0f) {
        const float s = dt * a;
#pragma unroll
        for (int c = 0; c < 6; ++c) pt[c] = pt[c] + s * k(j, c);
      }
    }
    rhs<KERR>(sc, E, pt[0], pt[1], pt[2], pt[3], pt[4], pt[5], ki);
    const float b = tab_b<KERR>(i), e = tab_e<KERR>(i);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      if (i < 6) k(i, c) = ki[c];
      if (b != 0.0f) c5[c] = c5[c] + b * ki[c];
      if (e != 0.0f) ce[c] = ce[c] + e * ki[c];
    }
  }
  float err2 = 0.0f;
  bool finite = true;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    y5[c] = y[c] + dt * c5[c];
    finite = finite && isfinite(y5[c]);
    scale[c] = err_scale(ctl, y[c], y5[c]);
    r[c] = (dt * ce[c]) / scale[c];
    err2 = err2 + r[c] * r[c];
  }
  if (!finite) return;
  err2 = err2 * (1.0f / 6.0f);
  const float errn = err2 > 0.0f ? sqrtf(err2) : 0.0f;
  const bool accept = errn <= 1.0f || h <= ctl.min_step;
  bool h_active = true;   // a rejected trip leaves the ray ACTIVE
  if (accept) {
    Ray q;
    q.x0 = y[0]; q.x1 = y[1]; q.x2 = y[2];
    q.p0 = y[3]; q.p1 = y[4]; q.p2 = y[5];
    q.lam = lam;
    q.status = kActive;
    q.obj = -1;
    classify_merge<KERR, DISK, SPH, false>(sc, sph, n_sph, dt, y5[0], y5[1],
                                           y5[2], y5[3], y5[4], y5[5], q);
    h_active = q.status == kActive;
  }

  // --- the controller: h' = min(max(h f, min_step), max_step),
  //     f = min(max(u, 0.2), 5), u = 0.9 errg^-0.2, errg = errn or 1e-10 ---
  const float errg = errn > 0.0f ? errn : 1e-10f;
  const float u = 0.9f * powf(errg, -0.2f);
  const float u1 = fmaxf(u, 0.2f);
  const float f = fminf(u1, 5.0f);
  const float v = h * f;
  const float v1 = fmaxf(v, ctl.min_step);
  const float g_v =
      h_active ? gh * dmin(v1, ctl.max_step) * dmax(v, ctl.min_step) : 0.0f;
  float g_h = h_active ? g_v * f : gh;
  const float g_u = g_v * h * dmin(u1, 5.0f) * dmax(u, 0.2f);
  const float g_errn =
      errn > 0.0f ? g_u * 0.9f * (-0.2f * powf(errg, -1.2f)) : 0.0f;

  // --- the state: x' = merge(y, y5) if accepted, else y ---
  float g_y[6], g_y5[6];
  if (accept) {
    float gx_old[3], gy5[3];
    if (DISK || SPH) {
      events_vjp<DISK, SPH>(sc, sph, n_sph, y, y5, g, gx_old, gy5, gsph, hit);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        gx_old[c] = 0.0f;
        gy5[c] = g[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      g_y[c] = gx_old[c];
      g_y[c + 3] = 0.0f;
      g_y5[c] = gy5[c];
      g_y5[c + 3] = g[c + 3];
    }
  } else {
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      g_y[c] = g[c];
      g_y5[c] = 0.0f;
    }
  }

  // --- the error norm: errn = sqrt(err2), err2 = 1/6 sum_c r_c^2,
  //     r_c = e_c / s_c, e_c = dt ce_c, s_c = atol + rtol max(|y|, |y5|) ---
  const float g_err2 = err2 > 0.0f ? g_errn * (0.5f / errn) : 0.0f;
  float g_dt = 0.0f, g_ce[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float g_r = g_err2 * (1.0f / 6.0f) * 2.0f * r[c];
    const float g_e = g_r / scale[c];
    const float g_m = -g_r * r[c] / scale[c] * ctl.rtol;
    const float a = fabsf(y[c]), b = fabsf(y5[c]);
    g_y[c] += g_m * dmax(a, b) * dabs(y[c]);
    g_y5[c] += g_m * dmax(b, a) * dabs(y5[c]);
    g_dt += g_e * ce[c];
    g_ce[c] = g_e * dt;
  }

  // --- y5 = y + dt c5 ---
  float g_c5[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    g_y[c] += g_y5[c];
    g_dt += g_y5[c] * c5[c];
    g_c5[c] = dt * g_y5[c];
  }

  // --- the stages, last first: k_i = rhs(Y_i), Y_i = y + sum_j dt a_ij k_j;
  //     gin(l - 1) holds the cotangent of Y_l, l = 1..6 ---
  float gm = 0.0f, gsp = 0.0f, gEs = 0.0f;
#pragma unroll(KERR ? 1 : 7)
  for (int i = 6; i >= 0; --i) {
    float sum[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // sum_l a_li g_l
#pragma unroll
    for (int l = 1; l < 7; ++l) {
      const float a = l > i ? tab_a<KERR>(l, i < 6 ? i : 0) : 0.0f;
      if (a != 0.0f) {
#pragma unroll
        for (int c = 0; c < 6; ++c) sum[c] = sum[c] + a * gin(l - 1, c);
      }
    }
    const float b = tab_b<KERR>(i), e = tab_e<KERR>(i);
    float g_k[6], pt[6], g_pt[6];
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      g_k[c] = b * g_c5[c] + e * g_ce[c] + dt * sum[c];
      if (i < 6) dot += k(i, c) * sum[c];
      pt[c] = y[c];
    }
    g_dt += dot;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float a = tab_a<KERR>(i, j);
      if (j < i && a != 0.0f) {
        const float s = dt * a;
#pragma unroll
        for (int c = 0; c < 6; ++c) pt[c] = pt[c] + s * k(j, c);
      }
    }
    rhs_vjp<KERR>(sc, E, pt, g_k, g_pt, gEs, gm, gsp);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      g_y[c] += g_pt[c];
      if (i > 0) gin(i - 1, c) = g_pt[c];
    }
  }
  g_h += g_dt;   // dt = h for a live ray

#pragma unroll
  for (int c = 0; c < 6; ++c) g[c] = g_y[c];
  gh = g_h;
  gE += gEs;
  gs[0] += gm;
  if (KERR) gs[1] += gsp;
}

}  // namespace
