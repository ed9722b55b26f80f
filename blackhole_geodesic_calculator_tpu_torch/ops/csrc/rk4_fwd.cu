// Forward fixed-step RK4 geodesic integrator for Hopper (sm_90a).
//
// CUDA counterpart of `_fwd_fast_kernel` in
// blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py, in its
// Schwarzschild, event-free variant (no disk, no spheres).  The design note
// is in ops/cuda_kernel.py beside the wrapper; in short: one thread per ray,
// the whole state and the four RK4 stages in registers, ray state read from
// device memory once and written once, and a per-thread exit as soon as the
// thread's own ray leaves ACTIVE.
//
// Plain C interface (loaded with ctypes): `bhgc_rk4_fwd` launches on the
// given stream and returns cudaGetLastError() as an int.

#include <cuda_runtime.h>

namespace {

constexpr int kActive = 0;
constexpr int kCaptured = 1;
constexpr int kEscaped = 2;
constexpr int kBudget = 3;
constexpr int kError = 7;

constexpr int kThreads = 256;

// Scalar vector layout (NSCAL = 10), the TPU kernel's:
// [mass, dt, dt_boost, r_ref, r_capture, r_escape, lam_max, r_in, r_out, a]
struct Scalars {
  float mass, dt, boost, r_ref, r_capture, r_escape, lam_max;
};

// Schwarzschild Kerr-Schild Hamiltonian right-hand side (geodesic.py
// schwarzschild_rhs / pallas_kernel.py _rhs_schw_soa), state (a, b) = (x, p).
__device__ __forceinline__ void rhs_schw(float mass, float E, float a0,
                                         float a1, float a2, float b0,
                                         float b1, float b2, float k[6]) {
  const float r2 = fmaxf(a0 * a0 + a1 * a1 + a2 * a2, 1e-12f);
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

template <int PMODE>
__global__ void __launch_bounds__(kThreads)
    rk4_fwd_kernel(const float* __restrict__ scal,
                   const float* __restrict__ x_in,
                   const float* __restrict__ p_in,
                   const float* __restrict__ E_in,
                   const float* __restrict__ lam_in,
                   const int* __restrict__ st_in, float* __restrict__ x_out,
                   float* __restrict__ p_out, float* __restrict__ lam_out,
                   int* __restrict__ st_out, int n, int n_steps,
                   float power) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  Scalars sc;
  sc.mass = __ldg(scal + 0);
  sc.dt = __ldg(scal + 1);
  sc.boost = __ldg(scal + 2);
  sc.r_ref = __ldg(scal + 3);
  sc.r_capture = __ldg(scal + 4);
  sc.r_escape = __ldg(scal + 5);
  sc.lam_max = __ldg(scal + 6);

  const long long j = 3LL * i;
  float x0 = x_in[j], x1 = x_in[j + 1], x2 = x_in[j + 2];
  float p0 = p_in[j], p1 = p_in[j + 1], p2 = p_in[j + 2];
  const float E = E_in[i];
  float lam = lam_in[i];
  int status = st_in[i];

  // A ray that is not ACTIVE is an exact identity under the step (dt = 0,
  // no update, status kept), so each thread stops at its own ray's end.
  for (int step = 0; step < n_steps && status == kActive; ++step) {
    const float h = step_size<PMODE>(sc, power, x0, x1, x2);

    float ka[6], kb[6], kc[6], kd[6];
    rhs_schw(sc.mass, E, x0, x1, x2, p0, p1, p2, ka);
    const float c = 0.5f * h;
    rhs_schw(sc.mass, E, x0 + c * ka[0], x1 + c * ka[1], x2 + c * ka[2],
             p0 + c * ka[3], p1 + c * ka[4], p2 + c * ka[5], kb);
    rhs_schw(sc.mass, E, x0 + c * kb[0], x1 + c * kb[1], x2 + c * kb[2],
             p0 + c * kb[3], p1 + c * kb[4], p2 + c * kb[5], kc);
    rhs_schw(sc.mass, E, x0 + h * kc[0], x1 + h * kc[1], x2 + h * kc[2],
             p0 + h * kc[3], p1 + h * kc[4], p2 + h * kc[5], kd);
    const float s6 = h * (1.0f / 6.0f);
    const float y0 = x0 + s6 * (ka[0] + 2.0f * (kb[0] + kc[0]) + kd[0]);
    const float y1 = x1 + s6 * (ka[1] + 2.0f * (kb[1] + kc[1]) + kd[1]);
    const float y2 = x2 + s6 * (ka[2] + 2.0f * (kb[2] + kc[2]) + kd[2]);
    const float q0 = p0 + s6 * (ka[3] + 2.0f * (kb[3] + kc[3]) + kd[3]);
    const float q1 = p1 + s6 * (ka[4] + 2.0f * (kb[4] + kc[4]) + kd[4]);
    const float q2 = p2 + s6 * (ka[5] + 2.0f * (kb[5] + kc[5]) + kd[5]);

    // Endpoint classification, lowest priority first (_events_merge).
    const float rb = sqrtf(y0 * y0 + y1 * y1 + y2 * y2);
    const float lam1 = lam + h;
    const bool finite = isfinite(y0) && isfinite(y1) && isfinite(y2) &&
                        isfinite(q0) && isfinite(q1) && isfinite(q2);
    int st = lam1 >= sc.lam_max ? kBudget : kActive;
    if (rb >= sc.r_escape) st = kEscaped;
    if (rb <= sc.r_capture) st = kCaptured;
    if (!finite) st = kError;

    // Merge: never store a non-finite state.
    if (finite) {
      x0 = y0; x1 = y1; x2 = y2;
      p0 = q0; p1 = q1; p2 = q2;
    }
    lam = lam1;
    status = st;
  }

  x_out[j] = x0; x_out[j + 1] = x1; x_out[j + 2] = x2;
  p_out[j] = p0; p_out[j + 1] = p1; p_out[j + 2] = p2;
  lam_out[i] = lam;
  st_out[i] = status;
}

template <int PMODE>
void launch(const void* scal, const void* x, const void* p, const void* E,
            const void* lam, const void* st, void* x_out, void* p_out,
            void* lam_out, void* st_out, int n, int n_steps, float power,
            cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  rk4_fwd_kernel<PMODE><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(scal), static_cast<const float*>(x),
      static_cast<const float*>(p), static_cast<const float*>(E),
      static_cast<const float*>(lam), static_cast<const int*>(st),
      static_cast<float*>(x_out), static_cast<float*>(p_out),
      static_cast<float*>(lam_out), static_cast<int*>(st_out), n, n_steps,
      power);
}

}  // namespace

extern "C" int bhgc_rk4_fwd(const void* scal, const void* x, const void* p,
                            const void* E, const void* lam, const void* st,
                            void* x_out, void* p_out, void* lam_out,
                            void* st_out, int n, int n_steps, float power,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (power == 1.0f) {
    launch<0>(scal, x, p, E, lam, st, x_out, p_out, lam_out, st_out, n,
              n_steps, power, s);
  } else if (power == 1.5f) {
    launch<1>(scal, x, p, E, lam, st, x_out, p_out, lam_out, st_out, n,
              n_steps, power, s);
  } else if (power == 2.0f) {
    launch<2>(scal, x, p, E, lam, st, x_out, p_out, lam_out, st_out, n,
              n_steps, power, s);
  } else {
    launch<3>(scal, x, p, E, lam, st, x_out, p_out, lam_out, st_out, n,
              n_steps, power, s);
  }
  return static_cast<int>(cudaGetLastError());
}
