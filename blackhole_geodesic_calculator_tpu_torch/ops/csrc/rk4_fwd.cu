// Forward fixed-step RK4 geodesic integrator for Hopper (sm_90a).
//
// CUDA counterpart of `_fwd_fast_kernel` in
// blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py (:1159-1198), in
// its Schwarzschild variants: event-free, and with the events of a z = 0
// disk and of K spheres (EV = 2 has_disk + (K > 0)).  The design note is in
// ops/cuda_kernel.py beside the wrapper; in short: one thread per ray, the
// whole state and the four RK4 stages in registers, ray state read from
// device memory once and written once, and a per-thread exit as soon as the
// thread's own ray leaves ACTIVE.  The step itself is rk4_step.cuh's, which
// the gradient kernels share.  The TPU kernel's tile-wide sphere guard is a
// per-ray skip of the K sphere quadratics here (segment_events with GUARD),
// conservative, so the states equal those without it bit for bit.
//
// Plain C interface (loaded with ctypes): `bhgc_rk4_fwd` launches on the
// given stream and returns cudaGetLastError() as an int.

#include "rk4_step.cuh"

namespace {

constexpr int kThreads = 256;

template <int PMODE, int EV>
__global__ void __launch_bounds__(kThreads)
    rk4_fwd_kernel(const float* __restrict__ scal,
                   const float* __restrict__ sph, int n_sph,
                   const float* __restrict__ x_in,
                   const float* __restrict__ p_in,
                   const float* __restrict__ E_in,
                   const float* __restrict__ lam_in,
                   const int* __restrict__ st_in,
                   const int* __restrict__ obj_in, float* __restrict__ x_out,
                   float* __restrict__ p_out, float* __restrict__ lam_out,
                   int* __restrict__ st_out, int* __restrict__ obj_out, int n,
                   int n_steps, float power) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const Scalars sc = load_scalars(scal);
  const long long j = 3LL * i;
  Ray r;
  r.x0 = x_in[j]; r.x1 = x_in[j + 1]; r.x2 = x_in[j + 2];
  r.p0 = p_in[j]; r.p1 = p_in[j + 1]; r.p2 = p_in[j + 2];
  r.lam = lam_in[i];
  r.status = st_in[i];
  r.obj = obj_in[i];
  const float E = E_in[i];

  // A ray that is not ACTIVE is an exact identity under the step (dt = 0,
  // no update, status kept), so each thread stops at its own ray's end.
  for (int step = 0; step < n_steps && r.status == kActive; ++step) {
    rk4_step<PMODE, (EV & 2) != 0, (EV & 1) != 0, true>(sc, power, E, sph,
                                                        n_sph, r);
  }

  x_out[j] = r.x0; x_out[j + 1] = r.x1; x_out[j + 2] = r.x2;
  p_out[j] = r.p0; p_out[j + 1] = r.p1; p_out[j + 2] = r.p2;
  lam_out[i] = r.lam;
  st_out[i] = r.status;
  obj_out[i] = r.obj;
}

}  // namespace

extern "C" int bhgc_rk4_fwd(const void* scal, const void* sph, int n_sph,
                            int has_disk, const void* x, const void* p,
                            const void* E, const void* lam, const void* st,
                            const void* obj, void* x_out, void* p_out,
                            void* lam_out, void* st_out, void* obj_out, int n,
                            int n_steps, float power, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  with_power_mode(power, [&](auto mode) {
    with_events(has_disk, n_sph, [&](auto ev) {
      rk4_fwd_kernel<decltype(mode)::value, decltype(ev)::value>
          <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const float*>(scal), static_cast<const float*>(sph),
              n_sph, static_cast<const float*>(x),
              static_cast<const float*>(p), static_cast<const float*>(E),
              static_cast<const float*>(lam), static_cast<const int*>(st),
              static_cast<const int*>(obj), static_cast<float*>(x_out),
              static_cast<float*>(p_out), static_cast<float*>(lam_out),
              static_cast<int*>(st_out), static_cast<int*>(obj_out), n,
              n_steps, power);
    });
  });
  return static_cast<int>(cudaGetLastError());
}
