// Forward adaptive Dormand-Prince geodesic integrator for Hopper (sm_90a).
//
// CUDA counterpart of `_fwd_dopri_kernel` in
// blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py (:473-514), in its
// Schwarzschild and Kerr variants (KERR), each event-free and with the
// events of a z = 0 disk and of K spheres (EV = 2 has_disk + (K > 0)): the
// `kerr`, `has_disk` and `n_sph` of `_build_dopri` (:517-550).  One thread
// per ray keeps the state and its step h in registers and runs up to
// n_steps trips (attempts, accepted or rejected) of dopri_trip.cuh, exiting
// as soon as its own ray leaves ACTIVE: a frozen ray is an identity under a
// trip, so this equals the TPU kernel's 16-trip chunks skipped once the
// whole tile froze.  The sphere guard is on (`guard_spheres=True`, :502);
// it changes no result.
//
// Bound: the FP32 pipes and warp divergence, as rk4_fwd: a trip is seven
// right-hand sides, the error norm and a power, and a warp runs until its
// slowest ray ends, which for an adaptive ray is its own number of trips.
//
// Plain C interface (loaded with ctypes): `bhgc_dopri_fwd` launches on the
// given stream and returns cudaGetLastError() as an int.

#include "dopri_trip.cuh"

namespace {

constexpr int kThreads = 256;

template <bool KERR, int EV>
__global__ void __launch_bounds__(kThreads)
    dopri_fwd_kernel(const float* __restrict__ scal,
                     const float* __restrict__ sph, int n_sph,
                     const float* __restrict__ x_in,
                     const float* __restrict__ p_in,
                     const float* __restrict__ E_in,
                     const float* __restrict__ h_in,
                     const float* __restrict__ lam_in,
                     const int* __restrict__ st_in,
                     const int* __restrict__ obj_in,
                     float* __restrict__ x_out, float* __restrict__ p_out,
                     float* __restrict__ lam_out, int* __restrict__ st_out,
                     int* __restrict__ obj_out, int n, int n_steps,
                     Controller ctl) {
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
  float h = h_in[i];

  for (int trip = 0; trip < n_steps && r.status == kActive; ++trip) {
    dopri_trip<KERR, (EV & 2) != 0, (EV & 1) != 0, true>(sc, ctl, E, sph,
                                                         n_sph, r, h);
  }

  x_out[j] = r.x0; x_out[j + 1] = r.x1; x_out[j + 2] = r.x2;
  p_out[j] = r.p0; p_out[j + 1] = r.p1; p_out[j + 2] = r.p2;
  lam_out[i] = r.lam;
  st_out[i] = r.status;
  obj_out[i] = r.obj;
}

}  // namespace

extern "C" int bhgc_dopri_fwd(const void* scal, const void* sph, int n_sph,
                              int has_disk, int kerr, const void* x,
                              const void* p, const void* E, const void* h,
                              const void* lam, const void* st,
                              const void* obj, void* x_out, void* p_out,
                              void* lam_out, void* st_out, void* obj_out,
                              int n, int n_steps, float rtol, float atol,
                              float min_step, float max_step, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const Controller ctl{rtol, atol, min_step, max_step};
  with_kerr(kerr, [&](auto kr) {
    with_events(has_disk, n_sph, [&](auto ev) {
      dopri_fwd_kernel<decltype(kr)::value, decltype(ev)::value>
          <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const float*>(scal), static_cast<const float*>(sph),
              n_sph, static_cast<const float*>(x),
              static_cast<const float*>(p), static_cast<const float*>(E),
              static_cast<const float*>(h), static_cast<const float*>(lam),
              static_cast<const int*>(st), static_cast<const int*>(obj),
              static_cast<float*>(x_out), static_cast<float*>(p_out),
              static_cast<float*>(lam_out), static_cast<int*>(st_out),
              static_cast<int*>(obj_out), n, n_steps, ctl);
    });
  });
  return static_cast<int>(cudaGetLastError());
}
