// Forward fixed-step RK4 geodesic integrator for Hopper (sm_90a).
//
// CUDA counterpart of `_fwd_fast_kernel` in
// blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py (:1159-1198), in
// its Schwarzschild and Kerr variants (KERR), each event-free and with the
// events of a z = 0 disk and of K spheres (EV = 2 has_disk + (K > 0)): the
// `kerr`, `has_disk` and `n_sph` of `_build` (:1377-1379).  The design note
// is in ops/cuda_kernel.py beside the wrapper; in short: one thread per
// ray, the whole state and the four RK4 stages in registers, ray state read
// from device memory once and written once, and a per-thread exit as soon
// as the thread's own ray leaves ACTIVE.  The step itself is
// rk4_step.cuh's, which the gradient kernels share; it computes the radius
// once (the endpoint's, carried in Ray::rad to the next step's size).  The
// TPU kernel's tile-wide sphere guard is a per-ray skip of the K sphere
// quadratics here (segment_events with GUARD), conservative, so the states
// equal those without it bit for bit.
//
// Bound: the FP32 and special-function pipes' issue slots.  The threads
// take the rays in input order: sorting them by impact parameter, as the
// TPU wrapper sorts its rows, fills the blocks' warps but costs more than
// it saves on an H100 (PERF.md).
//
// Plain C interface (loaded with ctypes): `bhgc_rk4_fwd` launches on the
// given stream and returns cudaGetLastError() as an int.

#include "rk4_step.cuh"

namespace {

constexpr int kThreads = 256;

template <int PMODE, bool KERR, int EV>
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
                   int* __restrict__ st_out, int* __restrict__ obj_out,
                   int n, int n_steps, float power) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const Scalars sc = load_scalars(scal, sph, n_sph);
  const long long j = 3LL * i;
  Ray r;
  r.x0 = x_in[j]; r.x1 = x_in[j + 1]; r.x2 = x_in[j + 2];
  r.p0 = p_in[j]; r.p1 = p_in[j + 1]; r.p2 = p_in[j + 2];
  r.lam = lam_in[i];
  r.status = st_in[i];
  r.obj = obj_in[i];
  r.rad = radius<KERR>(sc, r.x0, r.x1, r.x2);
  const float E = E_in[i];

  // A ray that is not ACTIVE is an exact identity under the step (dt = 0,
  // no update, status kept), so each thread stops at its own ray's end.
  for (int step = 0; step < n_steps && r.status == kActive; ++step) {
    rk4_step<PMODE, KERR, (EV & 2) != 0, (EV & 1) != 0, true>(sc, power, E,
                                                              sph, n_sph, r);
  }

  x_out[j] = r.x0; x_out[j + 1] = r.x1; x_out[j + 2] = r.x2;
  p_out[j] = r.p0; p_out[j + 1] = r.p1; p_out[j + 2] = r.p2;
  lam_out[i] = r.lam;
  st_out[i] = r.status;
  obj_out[i] = r.obj;
}

// Calls f(kernel) with the instantiation of (power, kerr, has_disk, n_sph).
template <typename F>
void with_variant(float power, int kerr, int has_disk, int n_sph, F&& f) {
  with_power_mode(power, [&](auto mode) {
    with_kerr(kerr, [&](auto kr) {
      with_events(has_disk, n_sph, [&](auto ev) {
        f(rk4_fwd_kernel<decltype(mode)::value, decltype(kr)::value,
                         decltype(ev)::value>);
      });
    });
  });
}

}  // namespace

// Blocks of the variant (power, kerr, has_disk, n_sph) that one SM holds
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an
// error.
extern "C" int bhgc_rk4_fwd_occupancy(float power, int kerr, int has_disk,
                                      int n_sph) {
  int blocks = -1;
  with_variant(power, kerr, has_disk, n_sph, [&](auto kernel) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, 0) !=
        cudaSuccess) {
      blocks = -1;
    }
  });
  return blocks;
}

extern "C" int bhgc_rk4_fwd(const void* scal, const void* sph, int n_sph,
                            int has_disk, int kerr, const void* x,
                            const void* p, const void* E, const void* lam,
                            const void* st, const void* obj, void* x_out,
                            void* p_out, void* lam_out, void* st_out,
                            void* obj_out, int n, int n_steps, float power,
                            void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  with_variant(power, kerr, has_disk, n_sph, [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scal), static_cast<const float*>(sph),
        n_sph, static_cast<const float*>(x), static_cast<const float*>(p),
        static_cast<const float*>(E), static_cast<const float*>(lam),
        static_cast<const int*>(st), static_cast<const int*>(obj),
        static_cast<float*>(x_out), static_cast<float*>(p_out),
        static_cast<float*>(lam_out), static_cast<int*>(st_out),
        static_cast<int*>(obj_out), n, n_steps, power);
  });
  return static_cast<int>(cudaGetLastError());
}
