// Checkpointing adaptive forward of the Dormand-Prince gradient path, for
// Hopper (sm_90a).
//
// CUDA counterpart of `_fwd_dopri_ckpt_kernel` in
// blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py (:749-801), in its
// Schwarzschild and Kerr variants, each event-free and with disk and sphere
// events (KERR and EV as in dopri_fwd.cu).  Unlike the TPU kernel it
// takes the sphere guard, as dopri_fwd does; the guard changes no result
// (chip_smoke.py holds both kernels to a build without it bit for bit).
// One thread per ray runs the same trip as dopri_fwd (dopri_trip.cuh), so
// its final state equals dopri_fwd's, and before trips 0, seg, 2 seg, ...
// it writes the ray's (x, p, h, lam, status) to row s of the checkpoint
// tensors (n_seg, n, ...): the adjoint's recompute must restart the
// controller from the exact h.  A ray that has frozen keeps writing its
// frozen state at the later segment starts, so the adjoint (dopri_bwd.cu)
// can skip those segments by their status.  Trips at or past n_steps are
// not run.  It also writes each ray's count of ACTIVE rows, capped at 255,
// as rk4_ckpt.cu does.
//
// Bound: like dopri_fwd, the FP32 pipes and warp divergence; the
// checkpoints add n_seg x 36 bytes of writes per ray.  The design is
// dopri_fwd's: the same trip and block size; the Schwarzschild variants
// may take 73 registers (7 blocks), where the checkpoint loop spills at 64.
//
// Plain C interface (loaded with ctypes): `bhgc_dopri_ckpt` launches on the
// given stream and returns cudaGetLastError() as an int.

#include "dopri_trip.cuh"

namespace {

constexpr int kThreads = 128;
// resident blocks per SM the registers must allow: 7 (<= 73 registers)
// for the Schwarzschild variants, whose sphere variant spills at 64, and 6
// (<= 85) for the Kerr ones, which take 80
template <bool KERR>
constexpr int kMinBlocks = KERR ? 6 : 7;

template <bool KERR, int EV>
__global__ void __launch_bounds__(kThreads, kMinBlocks<KERR>)
    dopri_ckpt_kernel(const float* __restrict__ scal,
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
                      int* __restrict__ obj_out, float* __restrict__ cx,
                      float* __restrict__ cp, float* __restrict__ ch,
                      float* __restrict__ clam, int* __restrict__ cst,
                      unsigned char* __restrict__ live, int n, int n_steps,
                      int seg, Controller ctl) {
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
  const float E = E_in[i];
  float h = h_in[i];

  const int n_seg = (n_steps + seg - 1) / seg;
  for (int s = 0; s < n_seg; ++s) {
    const long long k = static_cast<long long>(s) * n + i;
    cx[3 * k] = r.x0; cx[3 * k + 1] = r.x1; cx[3 * k + 2] = r.x2;
    cp[3 * k] = r.p0; cp[3 * k + 1] = r.p1; cp[3 * k + 2] = r.p2;
    ch[k] = h;
    clam[k] = r.lam;
    cst[k] = r.status;
    // enabled = s seg + trip < n_steps (pallas_kernel.py:787)
    const int len = min(seg, n_steps - s * seg);
    for (int trip = 0; trip < len && r.status == kActive; ++trip) {
      dopri_trip<KERR, (EV & 2) != 0, (EV & 1) != 0, true>(sc, ctl, E, sph,
                                                           n_sph, r, h);
    }
  }

  x_out[j] = r.x0; x_out[j + 1] = r.x1; x_out[j + 2] = r.x2;
  p_out[j] = r.p0; p_out[j + 1] = r.p1; p_out[j + 2] = r.p2;
  lam_out[i] = r.lam;
  st_out[i] = r.status;
  obj_out[i] = r.obj;
  // the live rows, a prefix of the statuses just written, counted after
  // the steps so that the step loop holds no counter in its registers
  int n_live = 0;
  while (n_live < n_seg &&
         cst[static_cast<long long>(n_live) * n + i] == kActive) {
    ++n_live;
  }
  live[i] = static_cast<unsigned char>(min(n_live, 255));
}

// Calls f(kernel) with the instantiation of (kerr, has_disk, n_sph).
template <typename F>
void with_variant(int kerr, int has_disk, int n_sph, F&& f) {
  with_kerr(kerr, [&](auto kr) {
    with_events(has_disk, n_sph, [&](auto ev) {
      f(dopri_ckpt_kernel<decltype(kr)::value, decltype(ev)::value>);
    });
  });
}

}  // namespace

// Blocks of a launch on n rays.
extern "C" int bhgc_dopri_ckpt_blocks(int n) {
  return (n + kThreads - 1) / kThreads;
}

// Blocks of the variant (kerr, has_disk, n_sph) that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an error.
extern "C" int bhgc_dopri_ckpt_occupancy(int kerr, int has_disk, int n_sph) {
  int blocks = -1;
  with_variant(kerr, has_disk, n_sph, [&](auto kernel) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, 0) !=
        cudaSuccess) {
      blocks = -1;
    }
  });
  return blocks;
}

extern "C" int bhgc_dopri_ckpt(const void* scal, const void* sph, int n_sph,
                               int has_disk, int kerr, const void* x,
                               const void* p, const void* E, const void* h,
                               const void* lam, const void* st,
                               const void* obj, void* x_out, void* p_out,
                               void* lam_out, void* st_out, void* obj_out,
                               void* cx, void* cp, void* ch, void* clam,
                               void* cst, void* live, int n, int n_steps,
                               int seg, float rtol, float atol,
                               float min_step, float max_step, void* stream) {
  const int blocks = bhgc_dopri_ckpt_blocks(n);
  const Controller ctl{rtol, atol, min_step, max_step};
  with_variant(kerr, has_disk, n_sph, [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scal), static_cast<const float*>(sph),
        n_sph, static_cast<const float*>(x),
        static_cast<const float*>(p), static_cast<const float*>(E),
        static_cast<const float*>(h), static_cast<const float*>(lam),
        static_cast<const int*>(st), static_cast<const int*>(obj),
        static_cast<float*>(x_out), static_cast<float*>(p_out),
        static_cast<float*>(lam_out), static_cast<int*>(st_out),
        static_cast<int*>(obj_out), static_cast<float*>(cx),
        static_cast<float*>(cp), static_cast<float*>(ch),
        static_cast<float*>(clam), static_cast<int*>(cst),
        static_cast<unsigned char*>(live), n, n_steps, seg, ctl);
  });
  return static_cast<int>(cudaGetLastError());
}
