// Checkpointing forward of the gradient path, for Hopper (sm_90a).
//
// CUDA counterpart of `_fwd_ckpt_kernel` in
// blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py (:1201-1252), in
// its Schwarzschild and Kerr variants, each event-free and with disk and
// sphere events (KERR and EV as in rk4_fwd.cu).  It has no sphere guard, as
// on the TPU (:1230-1233); the guard changes no result.  One thread per ray runs the
// same step as the forward kernel (rk4_step.cuh), so its final state equals
// rk4_fwd's, and before steps 0, seg, 2 seg, ... it writes the ray's
// (x, p, lam, status) to row s of the checkpoint tensors (n_seg, n, ...).
// A ray that has frozen keeps writing its frozen state at the later
// segment starts, as the TPU kernel fills them, so the adjoint (rk4_bwd.cu)
// can skip those segments by their status.  Steps at or past n_steps
// (the tail of a partial last segment) are not run.  It also writes each
// ray's count of ACTIVE rows, capped at 255 to fit a byte: the key of the
// adjoint's cost order (cuda_kernel.ray_order), counted from those rows.
//
// Bound: like rk4_fwd, the FP32 pipes and warp divergence; the checkpoints
// add n_seg x 32 bytes of writes per ray (235 MB at the 1024^2 flagship,
// n_seg = 7), a small share of the card's bandwidth over the kernel's time.
//
// Plain C interface (loaded with ctypes): `bhgc_rk4_ckpt` launches on the
// given stream and returns cudaGetLastError() as an int.

#include "rk4_step.cuh"

namespace {

constexpr int kThreads = 256;
// four blocks an SM, so at most 64 registers a thread: left to itself the
// compiler gives the Kerr variants 76-80, three blocks, and they ran 4-6%
// slower (PERF.md, PR 6)
constexpr int kMinBlocks = 4;

template <int PMODE, bool KERR, int EV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rk4_ckpt_kernel(const float* __restrict__ scal,
                    const float* __restrict__ sph, int n_sph,
                    const float* __restrict__ x_in,
                    const float* __restrict__ p_in,
                    const float* __restrict__ E_in,
                    const float* __restrict__ lam_in,
                    const int* __restrict__ st_in,
                    const int* __restrict__ obj_in, float* __restrict__ x_out,
                    float* __restrict__ p_out, float* __restrict__ lam_out,
                    int* __restrict__ st_out, int* __restrict__ obj_out,
                    float* __restrict__ cx,
                    float* __restrict__ cp, float* __restrict__ clam,
                    int* __restrict__ cst, unsigned char* __restrict__ live,
                    int n, int n_steps, int seg, float power) {
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

  const int n_seg = (n_steps + seg - 1) / seg;
  for (int s = 0; s < n_seg; ++s) {
    const long long k = static_cast<long long>(s) * n + i;
    cx[3 * k] = r.x0; cx[3 * k + 1] = r.x1; cx[3 * k + 2] = r.x2;
    cp[3 * k] = r.p0; cp[3 * k + 1] = r.p1; cp[3 * k + 2] = r.p2;
    clam[k] = r.lam;
    cst[k] = r.status;
    // enabled = s seg + step < n_steps (pallas_kernel.py:1233)
    const int len = min(seg, n_steps - s * seg);
    for (int step = 0; step < len && r.status == kActive; ++step) {
      rk4_step<PMODE, KERR, (EV & 2) != 0, (EV & 1) != 0, false>(
          sc, power, E, sph, n_sph, r);
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

}  // namespace

extern "C" int bhgc_rk4_ckpt(const void* scal, const void* sph, int n_sph,
                             int has_disk, int kerr, const void* x,
                             const void* p,
                             const void* E, const void* lam, const void* st,
                             const void* obj, void* x_out, void* p_out,
                             void* lam_out, void* st_out, void* obj_out,
                             void* cx, void* cp, void* clam, void* cst,
                             void* live, int n, int n_steps, int seg,
                             float power, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  with_power_mode(power, [&](auto mode) {
    with_kerr(kerr, [&](auto kr) {
      with_events(has_disk, n_sph, [&](auto ev) {
        rk4_ckpt_kernel<decltype(mode)::value, decltype(kr)::value,
                        decltype(ev)::value>
            <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
                static_cast<const float*>(scal),
                static_cast<const float*>(sph), n_sph,
                static_cast<const float*>(x), static_cast<const float*>(p),
                static_cast<const float*>(E), static_cast<const float*>(lam),
                static_cast<const int*>(st), static_cast<const int*>(obj),
                static_cast<float*>(x_out), static_cast<float*>(p_out),
                static_cast<float*>(lam_out), static_cast<int*>(st_out),
                static_cast<int*>(obj_out), static_cast<float*>(cx),
                static_cast<float*>(cp), static_cast<float*>(clam),
                static_cast<int*>(cst), static_cast<unsigned char*>(live), n,
                n_steps, seg, power);
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}
