// Exact discrete adjoint of the fixed-step RK4 integrator, for Hopper
// (sm_90a).
//
// CUDA counterpart of `_bwd_kernel` in
// blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py (:1258-1357), in
// its Schwarzschild and Kerr variants, each event-free and with disk and
// sphere events (KERR and EV as in rk4_fwd.cu); the Kerr recompute runs the
// Kerr step, never the Schwarzschild one.  One thread per ray walks the
// checkpointed segments of rk4_ckpt.cu in reverse.  A segment whose
// checkpointed status is not ACTIVE is the identity and is skipped.
// Otherwise the thread recomputes the segment's steps from the checkpoint
// with the forward's own step code (rk4_step.cuh, with rk4_fwd.cu's sphere
// guard, which changes no bit), keeping each pre-step (x, p) on a tape, and
// then applies rk4_step_adjoint to the taped steps in reverse.  Only steps
// s seg + k < n_steps run (the TPU kernel's `enabled`, :1319), and a step
// taken while the ray was not ACTIVE is never taped: it is the identity and
// adds nothing to the E, scalar or sphere cotangents.  The step that ends
// in DISK or OBJECT was ACTIVE at its start, so it is taped and
// differentiated through the event point; its adjoint finds the entered
// sphere again from the taped state.  Since a thread never differentiates a
// frozen ray, the kernel needs none of the TPU wrapper's far-away ERROR
// padding rays.
//
// Thread t takes ray order[t] (cuda_kernel.ray_order): in cost order the
// rays with the most live segments come first, so a warp's rays recompute
// and sweep about as many segments each, as the TPU wrapper's cost-ordered
// tiles do (pallas_kernel.py:1568-1589).  A thread reads its ray's
// checkpoints and writes its cotangents at the ray's own index, so the
// per-ray cotangents are the same bit for bit in any order.
//
// Scalar cotangents (mass, dt, boost, r_ref, spin) are per-ray terms summed
// over the grid, and so is the (K, 4) sphere cotangent; a ray enters at
// most one sphere (the entry freezes it), so each thread holds one sphere's
// four terms and its index.  Each block sums its threads' terms in a fixed
// tree into row blockIdx.x of a (n_blocks, 5 + 4K) buffer, and `sum_blocks`
// adds the rows in a fixed order (block_sum.cuh): no atomics, the gradient
// is the same bit for bit from run to run for a given order.  The
// Schwarzschild variants write 0 for the spin's column.
//
// Bound: the FP32 pipes.  A taped step costs one forward step on recompute
// plus about three more for the adjoint (four RHS and four RHS VJPs; the
// Kerr RHS and its VJP are about three times the Schwarzschild ones).  What
// the design does about it, for an H100: 128-thread blocks with at most
// 128 registers a thread (four blocks, 16 warps, on an SM) to hide the
// dependent FP32 and MUFU chains; the adjoint's stages as loops, so SASS
// holds one copy of the RHS VJP (rk4_step_adjoint); the stage buffer k_0,
// k_1 in shared memory ([2][6][128], 6 KB a block); cost order against
// divergence.  The tape stays in local memory (seg x 24 B a thread): in
// shared memory, [step][component][thread], it ran 0.4-3.6% faster at seg
// 16 but left room for two blocks an SM at seg 32 and one at seg 64, where
// it ran 1.26-1.35x and 1.9-2.2x slower (PERF.md, PR 6).  Checkpoints are read
// once per live segment.
//
// Plain C interface (loaded with ctypes): `bhgc_rk4_bwd` launches both
// kernels on the given stream and returns cudaGetLastError() as an int.

#include "block_sum.cuh"
#include "rk4_step.cuh"

namespace {

constexpr int kThreads = kSumThreads;
constexpr int kMinBlocks = 4;  // resident blocks per SM the registers allow
constexpr int kMaxSeg = 64;  // tape length; the wrapper caps seg at this
constexpr int kNGrad = 5;    // scalar cotangents: mass, dt, boost, r_ref, spin

template <int PMODE, bool KERR, int EV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    rk4_bwd_kernel(const float* __restrict__ scal,
                   const float* __restrict__ sph, int n_sph,
                   const float* __restrict__ cx, const float* __restrict__ cp,
                   const float* __restrict__ clam,
                   const int* __restrict__ cst, const float* __restrict__ E_in,
                   const float* __restrict__ gx_in,
                   const float* __restrict__ gp_in, float* __restrict__ bx,
                   float* __restrict__ bp, float* __restrict__ bE,
                   float* __restrict__ partial,
                   const long long* __restrict__ order, int n, int n_steps, int seg,
                   float power) {
  constexpr bool kDiskEv = (EV & 2) != 0, kSphEv = (EV & 1) != 0;
  // the stage buffer [2][6][kThreads]; this thread's column at stride
  // kThreads
  __shared__ float stages[12 * kThreads];
  __shared__ float red[kThreads];
  float* const kbuf = stages + threadIdx.x;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  // mass, dt, boost, r_ref, spin
  float gs[kNGrad] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float gsph[4] = {0.0f, 0.0f, 0.0f, 0.0f};     // the entered sphere's
  int hit = -1;                                 // ... and its index

  if (t < n) {
    const int i = static_cast<int>(order[t]);
    const Scalars sc = load_scalars(scal);
    const long long j = 3LL * i;
    const float E = E_in[i];
    float g[6] = {gx_in[j], gx_in[j + 1], gx_in[j + 2],
                  gp_in[j], gp_in[j + 1], gp_in[j + 2]};
    float gE = 0.0f;
    float tape[kMaxSeg][6];   // x, p before each step

    const int n_seg = (n_steps + seg - 1) / seg;
    for (int s = n_seg - 1; s >= 0; --s) {
      const long long k = static_cast<long long>(s) * n + i;
      if (cst[k] != kActive) continue;  // frozen: the identity
      Ray r;
      r.x0 = cx[3 * k]; r.x1 = cx[3 * k + 1]; r.x2 = cx[3 * k + 2];
      r.p0 = cp[3 * k]; r.p1 = cp[3 * k + 1]; r.p2 = cp[3 * k + 2];
      r.lam = clam[k];
      r.status = kActive;
      r.obj = -1;
      // recompute the segment onto the tape (enabled = s seg + t < n_steps)
      const int len = min(seg, n_steps - s * seg);
      int taped = 0;
      for (; taped < len && r.status == kActive; ++taped) {
        float* const row = tape[taped];
        row[0] = r.x0; row[1] = r.x1; row[2] = r.x2;
        row[3] = r.p0; row[4] = r.p1; row[5] = r.p2;
        rk4_step<PMODE, KERR, kDiskEv, kSphEv, true>(sc, power, E, sph,
                                                     n_sph, r);
      }
      // adjoint sweep over the taped steps, last first
      for (int q = taped - 1; q >= 0; --q) {
        float y[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) y[c] = tape[q][c];
        rk4_step_adjoint<PMODE, KERR, kDiskEv, kSphEv, kThreads>(
            sc, power, E, sph, n_sph, y, g, gE, gs, gsph, hit, kbuf);
      }
    }

    bx[j] = g[0]; bx[j + 1] = g[1]; bx[j + 2] = g[2];
    bp[j] = g[3]; bp[j + 1] = g[4]; bp[j + 2] = g[5];
    bE[i] = gE;
  }

  // block sums of the scalar and sphere cotangents, in a fixed tree
  const int ncol = kNGrad + 4 * n_sph;
  float* row = partial + static_cast<long long>(blockIdx.x) * ncol;
#pragma unroll
  for (int q = 0; q < kNGrad; ++q) {
    // the spin's column (q = 4) is summed only where there is a spin
    const float v = (KERR || q < 4) ? block_sum(red, gs[q]) : 0.0f;
    if (threadIdx.x == 0) row[q] = v;
  }
  if (kSphEv) {
    for (int k = 0; k < n_sph; ++k) {
      for (int q = 0; q < 4; ++q) {
        const float v = block_sum(red, hit == k ? gsph[q] : 0.0f);
        if (threadIdx.x == 0) row[kNGrad + 4 * k + q] = v;
      }
    }
  }
}

// Calls f(kernel) with the instantiation of (power, kerr, has_disk, n_sph).
template <typename F>
void with_variant(float power, int kerr, int has_disk, int n_sph, F&& f) {
  with_power_mode(power, [&](auto mode) {
    with_kerr(kerr, [&](auto kr) {
      with_events(has_disk, n_sph, [&](auto ev) {
        f(rk4_bwd_kernel<decltype(mode)::value, decltype(kr)::value,
                         decltype(ev)::value>);
      });
    });
  });
}

}  // namespace

// Rows of the block-partial buffer the wrapper allocates: bhgc_rk4_bwd
// needs `partial` of (bhgc_rk4_bwd_blocks(n), kNGrad + 4 n_sph) floats.
extern "C" int bhgc_rk4_bwd_blocks(int n) {
  return (n + kThreads - 1) / kThreads;
}

// Blocks of the variant (power, kerr, has_disk, n_sph) that one SM holds
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an
// error.
extern "C" int bhgc_rk4_bwd_occupancy(float power, int kerr, int has_disk,
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

extern "C" int bhgc_rk4_bwd(const void* scal, const void* sph, int n_sph,
                            int has_disk, int kerr, const void* cx,
                            const void* cp, const void* clam, const void* cst,
                            const void* E, const void* gx, const void* gp,
                            void* bx, void* bp, void* bE, void* partial,
                            const void* order, void* gscal, void* gsph, int n,
                            int n_steps, int seg, float power, void* stream) {
  if (seg < 1 || seg > kMaxSeg) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = bhgc_rk4_bwd_blocks(n);
  with_variant(power, kerr, has_disk, n_sph, [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(scal), static_cast<const float*>(sph),
        n_sph, static_cast<const float*>(cx), static_cast<const float*>(cp),
        static_cast<const float*>(clam), static_cast<const int*>(cst),
        static_cast<const float*>(E), static_cast<const float*>(gx),
        static_cast<const float*>(gp), static_cast<float*>(bx),
        static_cast<float*>(bp), static_cast<float*>(bE),
        static_cast<float*>(partial), static_cast<const long long*>(order), n,
        n_steps, seg, power);
  });
  sum_blocks<kNGrad><<<1, kThreads, 0, s>>>(
      static_cast<const float*>(partial), blocks, kNGrad + 4 * n_sph,
      static_cast<float*>(gscal), static_cast<float*>(gsph));
  return static_cast<int>(cudaGetLastError());
}
