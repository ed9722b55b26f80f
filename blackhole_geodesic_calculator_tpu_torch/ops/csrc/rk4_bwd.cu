// Exact discrete adjoint of the fixed-step RK4 integrator, for Hopper
// (sm_90a).
//
// CUDA counterpart of `_bwd_kernel` in
// blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py (:1258-1357), in
// its Schwarzschild and Kerr variants, each event-free and with disk and
// sphere events (KERR and EV as in rk4_fwd.cu); the Kerr recompute runs the
// Kerr step, never the Schwarzschild one.  One thread per ray walks the
// checkpointed segments of rk4_ckpt.cu in reverse.  A segment whose checkpointed status
// is not ACTIVE is the identity and is skipped.  Otherwise the thread
// recomputes the segment's steps from the checkpoint with the forward's own
// step code (rk4_step.cuh), keeping each pre-step (x, p) on a per-thread
// tape, and then applies rk4_step_adjoint to the taped steps in reverse.
// Only steps s seg + k < n_steps run (the TPU kernel's `enabled`, :1319),
// and a step taken while the ray was not ACTIVE is never taped: it is the
// identity and adds nothing to the E, scalar or sphere cotangents.  The
// step that ends in DISK or OBJECT was ACTIVE at its start, so it is taped
// and differentiated through the event point; its adjoint finds the
// entered sphere again from the taped state.  Since a thread never
// differentiates a frozen ray, the kernel needs none of the TPU wrapper's
// far-away ERROR padding rays.
//
// Scalar cotangents (mass, dt, boost, r_ref, spin) are per-ray terms summed
// over the grid, and so is the (K, 4) sphere cotangent; a ray enters at
// most one sphere (the entry freezes it), so each thread holds one sphere's
// four terms and its index.  The TPU revisits one output block in grid
// order; CUDA blocks run in no order, so each block sums its threads' terms
// in shared memory in a fixed tree into row blockIdx.x of a
// (n_blocks, 5 + 4K) buffer, and `sum_blocks` adds the rows in a fixed
// order.  No atomics: the gradient is the same bit for bit from run to run.
// The Schwarzschild variants write 0 for the spin's column.
//
// Bound: the FP32 pipes.  A taped step costs one forward step on recompute
// plus about three more for the adjoint (four RHS and four RHS VJPs; the
// Kerr RHS and its VJP are about three times the Schwarzschild ones); the
// tape (seg x 24 bytes, 384 bytes at seg 16) lives in local memory, which
// the L1 cache mostly holds.  Checkpoints are read once per live segment.
//
// Plain C interface (loaded with ctypes): `bhgc_rk4_bwd` launches both
// kernels on the given stream and returns cudaGetLastError() as an int.

#include "rk4_step.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSeg = 64;  // tape length; the wrapper caps seg at this
constexpr int kNGrad = 5;    // scalar cotangents: mass, dt, boost, r_ref, spin

// One block's fixed-tree sum of v over its threads; thread 0 returns it.
__device__ __forceinline__ float block_sum(float* red, float v) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

template <int PMODE, bool KERR, int EV>
__global__ void __launch_bounds__(kThreads)
    rk4_bwd_kernel(const float* __restrict__ scal,
                   const float* __restrict__ sph, int n_sph,
                   const float* __restrict__ cx, const float* __restrict__ cp,
                   const float* __restrict__ clam,
                   const int* __restrict__ cst, const float* __restrict__ E_in,
                   const float* __restrict__ gx_in,
                   const float* __restrict__ gp_in, float* __restrict__ bx,
                   float* __restrict__ bp, float* __restrict__ bE,
                   float* __restrict__ partial, int n, int n_steps, int seg,
                   float power) {
  constexpr bool kDiskEv = (EV & 2) != 0, kSphEv = (EV & 1) != 0;
  __shared__ float red[kThreads];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // mass, dt, boost, r_ref, spin
  float gs[kNGrad] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float gsph[4] = {0.0f, 0.0f, 0.0f, 0.0f};     // the entered sphere's
  int hit = -1;                                 // ... and its index

  if (i < n) {
    const Scalars sc = load_scalars(scal);
    const long long j = 3LL * i;
    const float E = E_in[i];
    float g[6] = {gx_in[j], gx_in[j + 1], gx_in[j + 2],
                  gp_in[j], gp_in[j + 1], gp_in[j + 2]};
    float gE = 0.0f;
    float tape[kMaxSeg][6];

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
        float* t = tape[taped];
        t[0] = r.x0; t[1] = r.x1; t[2] = r.x2;
        t[3] = r.p0; t[4] = r.p1; t[5] = r.p2;
        rk4_step<PMODE, KERR, kDiskEv, kSphEv, false>(sc, power, E, sph,
                                                      n_sph, r);
      }
      // adjoint sweep over the taped steps, last first
      for (int t = taped - 1; t >= 0; --t) {
        rk4_step_adjoint<PMODE, KERR, kDiskEv, kSphEv>(
            sc, power, E, sph, n_sph, tape[t], g, gE, gs, gsph, hit);
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

// One block: column q of out = sum over b of partial[b, q], each thread
// summing a fixed stride of rows in order, then a fixed tree over the
// threads.  Columns 0..3 go to gscal[0..3] (mass, dt, boost, r_ref), column
// 4 to gscal[9] (the spin, a), the rest to the (K, 4) gsph; the NSCAL
// entries r_capture, r_escape, lam_max, r_in and r_out get zero: they enter
// the step only through comparisons.
__global__ void __launch_bounds__(kThreads)
    sum_blocks(const float* __restrict__ partial, int n_blocks, int ncol,
               float* __restrict__ gscal, float* __restrict__ gsph) {
  __shared__ float red[kThreads];
  for (int q = 0; q < ncol; ++q) {
    float acc = 0.0f;
    for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
      acc += partial[static_cast<long long>(b) * ncol + q];
    }
    const float v = block_sum(red, acc);
    if (threadIdx.x == 0) {
      if (q < kNGrad) {
        gscal[q < 4 ? q : kNScal - 1] = v;
      } else {
        gsph[q - kNGrad] = v;
      }
    }
  }
  if (threadIdx.x >= 4 && threadIdx.x < kNScal - 1) gscal[threadIdx.x] = 0.0f;
}

}  // namespace

// Rows of the block-partial buffer the wrapper allocates: bhgc_rk4_bwd
// needs `partial` of (bhgc_rk4_bwd_blocks(n), kNGrad + 4 n_sph) floats.
extern "C" int bhgc_rk4_bwd_blocks(int n) {
  return (n + kThreads - 1) / kThreads;
}

extern "C" int bhgc_rk4_bwd(const void* scal, const void* sph, int n_sph,
                            int has_disk, int kerr, const void* cx,
                            const void* cp,
                            const void* clam, const void* cst, const void* E,
                            const void* gx, const void* gp, void* bx, void* bp,
                            void* bE, void* partial, void* gscal, void* gsph,
                            int n, int n_steps, int seg, float power,
                            void* stream) {
  if (seg < 1 || seg > kMaxSeg) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = bhgc_rk4_bwd_blocks(n);
  with_power_mode(power, [&](auto mode) {
    with_kerr(kerr, [&](auto kr) {
      with_events(has_disk, n_sph, [&](auto ev) {
        rk4_bwd_kernel<decltype(mode)::value, decltype(kr)::value,
                       decltype(ev)::value><<<blocks, kThreads, 0, s>>>(
            static_cast<const float*>(scal), static_cast<const float*>(sph),
            n_sph, static_cast<const float*>(cx),
            static_cast<const float*>(cp), static_cast<const float*>(clam),
            static_cast<const int*>(cst), static_cast<const float*>(E),
            static_cast<const float*>(gx), static_cast<const float*>(gp),
            static_cast<float*>(bx), static_cast<float*>(bp),
            static_cast<float*>(bE), static_cast<float*>(partial), n,
            n_steps, seg, power);
      });
    });
  });
  sum_blocks<<<1, kThreads, 0, s>>>(static_cast<const float*>(partial), blocks,
                                    kNGrad + 4 * n_sph,
                                    static_cast<float*>(gscal),
                                    static_cast<float*>(gsph));
  return static_cast<int>(cudaGetLastError());
}
