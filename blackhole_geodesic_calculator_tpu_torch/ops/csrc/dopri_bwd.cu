// Exact discrete adjoint of the adaptive Dormand-Prince integrator, through
// the per-ray step controller, for Hopper (sm_90a).
//
// CUDA counterpart of `_bwd_dopri_kernel` in
// blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py (:804-903), in its
// Schwarzschild and Kerr variants, each event-free and with disk and sphere
// events (KERR and EV as in dopri_fwd.cu).  One thread per ray walks the
// checkpointed segments of dopri_ckpt.cu in reverse.  A segment whose
// checkpointed status is not ACTIVE is the identity and is skipped.
// Otherwise the thread recomputes the segment's trips from the checkpoint,
// the controller restarted from the checkpointed h, with the forward's own
// trip code (dopri_trip.cuh), keeping each pre-trip (x, p, h, lam) on a
// per-thread tape, and then applies dopri_trip_adjoint to the taped trips
// in reverse.  The cotangent of h is carried from trip to trip and across
// segments (h' depends on the state through the error norm); at trip 0 it
// lands on the constant initial h and is dropped (pallas_kernel.py:1017).
// Only trips s seg + k < n_steps run, and a trip taken while the ray was
// not ACTIVE is the identity and never taped, so the kernel needs none of
// the TPU wrapper's far-away ERROR padding rays.
//
// Thread t takes ray order[t] (cuda_kernel.ray_order), as in rk4_bwd.cu:
// in cost order a warp's rays recompute and sweep about as many segments
// each, and the per-ray cotangents are the same bit for bit in any order.
// The mass and spin cotangents and the (K, 4) sphere cotangent are per-ray
// terms summed over the grid in a fixed order (block_sum.cuh), as in
// rk4_bwd.cu: the same bits from run to run for a given order.  The
// Schwarzschild variants write 0 for the spin's column.
//
// Bound: the FP32 pipes.  A taped trip costs one forward trip on recompute
// plus the adjoint (seven right-hand sides recomputed and seven RHS VJPs).
// What the design does about it, for an H100: 128-thread blocks; the
// adjoint's seven stages as loops, each stage's cotangent gathered when it
// is transposed (dopri_trip_adjoint); in the Kerr variants the loops are
// not unrolled, so SASS holds one copy of the Kerr VJP, the stage values
// k_0..k_5 and the stages' cotangents sit in shared memory ([36][128]
// each, 36 KB a block, a warp's accesses in 32 banks) and a thread takes
// at most 128 registers (16 warps on an SM); the Schwarzschild variants
// unroll them and keep those values in registers (at most 255, 8 warps);
// cost order against divergence.  The tape stays in local memory (seg x
// 32 B a thread, 2 KB at seg 64) at the TPU's segment length: in shared
// memory, at seg 16 or 32 (64 or 128 KB a block), it leaves room for two
// blocks or one on an SM and ran 4-118% slower on the main paths' frames,
// and a local tape at seg 16 ran 3-10% slower (more segments, and more
// checkpoint rows for dopri_ckpt) (PERF.md, PR 6).  The sweep loads the
// next trip's entry before it transposes the current one, so its latency
// overlaps the work.
//
// Plain C interface (loaded with ctypes): `bhgc_dopri_bwd` launches both
// kernels on the given stream and returns cudaGetLastError() as an int.

#include "block_sum.cuh"
#include "dopri_trip.cuh"

namespace {

constexpr int kThreads = kSumThreads;
// resident blocks per SM the registers allow: the Kerr variants keep their
// stage values in shared memory (16 warps at <= 128 registers), the
// Schwarzschild ones in registers (8 warps at <= 255: at <= 170 the
// Schwarzschild fan spilled 500 B and ran slower)
template <bool KERR>
constexpr int kMinBlocks = KERR ? 4 : 2;
constexpr int kMaxSeg = 64;  // tape length; the wrapper caps seg at this
constexpr int kNGrad = 2;    // scalar cotangents: mass, spin

template <bool KERR, int EV>
__global__ void __launch_bounds__(kThreads, kMinBlocks<KERR>)
    dopri_bwd_kernel(const float* __restrict__ scal,
                     const float* __restrict__ sph, int n_sph,
                     const float* __restrict__ cx,
                     const float* __restrict__ cp,
                     const float* __restrict__ ch,
                     const float* __restrict__ clam,
                     const int* __restrict__ cst,
                     const float* __restrict__ E_in,
                     const float* __restrict__ gx_in,
                     const float* __restrict__ gp_in, float* __restrict__ bx,
                     float* __restrict__ bp, float* __restrict__ bE,
                     float* __restrict__ partial,
                     const long long* __restrict__ order, int n, int n_steps,
                     int seg, Controller ctl) {
  constexpr bool kDiskEv = (EV & 2) != 0, kSphEv = (EV & 1) != 0;
  // the Kerr stage values and their cotangents, [36][kThreads] each
  __shared__ float stages[KERR ? 72 * kThreads : 1];
  __shared__ float red[kThreads];
  float* const kbuf = stages + (KERR ? threadIdx.x : 0);
  float* const gbuf = kbuf + (KERR ? 36 * kThreads : 0);
  const int t = blockIdx.x * kThreads + threadIdx.x;
  float gs[kNGrad] = {0.0f, 0.0f};              // mass, spin
  float gsph[4] = {0.0f, 0.0f, 0.0f, 0.0f};     // the entered sphere's
  int hit = -1;                                 // ... and its index

  if (t < n) {
    const int i = static_cast<int>(order[t]);
    const Scalars sc = load_scalars(scal, sph, n_sph);
    const long long j = 3LL * i;
    const float E = E_in[i];
    float g[6] = {gx_in[j], gx_in[j + 1], gx_in[j + 2],
                  gp_in[j], gp_in[j + 1], gp_in[j + 2]};
    float gh = 0.0f;   // the final h is not an output
    float gE = 0.0f;
    float tape[kMaxSeg][8];   // x, p, h, lam before each trip

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
      float h = ch[k];
      // recompute the segment onto the tape (enabled = s seg + t < n_steps)
      const int len = min(seg, n_steps - s * seg);
      int taped = 0;
      for (; taped < len && r.status == kActive; ++taped) {
        float* const row = tape[taped];
        row[0] = r.x0; row[1] = r.x1; row[2] = r.x2;
        row[3] = r.p0; row[4] = r.p1; row[5] = r.p2;
        row[6] = h;
        row[7] = r.lam;
        dopri_trip<KERR, kDiskEv, kSphEv, false>(sc, ctl, E, sph, n_sph, r,
                                                 h);
      }
      // adjoint sweep over the taped trips, last first; the next entry is
      // loaded before the current one is transposed
      float next[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        next[c] = taped > 0 ? tape[taped - 1][c] : 0.0f;
      }
      for (int q = taped - 1; q >= 0; --q) {
        float cur[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          cur[c] = next[c];
          if (q > 0) next[c] = tape[q - 1][c];
        }
        dopri_trip_adjoint<KERR, kDiskEv, kSphEv, kThreads>(
            sc, ctl, E, sph, n_sph, cur, cur[6], cur[7], g, gh, gE, gs, gsph,
            hit, kbuf, gbuf);
      }
    }

    bx[j] = g[0]; bx[j + 1] = g[1]; bx[j + 2] = g[2];
    bp[j] = g[3]; bp[j + 1] = g[4]; bp[j + 2] = g[5];
    bE[i] = gE;
  }

  // block sums of the scalar and sphere cotangents, in a fixed tree
  const int ncol = kNGrad + 4 * n_sph;
  float* row = partial + static_cast<long long>(blockIdx.x) * ncol;
  const float vm = block_sum(red, gs[0]);
  if (threadIdx.x == 0) row[0] = vm;
  // the spin's column is summed only where there is a spin
  const float vs = KERR ? block_sum(red, gs[1]) : 0.0f;
  if (threadIdx.x == 0) row[1] = vs;
  if (kSphEv) {
    for (int k = 0; k < n_sph; ++k) {
      for (int q = 0; q < 4; ++q) {
        const float v = block_sum(red, hit == k ? gsph[q] : 0.0f);
        if (threadIdx.x == 0) row[kNGrad + 4 * k + q] = v;
      }
    }
  }
}

// Calls f(kernel) with the instantiation of (kerr, has_disk, n_sph).
template <typename F>
void with_variant(int kerr, int has_disk, int n_sph, F&& f) {
  with_kerr(kerr, [&](auto kr) {
    with_events(has_disk, n_sph, [&](auto ev) {
      f(dopri_bwd_kernel<decltype(kr)::value, decltype(ev)::value>);
    });
  });
}

}  // namespace

// Rows of the block-partial buffer the wrapper allocates: bhgc_dopri_bwd
// needs `partial` of (bhgc_dopri_bwd_blocks(n), 2 + 4 n_sph) floats.
extern "C" int bhgc_dopri_bwd_blocks(int n) {
  return (n + kThreads - 1) / kThreads;
}

// Blocks of the variant (kerr, has_disk, n_sph) that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1 on an error.
extern "C" int bhgc_dopri_bwd_occupancy(int kerr, int has_disk, int n_sph) {
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

extern "C" int bhgc_dopri_bwd(const void* scal, const void* sph, int n_sph,
                              int has_disk, int kerr, const void* cx,
                              const void* cp, const void* ch,
                              const void* clam, const void* cst,
                              const void* E, const void* gx, const void* gp,
                              void* bx, void* bp, void* bE, void* partial,
                              const void* order, void* gscal, void* gsph,
                              int n, int n_steps, int seg, float rtol,
                              float atol, float min_step, float max_step,
                              void* stream) {
  if (seg < 1 || seg > kMaxSeg) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = bhgc_dopri_bwd_blocks(n);
  const Controller ctl{rtol, atol, min_step, max_step};
  with_variant(kerr, has_disk, n_sph, [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(scal), static_cast<const float*>(sph),
        n_sph, static_cast<const float*>(cx), static_cast<const float*>(cp),
        static_cast<const float*>(ch), static_cast<const float*>(clam),
        static_cast<const int*>(cst), static_cast<const float*>(E),
        static_cast<const float*>(gx), static_cast<const float*>(gp),
        static_cast<float*>(bx), static_cast<float*>(bp),
        static_cast<float*>(bE), static_cast<float*>(partial),
        static_cast<const long long*>(order), n, n_steps, seg, ctl);
  });
  sum_blocks<kNGrad><<<1, kThreads, 0, s>>>(
      static_cast<const float*>(partial), blocks, kNGrad + 4 * n_sph,
      static_cast<float*>(gscal), static_cast<float*>(gsph));
  return static_cast<int>(cudaGetLastError());
}
