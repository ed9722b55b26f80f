// Exact discrete adjoint of the fixed-step RK4 integrator, for Hopper
// (sm_90a).
//
// CUDA counterpart of `_bwd_kernel` in
// blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py (:1258-1357), in
// its Schwarzschild, event-free variant.  One thread per ray walks the
// checkpointed segments of rk4_ckpt.cu in reverse.  A segment whose
// checkpointed status is not ACTIVE is the identity and is skipped.
// Otherwise the thread recomputes the segment's steps from the checkpoint
// with the forward's own step code (rk4_step.cuh), keeping each pre-step
// (x, p) on a per-thread tape, and then applies rk4_step_adjoint to the
// taped steps in reverse.  Only steps s seg + k < n_steps run (the TPU
// kernel's `enabled`, :1319), and a step taken while the ray was not ACTIVE
// is never taped: it is the identity and adds nothing to the E or scalar
// cotangents.  Since a thread never differentiates a frozen ray, the
// kernel needs none of the TPU wrapper's far-away ERROR padding rays.
//
// Scalar cotangents (mass, dt, boost, r_ref) are per-ray terms summed over
// the grid.  The TPU revisits one output block in grid order; CUDA blocks
// run in no order, so each block sums its threads' terms in shared memory
// in a fixed tree into row blockIdx.x of a (n_blocks, 4) buffer, and
// `sum_blocks` adds the rows in a fixed order.  No atomics: the gradient is
// the same bit for bit from run to run.
//
// Bound: the FP32 pipes.  A taped step costs one forward step on recompute
// plus about three more for the adjoint (four RHS and four RHS VJPs); the
// tape (seg x 24 bytes, 384 bytes at seg 16) lives in local memory, which
// the L1 cache mostly holds.  Checkpoints are read once per live segment.
//
// Plain C interface (loaded with ctypes): `bhgc_rk4_bwd` launches both
// kernels on the given stream and returns cudaGetLastError() as an int.

#include "rk4_step.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSeg = 64;  // tape length; the wrapper caps seg at this
constexpr int kNGrad = 4;    // scalar cotangents: mass, dt, boost, r_ref

template <int PMODE>
__global__ void __launch_bounds__(kThreads)
    rk4_bwd_kernel(const float* __restrict__ scal,
                   const float* __restrict__ cx, const float* __restrict__ cp,
                   const float* __restrict__ clam,
                   const int* __restrict__ cst, const float* __restrict__ E_in,
                   const float* __restrict__ gx_in,
                   const float* __restrict__ gp_in, float* __restrict__ bx,
                   float* __restrict__ bp, float* __restrict__ bE,
                   float* __restrict__ partial, int n, int n_steps, int seg,
                   float power) {
  __shared__ float red[kThreads];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float gs[kNGrad] = {0.0f, 0.0f, 0.0f, 0.0f};  // mass, dt, boost, r_ref

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
      // recompute the segment onto the tape (enabled = s seg + t < n_steps)
      const int len = min(seg, n_steps - s * seg);
      int taped = 0;
      for (; taped < len && r.status == kActive; ++taped) {
        float* t = tape[taped];
        t[0] = r.x0; t[1] = r.x1; t[2] = r.x2;
        t[3] = r.p0; t[4] = r.p1; t[5] = r.p2;
        rk4_step<PMODE>(sc, power, E, r);
      }
      // adjoint sweep over the taped steps, last first
      for (int t = taped - 1; t >= 0; --t) {
        rk4_step_adjoint<PMODE>(sc, power, E, tape[t], g, gE, gs);
      }
    }

    bx[j] = g[0]; bx[j + 1] = g[1]; bx[j + 2] = g[2];
    bp[j] = g[3]; bp[j + 1] = g[4]; bp[j + 2] = g[5];
    bE[i] = gE;
  }

  // block sums of the scalar cotangents, in a fixed tree
#pragma unroll
  for (int q = 0; q < kNGrad; ++q) {
    red[threadIdx.x] = gs[q];
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
      if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
      __syncthreads();
    }
    if (threadIdx.x == 0) partial[blockIdx.x * kNGrad + q] = red[0];
    __syncthreads();
  }
}

// One block: out[q] = sum over b of partial[b, q], each thread summing a
// fixed stride of rows in order, then a fixed tree over the threads.  The
// NSCAL entries past r_ref (r_capture, r_escape, lam_max, r_in, r_out, a)
// get zero, as in the TPU kernel's event-free tail.
__global__ void __launch_bounds__(kThreads)
    sum_blocks(const float* __restrict__ partial, int n_blocks,
               float* __restrict__ out) {
  __shared__ float red[kThreads];
  for (int q = 0; q < kNGrad; ++q) {
    float acc = 0.0f;
    for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
      acc += partial[b * kNGrad + q];
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half >>= 1) {
      if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
      __syncthreads();
    }
    if (threadIdx.x == 0) out[q] = red[0];
    __syncthreads();
  }
  if (threadIdx.x >= kNGrad && threadIdx.x < kNScal) out[threadIdx.x] = 0.0f;
}

}  // namespace

// Rows of the block-partial buffer the wrapper allocates: bhgc_rk4_bwd
// needs `partial` of (bhgc_rk4_bwd_blocks(n), 4) floats.
extern "C" int bhgc_rk4_bwd_blocks(int n) {
  return (n + kThreads - 1) / kThreads;
}

extern "C" int bhgc_rk4_bwd(const void* scal, const void* cx, const void* cp,
                            const void* clam, const void* cst, const void* E,
                            const void* gx, const void* gp, void* bx, void* bp,
                            void* bE, void* partial, void* gscal, int n,
                            int n_steps, int seg, float power, void* stream) {
  if (seg < 1 || seg > kMaxSeg) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = bhgc_rk4_bwd_blocks(n);
  with_power_mode(power, [&](auto mode) {
    rk4_bwd_kernel<decltype(mode)::value><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(scal), static_cast<const float*>(cx),
        static_cast<const float*>(cp), static_cast<const float*>(clam),
        static_cast<const int*>(cst), static_cast<const float*>(E),
        static_cast<const float*>(gx), static_cast<const float*>(gp),
        static_cast<float*>(bx), static_cast<float*>(bp),
        static_cast<float*>(bE), static_cast<float*>(partial), n, n_steps,
        seg, power);
  });
  sum_blocks<<<1, kThreads, 0, s>>>(static_cast<const float*>(partial),
                                    blocks, static_cast<float*>(gscal));
  return static_cast<int>(cudaGetLastError());
}
