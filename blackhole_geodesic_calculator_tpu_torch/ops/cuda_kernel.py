"""The forward geodesic integrator as a hand-written CUDA kernel.

Counterpart of ``blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py``:
``integrate_cuda`` plays the part of ``integrate_pallas`` and launches
``csrc/rk4_fwd.cu``, which replaces the TPU kernel ``_fwd_fast_kernel``
(pallas_kernel.py:1159) in its Schwarzschild, event-free variant.

Source note
-----------
* **Replaces** ``_fwd_fast_kernel`` (pallas_kernel.py:1159-1198) built by
  ``_build(...).fwd_fast`` (:1399-1415): fixed-step RK4 on the 6-ODE
  Hamiltonian system, each step ``_soa_step`` with ``_dt_soa``,
  ``_rhs_schw_soa`` and the event-free part of ``_events_merge``.
* **What bounds it on an H100.** Scalar float32 arithmetic: about 282
  operations per ray-step (4 RHS evaluations with one ``rsqrtf`` each, the
  step-size schedule and the endpoint test) against 36 bytes of ray state
  read once and 32 bytes written once per ray, whatever the step count.
  At the flagship's up to 100 steps that is thousands of operations per
  byte, far above the card's balance point, so it is bound by the FP32
  pipes and by warp divergence: a warp runs until its slowest ray ends.
* **What the design does about it.** One thread per ray with the whole
  state and the four RK4 stages in registers; nothing is staged through
  shared memory and no step touches device memory.  The TPU kernel's
  16-step chunks with a tile-wide "any ray ACTIVE" skip become a per-thread
  loop exit as soon as the thread's own ray leaves ACTIVE, which is exact
  because a frozen ray is an identity under the step.  The TPU-only
  machinery is not carried over: the 128-lane row layout, the ERROR padding
  rays and the VMEM tile sizing.  The cost-ordered tiling changes no output
  and is left to a measurement on the card.

``integrate_plain`` is the plain PyTorch version of the same function (the
step loop of ops/integrate.py); it shares no code with the kernel.
``integrate`` takes it only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from . import _build
from .integrate import GeodesicEnv, IntegratorConfig, integrate_fixed_fast
from .states import RayState

NSCAL = 10

# Kernel launches since import (or since a caller reset it); goes up by one
# in integrate_cuda right where the kernel is launched, and nowhere else.
LAUNCHES = 0


def integrate_plain(env: GeodesicEnv, s0: RayState,
                    cfg: IntegratorConfig) -> RayState:
    """Plain PyTorch version of ``integrate_cuda``: the RK4 step loop."""
    return integrate_fixed_fast(env, s0, cfg)


def _scalars(env: GeodesicEnv, cfg: IntegratorConfig,
             device: torch.device) -> torch.Tensor:
    """The (NSCAL,) float32 device vector, TPU kernel layout:
    [mass, dt, dt_boost, r_ref, r_capture, r_escape, lam_max, r_in, r_out, a].
    Tensor entries (mass, r_escape) stay on the device."""
    r_ref = cfg.dt_boost_r_ref or 6.0 * env.mass
    boost = cfg.dt_boost if cfg.dt_boost > 1.0 else 1.0
    vals = (env.mass, cfg.dt, boost, r_ref, env.r_capture, env.r_escape,
            env.lam_max, 0.0, 0.0, 0.0)
    return torch.stack([
        torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())
        for v in vals])


def _check_slice(env: GeodesicEnv, s0: RayState, cfg: IntegratorConfig):
    if cfg.method != "rk4":
        raise NotImplementedError(
            f"method={cfg.method!r} on CUDA needs the Dormand-Prince kernels "
            "(_fwd_dopri_kernel and its gradient pair), not ported yet")
    if env.spin is not None:
        raise NotImplementedError(
            "spin on CUDA needs the Kerr variant of the forward kernel, "
            "not ported yet")
    if env.disk is not None or env.spheres is not None:
        raise NotImplementedError(
            "disk or sphere events on CUDA need the event variants of the "
            "forward kernel, not ported yet")
    leaves = (s0.x, s0.p, s0.E, s0.lam, env.mass, env.r_capture,
              env.r_escape, env.lam_max)
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in leaves):
        raise NotImplementedError(
            "gradients through the CUDA integrator need the checkpointed "
            "forward (_fwd_ckpt_kernel) and adjoint (_bwd_kernel) kernels, "
            "not ported yet")


def _flat(t: torch.Tensor, batch, tail, dtype, name) -> torch.Tensor:
    """``t`` of shape batch + tail and type ``dtype``, as a contiguous
    (n,) + tail tensor for the kernel."""
    if tuple(t.shape) != tuple(batch) + tail:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(batch) + tail}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    return t.reshape((-1,) + tail).contiguous()


def integrate_cuda(env: GeodesicEnv, s0: RayState,
                   cfg: IntegratorConfig) -> RayState:
    """Integrate ``s0`` with the CUDA kernel; any batch shape.

    Same env/state/config as ``integrate_plain``; the result is the state
    after ``cfg.n_steps`` steps (rays frozen at their termination)."""
    global LAUNCHES
    _check_slice(env, s0, cfg)
    batch = s0.E.shape
    device = s0.x.device
    n = s0.E.numel()
    if n >= 2**31:
        raise ValueError(f"too many rays for one launch: {n}")
    x = _flat(s0.x, batch, (3,), torch.float32, "x")
    p = _flat(s0.p, batch, (3,), torch.float32, "p")
    E = _flat(s0.E, batch, (), torch.float32, "E")
    lam = _flat(s0.lam, batch, (), torch.float32, "lam")
    st = _flat(s0.status, batch, (), torch.int32, "status")
    if not x.is_cuda:
        raise ValueError("integrate_cuda needs tensors on a CUDA device; "
                         f"got {device}")
    for name, t in (("p", p), ("E", E), ("lam", lam), ("status", st)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
    scal = _scalars(env, cfg, device)

    x_out = torch.empty_like(x)
    p_out = torch.empty_like(p)
    lam_out = torch.empty_like(lam)
    st_out = torch.empty_like(st)
    if n:
        lib = _build.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = lib.bhgc_rk4_fwd(
                scal.data_ptr(), x.data_ptr(), p.data_ptr(), E.data_ptr(),
                lam.data_ptr(), st.data_ptr(), x_out.data_ptr(),
                p_out.data_ptr(), lam_out.data_ptr(), st_out.data_ptr(),
                n, int(cfg.n_steps), float(cfg.dt_power), stream)
        if rc != 0:
            raise RuntimeError(f"rk4_fwd kernel launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES += 1
    return RayState(x=x_out.reshape(batch + (3,)),
                    p=p_out.reshape(batch + (3,)), E=s0.E,
                    lam=lam_out.reshape(batch),
                    status=st_out.reshape(batch), hit_obj=s0.hit_obj)
