"""The geodesic integrators as hand-written CUDA kernels, with their gradients.

Counterpart of ``blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py``:
``integrate_cuda`` plays the part of ``integrate_pallas`` and
``integrate_pallas_dopri``.  Fixed-step RK4: with no gradient recorded it
launches ``csrc/rk4_fwd.cu``; under autograd it runs ``RK4Adjoint``, whose
forward launches ``csrc/rk4_ckpt.cu`` and whose backward launches
``csrc/rk4_bwd.cu`` -- the ``jax.custom_vjp`` of ``_build``
(pallas_kernel.py:1467-1491).  All three run the step of
``csrc/rk4_step.cuh``.  Adaptive Dormand-Prince: ``csrc/dopri_fwd.cu``
with no gradient, ``DopriAdjoint`` (``csrc/dopri_ckpt.cu`` forward,
``csrc/dopri_bwd.cu`` backward) under autograd -- the custom_vjp of
``_build_dopri_grad`` (:995-1021); all three run the trip of
``csrc/dopri_trip.cuh``, which shares the step's classification, events
and right-hand sides.

Source note
-----------
* **Replaces** the six TPU kernels, each in the variants the wrappers
  choose at compile time (pallas_kernel.py:1377-1379, :1619-1621,
  :668-678): Schwarzschild (``_rhs_schw_soa``, the Euclidean radius) or
  Kerr (``kerr``: ``_rhs_kerr_soa`` :84-142, the Kerr-Schild radius
  ``_ks_radius_soa`` :145-153, the sphere guard widened by |a| :249-265,
  and in the adjoints the VJP of the Kerr right-hand side, :1055-1074),
  each event-free or with the segment events of a z = 0 disk and of K
  spheres (``has_disk``, ``n_sph``):

  - ``_fwd_fast_kernel`` (pallas_kernel.py:1159-1198), built by
    ``_build(...).fwd_fast`` (:1399-1415) -> ``rk4_fwd``;
  - ``_fwd_ckpt_kernel`` (:1201-1252), built by ``_build(...).fwd_ckpt``
    (:1417-1436) -> ``rk4_ckpt``;
  - ``_bwd_kernel`` (:1258-1357) with ``_step_adjoint`` (:1025-1153), built
    by ``_build(...).bwd_call`` (:1438-1465) -> ``rk4_bwd``;
  - ``_fwd_dopri_kernel`` (:473-514) with ``_dopri_trip`` (:390-470),
    built by ``_build_dopri(...).fwd`` (:540) and
    ``_build_dopri_grad(...).fwd_fast`` (:939) -> ``dopri_fwd``;
  - ``_fwd_dopri_ckpt_kernel`` (:749-801), built by
    ``_build_dopri_grad(...).fwd_ckpt`` (:957) -> ``dopri_ckpt``;
  - ``_bwd_dopri_kernel`` (:804-903) with ``_dopri_trip_adjoint``
    (:702-746), built by ``_build_dopri_grad(...).bwd_call`` (:972) ->
    ``dopri_bwd``.
* **What bounds them on an H100.** Scalar float32 arithmetic: 276
  operations per ray-step forward in Schwarzschild (4 RHS evaluations with
  one ``rsqrtf`` each, the step-size schedule and the endpoint test) and
  about 750 in Kerr (a Kerr RHS is about 160, with two reciprocal square
  roots and two reciprocals on the special-function unit, and the
  Kerr-Schild radius adds two IEEE square roots), about 3.5 times that per
  taped step backward; a Dormand-Prince trip has seven
  RHS evaluations, the error norm and the controller.  Against
  that, 40 bytes of ray state read once and 36 written once per ray
  (Dormand-Prince: 44 read, the per-ray h), plus 32 bytes (36) per ray and
  segment of checkpoints.  At tens to hundreds of steps or trips per ray
  that is hundreds of operations per byte or more, far above the card's
  balance point, so they are bound by the FP32 pipes and by warp
  divergence: a warp runs until its slowest ray ends, and an adaptive ray
  ends after its own number of trips.  The events add one disk test and K
  sphere quadratics (about 25 operations each) per step; the forward
  kernels skip the quadratics for a ray whose segment cannot reach any
  sphere (the TPU kernel's sphere guard, per ray).  ``chip_smoke.py``
  counts the operations per variant and the ray-steps of its inputs for
  the bound.
* **What the design does about it.** One thread per ray with the whole
  state, the per-ray step h and the RK4 or Dormand-Prince stages in
  registers.  The TPU kernels' tile-wide "any ray ACTIVE" skips become
  per-thread exits as soon as the thread's own ray leaves ACTIVE, which is
  exact because a frozen ray is an identity under a step or a trip.  The
  adjoints recompute one segment at a time onto a per-thread tape in local
  memory and sweep it backwards; they never differentiate a frozen step,
  so they need none of the TPU wrapper's far-away ERROR padding rays.
  Their Kerr stages are loops with one call site of the right-hand side's
  VJP and the stage values in shared memory, in 128-thread blocks of at
  most 128 registers a thread (16 warps an SM).  Their threads take the
  rays in ``tile_order`` (``ray_order``: by default most live checkpoint
  segments first, a count the checkpointing kernels write, as the TPU
  wrapper's cost-ordered tiles, pallas_kernel.py:1568-1589), which changes
  no per-ray output.  Their scalar cotangents and the (K, 4) sphere
  cotangent are summed per block in a fixed tree and then across blocks in
  a fixed order, so they are the same bit for bit from run to run.  The
  TPU-only machinery is not carried over: the 128-lane row layout, the
  padding and the VMEM tile sizing.  The forward kernels take the rays in
  input order under every ``tile_order``: sorting 32-ray tiles by their
  largest |x cross p|^2, as the TPU wrapper sorts its 128-ray rows, fills
  the blocks' warps but its key and sort cost more than that saves on an
  H100 (PERF.md).  A step computes the radius once: the endpoint's,
  which the next step's size reuses (``Ray::rad``), written with explicit
  roundings so a recompute from a checkpoint meets the same bits.  The
  Dormand-Prince forward kernels run 128-thread blocks, so a block holds
  few warps idle behind its slowest ray, and their controller takes no
  IEEE division, square root or power (the special-function unit's
  reciprocal, lg2 and ex2; the accept test on the squared error norm);
  the adjoint's recompute takes the same forms, so it makes the same
  decisions.

``integrate_plain`` is the plain PyTorch version of ``integrate_cuda``
(ops/integrate.py's loops, the checkpointed ones under autograd), and
``integrate_ckpt_plain`` and ``integrate_adaptive_ckpt_plain`` those of the
checkpoints; they share no code with the kernels.  ``integrate`` takes them
only for tensors on the CPU.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from ..utils.profiling import annotate
from . import _build
from .adjoint import NSCAL, Controller
from .integrate import (
    GeodesicEnv,
    IntegratorConfig,
    _dopri_trip,
    _fixed_step,
    dopri_h0,
    integrate_adaptive,
    integrate_adaptive_scan,
    integrate_fixed,
    integrate_fixed_fast,
    needs_grad,
)
from .states import ACTIVE, RayState

MAX_SEG = 64   # the adjoints' tape length (csrc/rk4_bwd.cu, dopri_bwd.cu)
N_GRAD = 5     # scalar cotangents per block row (csrc/rk4_bwd.cu kNGrad)
N_GRAD_DOPRI = 2   # ... of dopri_bwd.cu: mass and spin

# Launches of each kernel variant since import (or since a caller cleared
# them), by variant name (``variant``); a wrapper adds one right where it
# launches its kernel, and nowhere else.
LAUNCHES: collections.Counter[str] = collections.Counter()


def variant(kernel: str, kerr: bool, events: bool) -> str:
    """The name of a kernel's variant: ``kernel`` ("rk4_fwd", "rk4_ckpt",
    "rk4_bwd", "dopri_fwd", "dopri_ckpt" or "dopri_bwd"), then "_kerr" for
    a Kerr hole and "_events" for a disk or spheres, e.g.
    "rk4_bwd_kerr_events"."""
    return kernel + ("_kerr" if kerr else "") + ("_events" if events else "")


def integrate_plain(env: GeodesicEnv, s0: RayState,
                    cfg: IntegratorConfig) -> RayState:
    """Plain PyTorch version of ``integrate_cuda``: the checkpointed step
    or trip loop when autograd records the call, the early-exit loop
    otherwise."""
    grad = needs_grad(env, s0)
    if cfg.method == "dopri":
        if grad:
            return integrate_adaptive_scan(env, s0, cfg)
        return integrate_adaptive(env, s0, cfg)[0]
    if grad:
        return integrate_fixed(env, s0, cfg)
    return integrate_fixed_fast(env, s0, cfg)


def segment(n_steps: int) -> int:
    """Steps between checkpoints of the gradient kernels: the TPU wrapper's
    rule (pallas_kernel.py:1519-1526), 16 doubled while seg^2 < n_steps,
    up to the adjoint's tape of MAX_SEG steps."""
    seg = 16
    while seg * seg < n_steps and seg < MAX_SEG:
        seg *= 2
    return seg


def integrate_ckpt_plain(env: GeodesicEnv, s0: RayState,
                         cfg: IntegratorConfig,
                         seg: int) -> tuple[RayState, list[RayState]]:
    """Plain PyTorch version of ``rk4_ckpt``: the final state and the
    states before steps 0, seg, 2 seg, ... of the step loop."""
    s, ckpts = s0, []
    for step in range(cfg.n_steps):
        if step % seg == 0:
            ckpts.append(s)
        s = _fixed_step(env, cfg, s)
    return s, ckpts


def integrate_adaptive_ckpt_plain(
        env: GeodesicEnv, s0: RayState, cfg: IntegratorConfig,
        seg: int) -> tuple[RayState, list[RayState], list[torch.Tensor]]:
    """Plain PyTorch version of ``dopri_ckpt``: the final state, and the
    states and per-ray steps h before trips 0, seg, 2 seg, ... of the trip
    loop."""
    s = s0
    h = torch.full(s0.E.shape, dopri_h0(cfg), dtype=s0.x.dtype,
                   device=s0.x.device)
    rows, hs = [], []
    for trip in range(cfg.n_steps):
        if trip % seg == 0:
            rows.append(s)
            hs.append(h)
        if bool(s.active.any()):   # else the trip is the identity
            s, h, _ = _dopri_trip(env, cfg, s, h)
    return s, rows, hs


def live_segments(cst: torch.Tensor) -> torch.Tensor:
    """Plain version of the (n,) uint8 count that rk4_ckpt and dopri_ckpt
    write beside the checkpoints: each ray's ACTIVE rows of ``cst`` (n_seg,
    n) -- the segments the adjoint will recompute and sweep, which form a
    prefix -- capped at 255 to fit a byte."""
    return (cst == ACTIVE).sum(0).clamp(max=255).to(torch.uint8)


def ray_order(live: torch.Tensor, tile_order: str) -> torch.Tensor:
    """The (n,) int64 order in which an adjoint's threads take the rays:
    thread t takes ray order[t].  ``tile_order="cost"`` (the JAX package's
    switch, IntegratorConfig.tile_order) sorts the rays by ``live``, their
    count of live segments (live_segments), most first; the sort is
    stable, so rays of one count keep their input order and the order is
    the same from run to run.  ``"none"`` is the input order."""
    if tile_order == "none":
        return torch.arange(live.numel(), device=live.device)
    if tile_order != "cost":
        raise ValueError(f"unknown tile_order {tile_order!r}")
    return torch.sort(live, descending=True, stable=True).indices


def _scalars(env: GeodesicEnv, cfg: IntegratorConfig,
             device: torch.device) -> torch.Tensor:
    """The (NSCAL,) float32 device vector, TPU kernel layout:
    [mass, dt, dt_boost, r_ref, r_capture, r_escape, lam_max, r_in, r_out, a].
    Tensor entries (mass, r_escape, the disk radii, the spin) stay on the
    device and in the autograd graph: the mass cotangent of rk4_bwd reaches
    ``env.mass`` through entry 0, and through entry 3 when r_ref defaults
    to 6 M, and the spin cotangent reaches ``env.spin`` through entry 9.
    r_in and r_out are 0 without a disk, a is 0 without a spin.  A
    Dormand-Prince trip steps by its own h and reads no schedule: boost and
    r_ref are 1, as the TPU wrapper packs them (pallas_kernel.py:641-654)."""
    r_ref = cfg.dt_boost_r_ref or 6.0 * env.mass
    boost = cfg.dt_boost if cfg.dt_boost > 1.0 else 1.0
    if cfg.method == "dopri":
        r_ref, boost = 1.0, 1.0
    r_in, r_out = ((env.disk.r_in, env.disk.r_out) if env.disk is not None
                   else (0.0, 0.0))
    vals = (env.mass, cfg.dt, boost, r_ref, env.r_capture, env.r_escape,
            env.lam_max, r_in, r_out, 0.0 if env.spin is None else env.spin)
    return torch.stack([
        torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())
        for v in vals])


def _sphere_table(env: GeodesicEnv, device: torch.device) -> torch.Tensor:
    """The (K, 4) float32 sphere table [cx, cy, cz, radius] of the TPU
    kernel (pallas_kernel.py:1610-1617), in the autograd graph of the
    centres and radii; (0, 4) without spheres."""
    if env.spheres is None:
        return torch.zeros((0, 4), dtype=torch.float32, device=device)
    center = torch.as_tensor(env.spheres.center, dtype=torch.float32,
                             device=device)
    radius = torch.as_tensor(env.spheres.radius, dtype=torch.float32,
                             device=device)
    if center.dim() != 2 or center.shape[1] != 3 or radius.shape != (
            center.shape[0],):
        raise ValueError(f"spheres need centres (K, 3) and radii (K,); got "
                         f"{tuple(center.shape)} and {tuple(radius.shape)}")
    return torch.cat([center, radius[:, None]], dim=1).contiguous()


def _flat(t: torch.Tensor, batch, tail, dtype, name) -> torch.Tensor:
    """``t`` of shape batch + tail and type ``dtype``, as a contiguous
    (n,) + tail tensor for the kernel."""
    if tuple(t.shape) != tuple(batch) + tail:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(batch) + tail}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    return t.reshape((-1,) + tail).contiguous()


def _check_device(x: torch.Tensor, **others: torch.Tensor) -> None:
    """``x`` on a CUDA device and every other tensor on the same one."""
    if not x.is_cuda:
        raise ValueError("integrate_cuda needs tensors on a CUDA device; "
                         f"got {x.device}")
    for name, t in others.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


def _events(sph, has_disk) -> bool:
    return bool(has_disk) or sph.shape[0] > 0


def _no_spheres(x: torch.Tensor) -> torch.Tensor:
    return x.new_zeros((0, 4))


def rk4_fwd(scal, x, p, E, lam, st, n_steps: int, power: float, *,
            sph=None, has_disk=False, obj=None, kerr=False):
    """Launch rk4_fwd on flat (n, 3) / (n,) tensors; returns
    (x, p, lam, status, hit_obj) after ``n_steps`` steps.  ``sph`` is the
    (K, 4) sphere table and ``has_disk`` switches the disk events on (the
    event variant); ``obj`` the initial hit_obj (-1 when not given);
    ``kerr`` the Kerr variant, of spin ``scal[9]``."""
    sph = _no_spheres(x) if sph is None else sph.detach().contiguous()
    if obj is None:
        obj = torch.full_like(st, -1)
    x_out, p_out = torch.empty_like(x), torch.empty_like(p)
    lam_out, st_out = torch.empty_like(lam), torch.empty_like(st)
    obj_out = torch.empty_like(obj)
    n = E.numel()
    if n:
        with torch.cuda.device(x.device):
            rc = _build.load().bhgc_rk4_fwd(
                scal.data_ptr(), sph.data_ptr(), sph.shape[0], int(has_disk),
                int(kerr), x.data_ptr(), p.data_ptr(), E.data_ptr(),
                lam.data_ptr(), st.data_ptr(), obj.data_ptr(),
                x_out.data_ptr(), p_out.data_ptr(), lam_out.data_ptr(),
                st_out.data_ptr(), obj_out.data_ptr(), n, n_steps, power,
                _stream(x.device))
        _raise_on(rc, "rk4_fwd")
        LAUNCHES[variant("rk4_fwd", kerr, _events(sph, has_disk))] += 1
    return x_out, p_out, lam_out, st_out, obj_out


def rk4_ckpt(scal, x, p, E, lam, st, n_steps: int, seg: int, power: float,
             *, sph=None, has_disk=False, obj=None, kerr=False):
    """Launch rk4_ckpt on flat tensors; returns the final (x, p, lam,
    status, hit_obj) and the checkpoints (cx, cp, clam, cst), each of
    leading dimension n_seg = ceil(n_steps / seg), with each ray's live
    segments (live_segments).  ``sph``, ``has_disk``, ``obj`` and ``kerr``
    as for rk4_fwd."""
    sph = _no_spheres(x) if sph is None else sph.detach().contiguous()
    if obj is None:
        obj = torch.full_like(st, -1)
    n = E.numel()
    n_seg = -(-n_steps // seg)
    x_out, p_out = torch.empty_like(x), torch.empty_like(p)
    lam_out, st_out = torch.empty_like(lam), torch.empty_like(st)
    obj_out = torch.empty_like(obj)
    cx = x.new_empty((n_seg, n, 3))
    cp = p.new_empty((n_seg, n, 3))
    clam = lam.new_empty((n_seg, n))
    cst = st.new_empty((n_seg, n))
    live = torch.empty(n, dtype=torch.uint8, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            rc = _build.load().bhgc_rk4_ckpt(
                scal.data_ptr(), sph.data_ptr(), sph.shape[0], int(has_disk),
                int(kerr), x.data_ptr(), p.data_ptr(), E.data_ptr(),
                lam.data_ptr(), st.data_ptr(), obj.data_ptr(),
                x_out.data_ptr(), p_out.data_ptr(), lam_out.data_ptr(),
                st_out.data_ptr(), obj_out.data_ptr(), cx.data_ptr(),
                cp.data_ptr(), clam.data_ptr(), cst.data_ptr(),
                live.data_ptr(), n, n_steps, seg, power, _stream(x.device))
        _raise_on(rc, "rk4_ckpt")
        LAUNCHES[variant("rk4_ckpt", kerr, _events(sph, has_disk))] += 1
    return x_out, p_out, lam_out, st_out, obj_out, (cx, cp, clam, cst, live)


def rk4_bwd(scal, ckpts, E, gx, gp, n_steps: int, seg: int, power: float,
            *, sph=None, has_disk=False, kerr=False, tile_order="cost"):
    """Launch rk4_bwd: the cotangents (x, p, E) of the initial state, the
    (NSCAL,) scalar cotangent (the spin's at entry 9 for Kerr) and the
    (K, 4) sphere cotangent, from the checkpoints of rk4_ckpt and the
    cotangents ``gx``, ``gp`` of the final (x, p).  ``sph``, ``has_disk``
    and ``kerr`` as for rk4_ckpt; ``tile_order`` the order in which the
    threads take the rays (ray_order), which changes no per-ray cotangent
    and only the order of the scalar and sphere sums."""
    if not 1 <= seg <= MAX_SEG:
        raise ValueError(f"seg={seg} outside the adjoint's tape "
                         f"(1..{MAX_SEG} steps)")
    sph = _no_spheres(E) if sph is None else sph.detach().contiguous()
    n_sph = sph.shape[0]
    cx, cp, clam, cst, live = ckpts
    n = E.numel()
    bx, bp = torch.empty_like(gx), torch.empty_like(gp)
    bE = torch.empty_like(E)
    gscal = torch.zeros(NSCAL, dtype=torch.float32, device=E.device)
    gsph = torch.zeros((n_sph, 4), dtype=torch.float32, device=E.device)
    if n:
        lib = _build.load()
        partial = E.new_empty((lib.bhgc_rk4_bwd_blocks(n),
                               N_GRAD + 4 * n_sph))
        order = ray_order(live, tile_order)
        with torch.cuda.device(E.device):
            rc = lib.bhgc_rk4_bwd(
                scal.data_ptr(), sph.data_ptr(), n_sph, int(has_disk),
                int(kerr), cx.data_ptr(), cp.data_ptr(), clam.data_ptr(),
                cst.data_ptr(), E.data_ptr(), gx.data_ptr(), gp.data_ptr(),
                bx.data_ptr(), bp.data_ptr(), bE.data_ptr(),
                partial.data_ptr(), order.data_ptr(), gscal.data_ptr(),
                gsph.data_ptr(), n, n_steps, seg, power, _stream(E.device))
        _raise_on(rc, "rk4_bwd")
        LAUNCHES[variant("rk4_bwd", kerr, _events(sph, has_disk))] += 1
    return bx, bp, bE, gscal, gsph


class RK4Adjoint(torch.autograd.Function):
    """(x, p, E, scal, sph) -> final (x, p, lam, status, hit_obj) through
    rk4_ckpt, with rk4_bwd as the backward: the custom VJP of
    pallas_kernel.py:1467-1491.

    lam, status and hit_obj are not differentiable; the scalar cotangent
    has zeros for r_capture, r_escape, lam_max, r_in and r_out, which enter
    the step only through comparisons, and for Kerr the spin's at entry 9;
    ``sph`` (the (K, 4) sphere table) gets the sphere cotangent.  The
    backward runs in the profiler span ``bhgc.integrate.backward``."""

    @staticmethod
    def forward(ctx, x, p, E, scal, sph, lam, st, obj, has_disk, kerr,
                n_steps, seg, power, tile_order):
        x1, p1, lam1, st1, obj1, ckpts = rk4_ckpt(
            scal, x, p, E, lam, st, n_steps, seg, power, sph=sph,
            has_disk=has_disk, obj=obj, kerr=kerr)
        ctx.save_for_backward(scal, sph, E, *ckpts)
        ctx.schedule = (n_steps, seg, power)
        ctx.variant = dict(has_disk=has_disk, kerr=kerr,
                           tile_order=tile_order)
        ctx.mark_non_differentiable(lam1, st1, obj1)
        return x1, p1, lam1, st1, obj1

    @staticmethod
    def backward(ctx, gx, gp, _glam, _gst, _gobj):
        with annotate("bhgc.integrate.backward"):
            scal, sph, E, *ckpts = ctx.saved_tensors
            n = E.numel()
            gx = E.new_zeros((n, 3)) if gx is None else gx.contiguous()
            gp = E.new_zeros((n, 3)) if gp is None else gp.contiguous()
            bx, bp, bE, gscal, gsph = rk4_bwd(scal, ckpts, E, gx, gp,
                                              *ctx.schedule, sph=sph,
                                              **ctx.variant)
            return (bx, bp, bE, gscal, gsph) + (None,) * 9


def controller(cfg: IntegratorConfig) -> Controller:
    """The controller constants the Dormand-Prince kernels take; an
    infinite max_step goes in as 1e30, as the TPU wrapper passes it
    (pallas_kernel.py:667)."""
    return Controller(float(cfg.rtol), float(cfg.atol), float(cfg.min_step),
                      min(float(cfg.max_step), 1e30))


def dopri_fwd(scal, x, p, E, h, lam, st, n_steps: int, ctl: Controller, *,
              sph=None, has_disk=False, obj=None, kerr=False):
    """Launch dopri_fwd on flat (n, 3) / (n,) tensors: up to ``n_steps``
    Dormand-Prince trips from the per-ray steps ``h``, controller
    ``ctl``.  Returns (x, p, lam, status, hit_obj); ``sph``,
    ``has_disk``, ``obj`` and ``kerr`` as for rk4_fwd."""
    sph = _no_spheres(x) if sph is None else sph.detach().contiguous()
    if obj is None:
        obj = torch.full_like(st, -1)
    x_out, p_out = torch.empty_like(x), torch.empty_like(p)
    lam_out, st_out = torch.empty_like(lam), torch.empty_like(st)
    obj_out = torch.empty_like(obj)
    n = E.numel()
    if n:
        with torch.cuda.device(x.device):
            rc = _build.load().bhgc_dopri_fwd(
                scal.data_ptr(), sph.data_ptr(), sph.shape[0], int(has_disk),
                int(kerr), x.data_ptr(), p.data_ptr(), E.data_ptr(),
                h.data_ptr(), lam.data_ptr(), st.data_ptr(), obj.data_ptr(),
                x_out.data_ptr(), p_out.data_ptr(), lam_out.data_ptr(),
                st_out.data_ptr(), obj_out.data_ptr(), n, n_steps, *ctl,
                _stream(x.device))
        _raise_on(rc, "dopri_fwd")
        LAUNCHES[variant("dopri_fwd", kerr, _events(sph, has_disk))] += 1
    return x_out, p_out, lam_out, st_out, obj_out


def dopri_ckpt(scal, x, p, E, h, lam, st, n_steps: int, seg: int,
               ctl: Controller, *, sph=None, has_disk=False, obj=None,
               kerr=False):
    """Launch dopri_ckpt on flat tensors; returns the final (x, p, lam,
    status, hit_obj) and the checkpoints (cx, cp, ch, clam, cst) before
    trips 0, seg, 2 seg, ..., each of leading dimension ceil(n_steps /
    seg), with each ray's live segments (live_segments).  Arguments as for
    dopri_fwd."""
    sph = _no_spheres(x) if sph is None else sph.detach().contiguous()
    if obj is None:
        obj = torch.full_like(st, -1)
    n = E.numel()
    n_seg = -(-n_steps // seg)
    x_out, p_out = torch.empty_like(x), torch.empty_like(p)
    lam_out, st_out = torch.empty_like(lam), torch.empty_like(st)
    obj_out = torch.empty_like(obj)
    cx, cp = x.new_empty((n_seg, n, 3)), p.new_empty((n_seg, n, 3))
    ch, clam = h.new_empty((n_seg, n)), lam.new_empty((n_seg, n))
    cst = st.new_empty((n_seg, n))
    live = torch.empty(n, dtype=torch.uint8, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            rc = _build.load().bhgc_dopri_ckpt(
                scal.data_ptr(), sph.data_ptr(), sph.shape[0], int(has_disk),
                int(kerr), x.data_ptr(), p.data_ptr(), E.data_ptr(),
                h.data_ptr(), lam.data_ptr(), st.data_ptr(), obj.data_ptr(),
                x_out.data_ptr(), p_out.data_ptr(), lam_out.data_ptr(),
                st_out.data_ptr(), obj_out.data_ptr(), cx.data_ptr(),
                cp.data_ptr(), ch.data_ptr(), clam.data_ptr(), cst.data_ptr(),
                live.data_ptr(), n, n_steps, seg, *ctl, _stream(x.device))
        _raise_on(rc, "dopri_ckpt")
        LAUNCHES[variant("dopri_ckpt", kerr, _events(sph, has_disk))] += 1
    ckpts = (cx, cp, ch, clam, cst, live)
    return x_out, p_out, lam_out, st_out, obj_out, ckpts


def dopri_bwd(scal, ckpts, E, gx, gp, n_steps: int, seg: int,
              ctl: Controller, *, sph=None, has_disk=False, kerr=False,
              tile_order="cost"):
    """Launch dopri_bwd: the cotangents (x, p, E) of the initial state, the
    (NSCAL,) scalar cotangent (the mass's and, for Kerr, the spin's at
    entry 9) and the (K, 4) sphere cotangent, from the checkpoints of
    dopri_ckpt and the cotangents ``gx``, ``gp`` of the final (x, p).  The
    initial h is a constant: its cotangent is dropped.  ``tile_order`` as
    for rk4_bwd."""
    if not 1 <= seg <= MAX_SEG:
        raise ValueError(f"seg={seg} outside the adjoint's tape "
                         f"(1..{MAX_SEG} trips)")
    sph = _no_spheres(E) if sph is None else sph.detach().contiguous()
    n_sph = sph.shape[0]
    cx, cp, ch, clam, cst, live = ckpts
    n = E.numel()
    bx, bp = torch.empty_like(gx), torch.empty_like(gp)
    bE = torch.empty_like(E)
    gscal = torch.zeros(NSCAL, dtype=torch.float32, device=E.device)
    gsph = torch.zeros((n_sph, 4), dtype=torch.float32, device=E.device)
    if n:
        lib = _build.load()
        partial = E.new_empty((lib.bhgc_dopri_bwd_blocks(n),
                               N_GRAD_DOPRI + 4 * n_sph))
        order = ray_order(live, tile_order)
        with torch.cuda.device(E.device):
            rc = lib.bhgc_dopri_bwd(
                scal.data_ptr(), sph.data_ptr(), n_sph, int(has_disk),
                int(kerr), cx.data_ptr(), cp.data_ptr(), ch.data_ptr(),
                clam.data_ptr(), cst.data_ptr(), E.data_ptr(), gx.data_ptr(),
                gp.data_ptr(), bx.data_ptr(), bp.data_ptr(), bE.data_ptr(),
                partial.data_ptr(), order.data_ptr(), gscal.data_ptr(),
                gsph.data_ptr(), n, n_steps, seg, *ctl, _stream(E.device))
        _raise_on(rc, "dopri_bwd")
        LAUNCHES[variant("dopri_bwd", kerr, _events(sph, has_disk))] += 1
    return bx, bp, bE, gscal, gsph


class DopriAdjoint(torch.autograd.Function):
    """(x, p, E, scal, sph) -> final (x, p, lam, status, hit_obj) through
    dopri_ckpt, with dopri_bwd as the backward: the custom VJP of
    ``_build_dopri_grad`` (pallas_kernel.py:995-1021).  The per-ray
    initial step ``h`` is an input without a gradient (a constant of the
    configuration); lam, status and hit_obj are not differentiable.  The
    backward runs in the profiler span ``bhgc.integrate.backward``."""

    @staticmethod
    def forward(ctx, x, p, E, scal, sph, h, lam, st, obj, has_disk, kerr,
                n_steps, seg, ctl, tile_order):
        x1, p1, lam1, st1, obj1, ckpts = dopri_ckpt(
            scal, x, p, E, h, lam, st, n_steps, seg, ctl, sph=sph,
            has_disk=has_disk, obj=obj, kerr=kerr)
        ctx.save_for_backward(scal, sph, E, *ckpts)
        ctx.schedule = (n_steps, seg, ctl)
        ctx.variant = dict(has_disk=has_disk, kerr=kerr,
                           tile_order=tile_order)
        ctx.mark_non_differentiable(lam1, st1, obj1)
        return x1, p1, lam1, st1, obj1

    @staticmethod
    def backward(ctx, gx, gp, _glam, _gst, _gobj):
        with annotate("bhgc.integrate.backward"):
            scal, sph, E, *ckpts = ctx.saved_tensors
            n = E.numel()
            gx = E.new_zeros((n, 3)) if gx is None else gx.contiguous()
            gp = E.new_zeros((n, 3)) if gp is None else gp.contiguous()
            bx, bp, bE, gscal, gsph = dopri_bwd(scal, ckpts, E, gx, gp,
                                                *ctx.schedule, sph=sph,
                                                **ctx.variant)
            return (bx, bp, bE, gscal, gsph) + (None,) * 10


def integrate_cuda(env: GeodesicEnv, s0: RayState,
                   cfg: IntegratorConfig) -> RayState:
    """Integrate ``s0`` with the CUDA kernels; any batch shape.

    Same env/state/config as ``integrate_plain``; the result is the state
    after ``cfg.n_steps`` steps or trips (rays frozen at their
    termination).  When autograd records the call it goes through
    ``RK4Adjoint`` (rk4_ckpt, and rk4_bwd in the backward) or, for
    ``method="dopri"``, ``DopriAdjoint`` (dopri_ckpt, dopri_bwd);
    otherwise through rk4_fwd or dopri_fwd."""
    if cfg.method not in ("rk4", "dopri"):
        raise ValueError(f"unknown integrator method {cfg.method!r}")
    batch = s0.E.shape
    if s0.E.numel() >= 2**31:
        raise ValueError(f"too many rays for one launch: {s0.E.numel()}")
    x = _flat(s0.x, batch, (3,), torch.float32, "x")
    p = _flat(s0.p, batch, (3,), torch.float32, "p")
    E = _flat(s0.E, batch, (), torch.float32, "E")
    lam = _flat(s0.lam, batch, (), torch.float32, "lam")
    st = _flat(s0.status, batch, (), torch.int32, "status")
    obj = _flat(s0.hit_obj, batch, (), torch.int32, "hit_obj")
    _check_device(x, p=p, E=E, lam=lam, status=st, hit_obj=obj)
    scal = _scalars(env, cfg, x.device)
    sph = _sphere_table(env, x.device)
    has_disk, kerr = env.disk is not None, env.spin is not None
    n_steps, power = int(cfg.n_steps), float(cfg.dt_power)

    if cfg.method == "dopri":
        h = torch.full_like(E, dopri_h0(cfg))
        ctl = controller(cfg)
        if needs_grad(env, s0):
            x1, p1, lam1, st1, obj1 = DopriAdjoint.apply(
                x, p, E, scal, sph, h, lam, st, obj, has_disk, kerr, n_steps,
                segment(n_steps), ctl, cfg.tile_order)
        else:
            x1, p1, lam1, st1, obj1 = dopri_fwd(
                scal, x, p, E, h, lam, st, n_steps, ctl, sph=sph,
                has_disk=has_disk, obj=obj, kerr=kerr)
    elif needs_grad(env, s0):
        x1, p1, lam1, st1, obj1 = RK4Adjoint.apply(
            x, p, E, scal, sph, lam, st, obj, has_disk, kerr, n_steps,
            segment(n_steps), power, cfg.tile_order)
    else:
        x1, p1, lam1, st1, obj1 = rk4_fwd(
            scal, x, p, E, lam, st, n_steps, power, sph=sph,
            has_disk=has_disk, obj=obj, kerr=kerr)
    return dataclasses.replace(
        s0, x=x1.reshape(batch + (3,)), p=p1.reshape(batch + (3,)),
        lam=lam1.reshape(batch), status=st1.reshape(batch),
        hit_obj=obj1.reshape(batch))
