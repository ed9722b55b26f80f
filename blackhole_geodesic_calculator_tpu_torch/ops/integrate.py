"""Batched geodesic integration (PyTorch port of ops/integrate.py).

The whole ray batch is stepped at once; every step classifies each ray
(horizon capture, escape from the domain, affine budget, non-finite state)
and freezes it in the carry, so a terminated ray is an exact identity under
all later steps.  Two integrators, each with a forward-only loop that stops
once no ray is ACTIVE and a checkpointed loop for autograd:

* fixed-step RK4 (``method="rk4"``): ``integrate_fixed_fast`` and
  ``integrate_fixed``;
* adaptive Dormand-Prince 5(4) with a per-ray step controller
  (``method="dopri"``, scipy's RK45 pair): ``integrate_adaptive`` and
  ``integrate_adaptive_scan``.  A trip is one attempt: an accepted one
  advances the ray, a rejected one only shrinks its step.

``integrate`` dispatches between the hand-written CUDA kernels
(ops/cuda_kernel.py) for tensors on a CUDA device and these plain PyTorch
loops for tensors on the CPU, by whether autograd records the call.

Schwarzschild and Kerr (``GeodesicEnv.spin``), forward and backward, with
the segment events of a z = 0 disk and of K spheres: a ray whose step
crosses the disk annulus or enters a sphere freezes at the interpolated
event point (DISK or OBJECT).  Kerr steps with the analytic right-hand side
``kerr_rhs`` and classifies and sizes steps by the Kerr-Schild radius (JAX
integrate.py:78-90).  Timelike rays raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.utils.checkpoint

from . import states
from ..models.kerr import ks_radius
from .geodesic import kerr_rhs, null_init, schwarzschild_rhs, xdot
from .states import RayState


# =============================================================================
# Environment: the spacetime, the termination geometry and the event geometry.
# =============================================================================
@dataclasses.dataclass
class DiskGeom:
    """z = 0 annulus accretion disk."""

    r_in: Any
    r_out: Any


@dataclasses.dataclass
class SphereGeom:
    """K scene spheres; centers (K, 3), radii (K,)."""

    center: Any
    radius: Any


@dataclasses.dataclass
class GeodesicEnv:
    """Physical parameters; None fields disable a feature."""

    mass: Any
    r_capture: Any
    r_escape: Any
    lam_max: Any
    spin: Any = None          # None -> Schwarzschild
    disk: DiskGeom | None = None
    spheres: SphereGeom | None = None

    def rhs(self, x3, p3, E):
        if self.spin is None:
            return schwarzschild_rhs(x3, p3, E, self.mass)
        return kerr_rhs(x3, p3, E, self.mass, self.spin)

    def radius(self, x3):
        if self.spin is None:
            return torch.sqrt(torch.sum(x3 * x3, dim=-1))
        return ks_radius(x3, self.spin)


# =============================================================================
# Static integrator configuration.
# =============================================================================
@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    n_steps: int = 512
    dt: float = 0.1
    method: str = "rk4"          # 'rk4' | 'dopri'
    mode: str = "scan"           # 'scan' | 'while'; the forward is the same
    # 'auto': the CUDA kernels for tensors on a CUDA device, the plain
    # PyTorch loops for tensors on the CPU; 'cuda' / 'torch' force a path.
    backend: str = "auto"
    # Checkpoint segment of the plain gradient loop; 0 -> sqrt(n_steps).
    # The CUDA gradient kernels pick their own (see cuda_kernel.segment).
    remat_segment: int = 0
    # Per-ray radius-proportional step growth:
    #   dt_eff = dt * clip((r/r_ref)^dt_power, 1, boost)
    dt_boost: float = 8.0
    dt_boost_r_ref: float = 0.0  # 0 -> 6 M (twice the photon sphere)
    dt_power: float = 1.0
    # Ray ordering: the TPU kernel's tiles, and on CUDA the order in which
    # the adjoint kernels' threads take the rays ('cost': most checkpoint
    # segments first; cuda_kernel.ray_order).  Per-ray outputs never depend
    # on it; the adjoints' scalar sums are taken in its order.
    tile_order: str = "cost"     # 'cost' | 'none'
    # Dormand-Prince controls: the error norm's tolerances and the clip of
    # the per-ray step; the first step is min(dt, max_step).
    rtol: float = 1e-5
    atol: float = 1e-8
    max_step: float = math.inf
    min_step: float = 1e-6


# =============================================================================
# Single steps.
# =============================================================================
def rk4_step(env: GeodesicEnv, x, p, E, dt):
    """Classic RK4 on the 6-dim (x, p) Hamiltonian system; dt is per-ray."""
    h = dt[..., None]

    k1x, k1p = env.rhs(x, p, E)
    k2x, k2p = env.rhs(x + 0.5 * h * k1x, p + 0.5 * h * k1p, E)
    k3x, k3p = env.rhs(x + 0.5 * h * k2x, p + 0.5 * h * k2p, E)
    k4x, k4p = env.rhs(x + h * k3x, p + h * k3p, E)

    sixth = 1.0 / 6.0
    x1 = x + h * sixth * (k1x + 2.0 * (k2x + k3x) + k4x)
    p1 = p + h * sixth * (k1p + 2.0 * (k2p + k3p) + k4p)
    return x1, p1


# Dormand-Prince 5(4) Butcher tableau (scipy's RK45 pair; JAX
# integrate.py:152-172).
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)
# the error weights b5 - b4 of the embedded pair (pallas_kernel.py:383-387)
_DP_E = tuple(b5 - b4 for b5, b4 in zip(_DP_B5, _DP_B4))


def dopri_step(env: GeodesicEnv, x, p, E, dt):
    """One embedded Dormand-Prince 5(4) step; dt is per-ray.  Returns the
    5th-order (x5, p5) and the embedded error estimate (ex, ep)."""
    h = dt[..., None]
    kx, kp = [], []
    for i in range(7):
        xi, pi = x, p
        for j, aij in enumerate(_DP_A[i]):
            xi = xi + h * aij * kx[j]
            pi = pi + h * aij * kp[j]
        dxi, dpi = env.rhs(xi, pi, E)
        kx.append(dxi)
        kp.append(dpi)

    def comb(ks, bs):
        out = 0.0
        for k, b in zip(ks, bs):
            if b != 0.0:
                out = out + b * k
        return out

    x5 = x + h * comb(kx, _DP_B5)
    p5 = p + h * comb(kp, _DP_B5)
    return x5, p5, h * comb(kx, _DP_E), h * comb(kp, _DP_E)


# =============================================================================
# Event detection on one segment x0 -> x1 (straight-segment semantics).
# =============================================================================
_INF = float("inf")


def _disk_event(env: GeodesicEnv, x0, x1):
    """First z = 0 crossing inside the annulus; (t in [0, 1] or inf, the
    crossing point with z = 0)."""
    z0, z1 = x0[..., 2], x1[..., 2]
    crossed = ((z1 < 0) & (z0 >= 0)) | ((z1 > 0) & (z0 <= 0))
    denom = z1 - z0
    t = -z0 / torch.where(torch.abs(denom) > 0, denom,
                          torch.ones_like(denom))
    pt = x0 + (x1 - x0) * t[..., None]
    rr = torch.sqrt(pt[..., 0] ** 2 + pt[..., 1] ** 2)
    hit = crossed & (rr >= env.disk.r_in) & (rr <= env.disk.r_out)
    pt = torch.cat([pt[..., :2], torch.zeros_like(pt[..., 2:])], dim=-1)
    return torch.where(hit, t, _INF), pt


def _sphere_events(env: GeodesicEnv, x0, x1):
    """Earliest sphere entry on the segment; (t or inf, point, sphere id or
    -1).  Ties go to the lowest sphere index."""
    c = env.spheres.center          # (K, 3)
    rad = env.spheres.radius        # (K,)
    d = (x1 - x0)[..., None, :]     # (..., 1, 3)
    o = x0[..., None, :] - c        # (..., K, 3)
    aa = torch.sum(d * d, dim=-1)
    bb = 2.0 * torch.sum(o * d, dim=-1)
    cc = torch.sum(o * o, dim=-1) - rad * rad
    disc = bb * bb - 4.0 * aa * cc
    # sqrt(max(disc, 0)) has a 0 * inf = NaN jacobian where clamped (every
    # ray that misses): the unselected branch gets a harmless argument so
    # zero cotangents stay zero
    sq = torch.sqrt(torch.where(disc > 0, disc, torch.ones_like(disc)))
    t = (-bb - sq) / torch.where(aa > 0, 2.0 * aa, torch.ones_like(aa))
    valid = (disc > 0) & (t >= 0.0) & (t <= 1.0)
    t = torch.where(valid, t, _INF)            # (..., K)
    t_best, k_best = torch.min(t, dim=-1)      # first index of the minimum
    hit = torch.isfinite(t_best)
    # the miss point x0 + 0 * inf would be NaN forward and backward
    t_pt = torch.where(hit, t_best, torch.zeros_like(t_best))
    pt = x0 + (x1 - x0) * t_pt[..., None]
    obj = torch.where(hit, k_best, -1).to(torch.int32)
    return t_best, pt, obj


def _apply_events(env: GeodesicEnv, s: RayState, x1, p1, dt) -> RayState:
    """Classify the step x -> x1 and merge it into the frozen-state carry.

    Priority, lowest first: BUDGET, ESCAPED, CAPTURED, ERROR; then a sphere
    hit (OBJECT), then a disk crossing (DISK) that comes no later on the
    segment than the sphere hit.  A ray whose step is non-finite keeps its
    old x and p.  Event rays freeze at the interpolated event point: x is
    that point (z = 0 on the disk), lam gets the fraction of the step and
    p is the step's endpoint momentum.
    """
    active = s.active

    t_disk = _INF
    if env.disk is not None:
        t_disk, disk_pt = _disk_event(env, s.x, x1)
    t_sph = _INF
    if env.spheres is not None:
        t_sph, sph_pt, sph_obj = _sphere_events(env, s.x, x1)

    r1 = env.radius(x1)
    lam1 = s.lam + dt
    finite = (torch.isfinite(x1).all(dim=-1)
              & torch.isfinite(p1).all(dim=-1))
    captured = r1 <= env.r_capture
    escaped = r1 >= env.r_escape
    budget = lam1 >= env.lam_max

    status = torch.full_like(s.status, states.ACTIVE)
    status = status.masked_fill(budget, states.BUDGET)
    status = status.masked_fill(escaped, states.ESCAPED)
    status = status.masked_fill(captured, states.CAPTURED)
    status = status.masked_fill(~finite, states.ERROR)
    if env.spheres is not None:
        status = status.masked_fill(torch.isfinite(t_sph), states.OBJECT)
    if env.disk is not None:
        disk_wins = torch.isfinite(t_disk) & (t_disk <= t_sph)
        status = status.masked_fill(disk_wins, states.DISK)
    status = torch.where(active, status, s.status)

    upd = (active & finite)[..., None]
    x = torch.where(upd, x1, s.x)
    lam = torch.where(active, lam1, s.lam)
    hit_obj = s.hit_obj
    if env.spheres is not None:
        sel = active & (status == states.OBJECT)
        ts = torch.where(torch.isfinite(t_sph), t_sph, 0.0)
        x = torch.where(sel[..., None], sph_pt, x)
        lam = torch.where(sel, s.lam + dt * ts, lam)
        hit_obj = torch.where(sel, sph_obj, hit_obj)
    if env.disk is not None:
        sel = active & (status == states.DISK)
        td = torch.where(torch.isfinite(t_disk), t_disk, 0.0)
        x = torch.where(sel[..., None], disk_pt, x)
        lam = torch.where(sel, s.lam + dt * td, lam)
    return dataclasses.replace(
        s, x=x, p=torch.where(upd, p1, s.p), lam=lam, status=status,
        hit_obj=hit_obj)


# =============================================================================
# Step loop and dispatch.
# =============================================================================
def _dt_eff(env: GeodesicEnv, cfg: IntegratorConfig, s: RayState):
    dt = torch.where(s.active, cfg.dt, 0.0).to(s.x.dtype)
    if cfg.dt_boost > 1.0:
        r_ref = cfg.dt_boost_r_ref or 6.0 * env.mass
        r = env.radius(s.x)
        ratio = r / r_ref
        if cfg.dt_power == 1.5:          # cheap sqrt form of the hot case
            ratio = ratio * torch.sqrt(torch.clamp_min(ratio, 0.0))
        elif cfg.dt_power == 2.0:
            ratio = ratio * ratio
        elif cfg.dt_power != 1.0:
            ratio = torch.clamp_min(ratio, 1e-20) ** cfg.dt_power
        dt = dt * torch.clamp(ratio, 1.0, cfg.dt_boost)
    return dt


def _fixed_step(env: GeodesicEnv, cfg: IntegratorConfig,
                s: RayState) -> RayState:
    dt = _dt_eff(env, cfg, s)
    x1, p1 = rk4_step(env, s.x, s.p, s.E, dt)
    return _apply_events(env, s, x1, p1, dt)


def integrate_fixed_fast(env: GeodesicEnv, s0: RayState,
                         cfg: IntegratorConfig) -> RayState:
    """RK4 step loop that stops once no ray is ACTIVE.

    A frozen ray is an exact identity under the step, so stopping early
    gives the same result as running all ``cfg.n_steps`` steps."""
    s = s0
    for _ in range(cfg.n_steps):
        if not bool(s.active.any()):
            break
        s = _fixed_step(env, cfg, s)
    return s


def _steps(env, cfg, n, x, p, E, lam, status, hit_obj):
    """``n`` steps from the given state, as a function of tensors (the unit
    ``torch.utils.checkpoint`` recomputes)."""
    s = RayState(x=x, p=p, E=E, lam=lam, status=status, hit_obj=hit_obj)
    for _ in range(n):
        s = _fixed_step(env, cfg, s)
    return s.x, s.p, s.E, s.lam, s.status, s.hit_obj


def _segmented(run, n_steps: int, seg: int, carry):
    """``run(n, *carry)`` for exactly ``n_steps`` steps: full segments of
    ``seg`` steps, each under ``torch.utils.checkpoint`` (its activations
    are recomputed in the backward pass instead of kept), then a tail of
    ``n_steps % seg`` steps that is not checkpointed."""
    n_full, rem = divmod(n_steps, seg)
    for _ in range(n_full):
        if seg > 1:
            carry = torch.utils.checkpoint.checkpoint(run, seg, *carry,
                                                      use_reentrant=False)
        else:
            carry = run(seg, *carry)
    return run(rem, *carry)


def integrate_fixed(env: GeodesicEnv, s0: RayState,
                    cfg: IntegratorConfig) -> RayState:
    """RK4 step loop for autograd, checkpointed in segments of
    ``cfg.remat_segment`` or sqrt(n_steps) steps (``_segmented``).  The
    forward equals ``integrate_fixed_fast``: a frozen ray is an identity
    under the step."""
    seg = cfg.remat_segment or max(1, int(cfg.n_steps ** 0.5))
    x, p, E, lam, st, obj = _segmented(
        functools.partial(_steps, env, cfg), cfg.n_steps, seg,
        (s0.x, s0.p, s0.E, s0.lam, s0.status, s0.hit_obj))
    return RayState(x=x, p=p, E=E, lam=lam, status=st, hit_obj=obj)


def _clip(v, lo: float, hi: float):
    """``jnp.clip``: a maximum, then a minimum, each splitting the gradient
    of a tie in two as ``jax.vjp`` does (``torch.clamp`` would pass it all
    at the bound); NaN passes through."""
    return torch.minimum(torch.maximum(v, v.new_tensor(lo)), v.new_tensor(hi))


def dopri_h0(cfg: IntegratorConfig) -> float:
    """The first step of every ray, min(dt, max_step): a constant of the
    configuration, so no cotangent reaches it."""
    return min(cfg.dt, cfg.max_step)


def _dopri_trip(env: GeodesicEnv, cfg: IntegratorConfig, s: RayState, h):
    """One Dormand-Prince trip of the batch (one body of JAX's
    ``integrate_adaptive`` loop, integrate.py:400-431): the embedded step
    of each ACTIVE ray, its scaled RMS error, accept or reject, the events
    of an accepted step, and the 0.2-power controller's next h, clipped to
    [min_step, max_step], for a ray still ACTIVE.  A frozen ray (dt = 0)
    keeps its state and h.  Returns (state, h, accepted)."""
    dt = torch.where(s.active, h, 0.0)
    x5, p5, ex, ep = dopri_step(env, s.x, s.p, s.E, dt)
    scale_x = cfg.atol + cfg.rtol * torch.maximum(s.x.abs(), x5.abs())
    scale_p = cfg.atol + cfg.rtol * torch.maximum(s.p.abs(), p5.abs())
    err2 = (((ex / scale_x) ** 2).sum(-1)
            + ((ep / scale_p) ** 2).sum(-1)) / 6.0
    # double-where guard: sqrt has an infinite derivative at 0, and frozen
    # rays (dt = 0) have exactly zero embedded error -- without the guard
    # the adjoint turns their zero cotangent into NaN
    pos = err2 > 0
    err = torch.where(pos, torch.sqrt(torch.where(pos, err2, 1.0)), 0.0)
    accept = ((err <= 1.0) | (h <= cfg.min_step)) & s.active
    s1 = _apply_events(env, s, x5, p5, dt)
    a3 = accept[..., None]
    s = RayState(x=torch.where(a3, s1.x, s.x), p=torch.where(a3, s1.p, s.p),
                 E=s.E, lam=torch.where(accept, s1.lam, s.lam),
                 status=torch.where(accept, s1.status, s.status),
                 hit_obj=torch.where(accept, s1.hit_obj, s.hit_obj))
    factor = _clip(0.9 * torch.where(err > 0, err, 1e-10) ** -0.2, 0.2, 5.0)
    h = torch.where(s.active, _clip(h * factor, cfg.min_step, cfg.max_step),
                    h)
    return s, h, accept


def integrate_adaptive(env: GeodesicEnv, s0: RayState,
                       cfg: IntegratorConfig):
    """Dormand-Prince 5(4) trip loop that stops once no ray is ACTIVE or
    after ``cfg.n_steps`` trips (JAX integrate.py:385-436).  A frozen ray
    is an exact identity under a trip, so stopping early changes nothing.
    Returns (final state, per-ray accepted-step counts)."""
    h = torch.full(s0.E.shape, dopri_h0(cfg), dtype=s0.x.dtype,
                   device=s0.x.device)
    nacc = torch.zeros(s0.E.shape, dtype=torch.int32, device=s0.x.device)
    s = s0
    for _ in range(cfg.n_steps):
        if not bool(s.active.any()):
            break
        s, h, accept = _dopri_trip(env, cfg, s, h)
        nacc = nacc + accept.to(torch.int32)
    return s, nacc


def _trips(env, cfg, n, x, p, E, lam, status, hit_obj, h):
    """``n`` Dormand-Prince trips, as a function of tensors (the unit
    ``torch.utils.checkpoint`` recomputes).  Once no ray is ACTIVE every
    later trip is the identity, values and gradients alike, and is not
    run."""
    s = RayState(x=x, p=p, E=E, lam=lam, status=status, hit_obj=hit_obj)
    for _ in range(n):
        if not bool(s.active.any()):
            break
        s, h, _ = _dopri_trip(env, cfg, s, h)
    return s.x, s.p, s.E, s.lam, s.status, s.hit_obj, h


def integrate_adaptive_scan(env: GeodesicEnv, s0: RayState,
                            cfg: IntegratorConfig) -> RayState:
    """Dormand-Prince for autograd (JAX integrate.py:439-499): exactly
    ``cfg.n_steps`` trips, checkpointed as ``integrate_fixed`` is, with the
    per-ray h in the carry, so the gradient is the exact discrete adjoint
    through the step controller.  The forward equals
    ``integrate_adaptive``'s; trips after the last ray froze are identities
    and are skipped (``_trips``)."""
    seg = cfg.remat_segment or max(1, int(cfg.n_steps ** 0.5))
    h = torch.full(s0.E.shape, dopri_h0(cfg), dtype=s0.x.dtype,
                   device=s0.x.device)
    x, p, E, lam, st, obj, _ = _segmented(
        functools.partial(_trips, env, cfg), cfg.n_steps, seg,
        (s0.x, s0.p, s0.E, s0.lam, s0.status, s0.hit_obj, h))
    return RayState(x=x, p=p, E=E, lam=lam, status=st, hit_obj=obj)


def needs_grad(env: GeodesicEnv, s0: RayState) -> bool:
    """Whether autograd records this integration: grad mode is on and an
    input of the step (state or environment, spin and sphere geometry
    included) requires a gradient."""
    if not torch.is_grad_enabled():
        return False
    leaves = [s0.x, s0.p, s0.E, s0.lam, env.mass, env.spin, env.r_capture,
              env.r_escape, env.lam_max]
    if env.spheres is not None:
        leaves += [env.spheres.center, env.spheres.radius]
    return any(isinstance(t, torch.Tensor) and t.requires_grad
               for t in leaves)


def _use_cuda(s0: RayState, cfg: IntegratorConfig) -> bool:
    if cfg.backend == "cuda":
        return True
    if cfg.backend == "torch":
        return False
    if cfg.backend == "auto":
        return s0.x.is_cuda
    raise ValueError(f"unknown integrator backend {cfg.backend!r}; "
                     "expected 'auto', 'cuda' or 'torch'")


def integrate(env: GeodesicEnv, s0: RayState,
              cfg: IntegratorConfig) -> RayState:
    """The state after ``cfg.n_steps`` steps (RK4) or trips (Dormand-Prince)
    of ``cfg.method``, through the CUDA kernels for tensors on a CUDA device
    and the plain loops for tensors on the CPU (``cfg.backend``)."""
    if cfg.method not in ("rk4", "dopri"):
        raise ValueError(f"unknown integrator method {cfg.method!r}; "
                         "expected 'rk4' or 'dopri'")
    from . import cuda_kernel

    if _use_cuda(s0, cfg):
        return cuda_kernel.integrate_cuda(env, s0, cfg)
    return cuda_kernel.integrate_plain(env, s0, cfg)


def launch(env: GeodesicEnv, x0, d0, cfg: IntegratorConfig,
           time_like: bool = False) -> RayState:
    """Init photons at x0 with unit coordinate velocities d0, then integrate.

    Rays starting inside the horizon are marked INSIDE_HORIZON immediately
    and never step.
    """
    if time_like:
        raise NotImplementedError("timelike (massive) rays are not ported yet")
    p0, E0 = null_init(x0, d0, env.mass, env.spin)
    s0 = states.init_state(x0, p0, E0)
    inside = env.radius(x0) <= env.r_capture
    s0.status = s0.status.masked_fill(inside, states.INSIDE_HORIZON)
    return integrate(env, s0, cfg)


def final_direction(env: GeodesicEnv, s: RayState) -> torch.Tensor:
    """Unit coordinate velocity at the final state (the background lookup
    direction)."""
    v = xdot(s.x, s.p, s.E, env.mass, env.spin)
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               1e-20)
