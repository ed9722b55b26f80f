"""Plain Kerr geodesic integration: the frozen reference of the Kerr cells.

A copy of ``reference/integrate.py`` extended to a hole of spin ``a``
along +z, as the port's plain path (ops/geodesic.py, ops/integrate.py,
models/kerr.py) stood when the Kerr cell was written, cut to what the Kerr
configurations use: a z = 0 disk, no spheres, fixed-step RK4 with the
radius-proportional step.  It imports nothing of the program.

The spacetime is Kerr in Kerr-Schild Cartesian form, g = eta + 2H l l with

    H = M r^3 / (r^4 + a^2 z^2),
    l = (1, (r x + a y) / (r^2 + a^2), (r y - a x) / (r^2 + a^2), z / r),
    r^4 - (x^2 + y^2 + z^2 - a^2) r^2 - a^2 z^2 = 0,

and a photon follows the super-Hamiltonian Hh = 1/2 (-E^2 + |p|^2) - H (E
+ l.p)^2 with p_t = -E conserved, (x, p) evolved.  Departures from the
published equations, all the port's:

* the right-hand side is the hand-derived gradient of Hh (``kerr_rhs``),
  dr/dx_i by implicit differentiation; it equals the Hamiltonian's
  derivative up to float32 rounding;
* floors: r^2 >= 1e-12 and r S >= 1e-12 in the right-hand side, and r^2
  >= 1e-12 (before the square root) where the initial momentum and the
  final direction take H and l, so a ray frozen on or by the ring's disk
  (z = 0, x^2 + y^2 < a^2, where r^2 rounds to 0) stays finite, value and
  gradient;
* a ray is captured once its Kerr-Schild r is at most the outer horizon
  r_+ = M + sqrt(M^2 - a^2) at a step's end, or at half r_+ at one of its
  stage points (a step that sampled the interior that deep has crossed
  it),
  escapes at a fixed coordinate radius, and ends at an affine budget; the disk is hit where a straight step in
  these coordinates crosses z = 0 inside the annulus (the crossing
  linearly interpolated), as on the port's Schwarzschild path;
* the step grows with the Kerr-Schild r, dt (r / r_ref)^power up to a
  boost, the port's schedule;
* a step whose end is not finite freezes the ray as ERROR (shaded red),
  and the ray's cotangent passes through it, as in the port's adjoint
  kernel; plain autograd would meet an infinite partial there;
* float32, or the inputs' dtype for the control.

As in ``reference/``, each step runs only on the ACTIVE rays
(``_compact``), gathered and scattered back: a frozen ray is an identity
under a step, so no result changes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.utils.checkpoint

ACTIVE, CAPTURED, ESCAPED, BUDGET, DISK, OBJECT, INSIDE_HORIZON, ERROR = range(8)
_R2_FLOOR = 1e-12
_INF = float("inf")


@dataclasses.dataclass
class Env:
    """The spacetime and the termination and event geometry, in the hole's
    frame; ``disk`` is (r_in, r_out) or None."""

    mass: Any
    spin: Any
    r_capture: Any
    r_escape: Any
    lam_max: Any
    disk: tuple | None = None


@dataclasses.dataclass(frozen=True)
class Integrator:
    n_steps: int
    dt: float
    method: str = "rk4"
    dt_boost: float = 8.0
    dt_boost_r_ref: float = 0.0
    dt_power: float = 1.0


@dataclasses.dataclass
class State:
    x: torch.Tensor
    p: torch.Tensor
    E: torch.Tensor
    lam: torch.Tensor
    status: torch.Tensor
    hit_obj: torch.Tensor

    @property
    def active(self):
        return self.status == ACTIVE


def ks_r2(x, a):
    """The Kerr-Schild r^2 of points x (..., 3), unfloored."""
    rho2 = torch.sum(x * x, dim=-1)
    z2 = x[..., 2] * x[..., 2]
    b = rho2 - a * a
    return 0.5 * (b + torch.sqrt(b * b + 4.0 * a * a * z2))


def ks_radius(x, a):
    """The Kerr-Schild r of points x (..., 3), unfloored."""
    return torch.sqrt(ks_r2(x, a))


def horizon(mass, a):
    """The outer horizon r_+ = M + sqrt(M^2 - a^2)."""
    return mass + torch.sqrt(torch.clamp_min(mass * mass - a * a, 0.0))


def _fields(x, mass, a):
    """(2H, l) at x with r^2 floored at 1e-12 before its square root."""
    r = torch.sqrt(torch.clamp_min(ks_r2(x, a), _R2_FLOOR))
    px, py, pz = x[..., 0], x[..., 1], x[..., 2]
    r2a2 = r * r + a * a
    l3 = torch.stack([(r * px + a * py) / r2a2, (r * py - a * px) / r2a2,
                      pz / r], dim=-1)
    H = mass * r ** 3 / (r ** 4 + a * a * pz * pz)
    return 2.0 * H, l3


def null_init(x, d, mass, a):
    """(p, E) of photons at x with unit coordinate velocity d: the null
    condition Hh = 0 with dx/dlambda = d."""
    q, l3 = _fields(x, mass, a)
    s = torch.sum(l3 * d, dim=-1)
    e2 = 1.0 - q * (1.0 - s * s)
    pos = e2 > 0
    E = torch.sqrt(torch.where(pos, e2, torch.ones_like(e2))) * pos
    w = (E + s) / (1.0 - q)
    return d + (q * w)[..., None] * l3, E


def start(env: Env, o, d) -> State:
    """The photons' initial state; those starting inside the capture
    radius are INSIDE_HORIZON."""
    p, E = null_init(o, d, env.mass, env.spin)
    batch = o.shape[:-1]
    status = torch.zeros(batch, dtype=torch.int32, device=o.device)
    status = status.masked_fill(ks_radius(o, env.spin) <= env.r_capture,
                                INSIDE_HORIZON)
    return State(x=o, p=p, E=E, lam=torch.zeros(batch, dtype=o.dtype,
                                                 device=o.device),
                 status=status,
                 hit_obj=torch.full(batch, -1, dtype=torch.int32,
                                    device=o.device))


def kerr_rhs(x, p, E, mass, a):
    """(dx, dp) = (dHh/dp, -dHh/dx): dx = p - q w l, dp = w^2 grad H + q w
    grad(l.p), q = 2H, w = E + l.p."""
    a0, a1, a2 = x[..., 0], x[..., 1], x[..., 2]
    b0, b1, b2 = p[..., 0], p[..., 1], p[..., 2]
    rho2 = a0 * a0 + a1 * a1 + a2 * a2
    bq = rho2 - a * a
    S = torch.sqrt(bq * bq + 4.0 * a * a * a2 * a2)
    r2 = torch.clamp_min(0.5 * (bq + S), _R2_FLOOR)
    r = torch.sqrt(r2)
    inv_rS = 1.0 / torch.clamp_min(r * S, _R2_FLOOR)
    az = a * a * a2
    dr0 = r2 * a0 * inv_rS
    dr1 = r2 * a1 * inv_rS
    dr2 = (r2 * a2 + az) * inv_rS

    A = r2 + a * a
    inv_A = 1.0 / A
    l0 = (r * a0 + a * a1) * inv_A
    l1 = (r * a1 - a * a0) * inv_A
    l2 = a2 / r
    D = r2 * r2 + az * a2
    inv_D = 1.0 / D
    H = mass * r * r2 * inv_D

    w = E + l0 * b0 + l1 * b1 + l2 * b2
    q = 2.0 * H

    hcoef = mass * (3.0 * r2 * D - 4.0 * r2 * r2 * r2) * inv_D * inv_D
    dH0 = hcoef * dr0
    dH1 = hcoef * dr1
    dH2 = hcoef * dr2 - 2.0 * mass * az * r * r2 * inv_D * inv_D

    twoR_A2 = 2.0 * r * inv_A * inv_A
    n0 = r * a0 + a * a1
    n1 = r * a1 - a * a0
    inv_r2 = 1.0 / r2
    dw0 = (b0 * ((dr0 * a0 + r) * inv_A - n0 * twoR_A2 * dr0)
           + b1 * ((dr0 * a1 - a) * inv_A - n1 * twoR_A2 * dr0)
           + b2 * (-a2 * dr0 * inv_r2))
    dw1 = (b0 * ((dr1 * a0 + a) * inv_A - n0 * twoR_A2 * dr1)
           + b1 * ((dr1 * a1 + r) * inv_A - n1 * twoR_A2 * dr1)
           + b2 * (-a2 * dr1 * inv_r2))
    dw2 = (b0 * (dr2 * a0 * inv_A - n0 * twoR_A2 * dr2)
           + b1 * (dr2 * a1 * inv_A - n1 * twoR_A2 * dr2)
           + b2 * (1.0 / r - a2 * dr2 * inv_r2))

    w2 = w * w
    qw = q * w
    dx = torch.stack([b0 - qw * l0, b1 - qw * l1, b2 - qw * l2], dim=-1)
    dp = torch.stack([w2 * dH0 + qw * dw0, w2 * dH1 + qw * dw1,
                      w2 * dH2 + qw * dw2], dim=-1)
    return dx, dp


def xdot(x, p, E, mass, a):
    q, l3 = _fields(x, mass, a)
    w = E + torch.sum(l3 * p, dim=-1)
    return p - (q * w)[..., None] * l3


def final_direction(env: Env, s: State):
    v = xdot(s.x, s.p, s.E, env.mass, env.spin)
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               1e-20)


def rk4_step(env, x, p, E, dt):
    """The RK4 endpoint (x1, p1) and the positions of stages 2-4."""
    h = dt[..., None]
    m, a = env.mass, env.spin
    k1x, k1p = kerr_rhs(x, p, E, m, a)
    xa = x + 0.5 * h * k1x
    k2x, k2p = kerr_rhs(xa, p + 0.5 * h * k1p, E, m, a)
    xb = x + 0.5 * h * k2x
    k3x, k3p = kerr_rhs(xb, p + 0.5 * h * k2p, E, m, a)
    xc = x + h * k3x
    k4x, k4p = kerr_rhs(xc, p + h * k3p, E, m, a)
    sixth = 1.0 / 6.0
    return (x + h * sixth * (k1x + 2.0 * (k2x + k3x) + k4x),
            p + h * sixth * (k1p + 2.0 * (k2p + k3p) + k4p), (xa, xb, xc))


def disk_event(env, x0, x1):
    r_in, r_out = env.disk
    z0, z1 = x0[..., 2], x1[..., 2]
    crossed = ((z1 < 0) & (z0 >= 0)) | ((z1 > 0) & (z0 <= 0))
    denom = z1 - z0
    t = -z0 / torch.where(torch.abs(denom) > 0, denom, torch.ones_like(denom))
    pt = x0 + (x1 - x0) * t[..., None]
    rr = torch.sqrt(pt[..., 0] ** 2 + pt[..., 1] ** 2)
    hit = crossed & (rr >= r_in) & (rr <= r_out)
    pt = torch.cat([pt[..., :2], torch.zeros_like(pt[..., 2:])], dim=-1)
    return torch.where(hit, t, _INF), pt


def apply_events(env: Env, s: State, x1, p1, dt, finite, inside) -> State:
    """Classify the step x -> x1: BUDGET, ESCAPED, CAPTURED, ERROR (where
    the step's end is not ``finite``), then a disk crossing, then CAPTURED
    where the step sampled the horizon's interior (``inside``) and ended
    finite; a disk ray freezes at the interpolated crossing."""
    active = s.active
    if env.disk is not None:
        t_disk, disk_pt = disk_event(env, s.x, x1)
    r1 = ks_radius(x1, env.spin)
    lam1 = s.lam + dt
    status = torch.full_like(s.status, ACTIVE)
    status = status.masked_fill(lam1 >= env.lam_max, BUDGET)
    status = status.masked_fill(r1 >= env.r_escape, ESCAPED)
    status = status.masked_fill(r1 <= env.r_capture, CAPTURED)
    status = status.masked_fill(~finite, ERROR)
    if env.disk is not None:
        status = status.masked_fill(torch.isfinite(t_disk), DISK)
    status = status.masked_fill(inside & finite, CAPTURED)
    status = torch.where(active, status, s.status)
    upd = (active & finite)[..., None]
    x = torch.where(upd, x1, s.x)
    lam = torch.where(active, lam1, s.lam)
    if env.disk is not None:
        sel = active & (status == DISK)
        td = torch.where(torch.isfinite(t_disk), t_disk, 0.0)
        x = torch.where(sel[..., None], disk_pt, x)
        lam = torch.where(sel, s.lam + dt * td, lam)
    return State(x=x, p=torch.where(upd, p1, s.p), E=s.E, lam=lam,
                 status=status, hit_obj=s.hit_obj)


def dt_eff(env: Env, cfg: Integrator, s: State):
    dt = torch.where(s.active, cfg.dt, 0.0).to(s.x.dtype)
    if cfg.dt_boost > 1.0:
        r_ref = cfg.dt_boost_r_ref or 6.0 * env.mass
        ratio = ks_radius(s.x, env.spin) / r_ref
        if cfg.dt_power == 1.5:
            ratio = ratio * torch.sqrt(torch.clamp_min(ratio, 0.0))
        elif cfg.dt_power == 2.0:
            ratio = ratio * ratio
        elif cfg.dt_power != 1.0:
            ratio = torch.clamp_min(ratio, 1e-20) ** cfg.dt_power
        dt = dt * torch.clamp(ratio, 1.0, cfg.dt_boost)
    return dt


def fixed_step(env: Env, cfg: Integrator, s: State) -> State:
    """One RK4 step and its events.  A step one of whose stage points lies
    within half the capture radius has crossed the horizon: the ray is
    CAPTURED wherever the endpoint lands (towards the ring singularity a
    stage's right-hand side can throw it out again with a state no photon
    has).  A step whose end is not finite freezes the ray as ERROR, and
    its cotangent passes through the step untouched, as the adjoint
    kernel's does: the step is redone with those rays at rest far from the
    hole, so that autograd meets no infinite partial, and their end is
    their start."""
    dt = dt_eff(env, cfg, s)
    x1, p1, stages = rk4_step(env, s.x, s.p, s.E, dt)
    deep = 0.5 * env.r_capture
    inside = functools.reduce(torch.logical_or, (
        ks_radius(xs, env.spin) <= deep for xs in stages))
    finite = torch.isfinite(x1).all(dim=-1) & torch.isfinite(p1).all(dim=-1)
    if not bool(finite.all()):
        ok = finite[..., None]
        far = torch.full_like(s.x, 1e3)
        x1, p1, _ = rk4_step(env, torch.where(ok, s.x, far), s.p, s.E, dt)
        x1 = torch.where(ok, x1, s.x.detach())
        p1 = torch.where(ok, p1, s.p.detach())
    return apply_events(env, s, x1, p1, dt, finite, inside)


_FIELDS = ("x", "p", "E", "lam", "status", "hit_obj")


def _compact(s: State, idx):
    return State(*(getattr(s, f)[idx] for f in _FIELDS))


def _scatter(s: State, idx, sub: State) -> State:
    return State(*(getattr(s, f).index_put((idx,), getattr(sub, f))
                   for f in _FIELDS))


def _run(env, cfg, n, *fields):
    """``n`` steps of the live rays from the state ``fields``; the unit
    that ``torch.utils.checkpoint`` recomputes."""
    s = State(*fields)
    for _ in range(n):
        idx = torch.nonzero(s.active).squeeze(-1)
        if idx.numel() == 0:
            break
        s = _scatter(s, idx, fixed_step(env, cfg, _compact(s, idx)))
    return tuple(getattr(s, f) for f in _FIELDS)


def integrate(env: Env, cfg: Integrator, s: State,
              segment: int = 0) -> State:
    """The state after ``cfg.n_steps`` RK4 steps (rays frozen at their
    end), for a flat batch.  ``segment`` > 0 runs the loop in pieces of
    that many steps under ``torch.utils.checkpoint``, so that autograd
    keeps one piece's tensors at a time."""
    if cfg.method != "rk4":
        raise ValueError("the Kerr reference integrates rk4 only")
    fields = tuple(getattr(s, f) for f in _FIELDS)
    seg = segment if segment > 0 and torch.is_grad_enabled() else cfg.n_steps
    done = 0
    while done < cfg.n_steps and bool((fields[4] == ACTIVE).any()):
        n = min(seg, cfg.n_steps - done)
        if seg < cfg.n_steps:
            fields = torch.utils.checkpoint.checkpoint(
                _run, env, cfg, n, *fields, use_reentrant=False)
        else:
            fields = _run(env, cfg, n, *fields)
        done += n
    return State(*fields)
