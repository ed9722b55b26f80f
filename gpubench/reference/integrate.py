"""Plain Schwarzschild geodesic integration: the frozen reference.

A copy of the port's plain CPU path (ops/geodesic.py, ops/integrate.py,
ops/states.py) as it stood when the benchmark was written, cut to what the
benchmark's configurations use: a Schwarzschild hole, a z = 0 disk and
emissive spheres, fixed-step RK4 with the radius-proportional step and
adaptive Dormand-Prince 5(4).  It imports nothing of the program.

One change of method, none of arithmetic: each step or trip runs only on
the rays still ACTIVE (``_compact``), gathered and scattered back.  A
frozen ray is an identity under a step in the port's loops too, so every
ray's result is the same; the loop is just cheaper on a frame where most
rays end early, and autograd keeps only the live rays' tensors.

Every tensor takes the dtype of the inputs, so the same code computes the
float32 reference and the bfloat16 control.
"""

from __future__ import annotations

import dataclasses
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
    frame; ``disk`` is (r_in, r_out) or None, ``spheres`` (centres (K, 3),
    radii (K,)) or None."""

    mass: Any
    r_capture: Any
    r_escape: Any
    lam_max: Any
    disk: tuple | None = None
    spheres: tuple | None = None


@dataclasses.dataclass(frozen=True)
class Integrator:
    n_steps: int
    dt: float
    method: str = "rk4"
    dt_boost: float = 8.0
    dt_boost_r_ref: float = 0.0
    dt_power: float = 1.0
    rtol: float = 1e-5
    atol: float = 1e-8
    max_step: float = math.inf
    min_step: float = 1e-6


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


def radius(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def null_init(x, d, mass):
    """(p, E) of photons at x with unit coordinate velocity d."""
    r2 = torch.clamp_min(torch.sum(x * x, dim=-1), _R2_FLOOR)
    inv_r = torch.rsqrt(r2)
    q, l3 = (2.0 * mass) * inv_r, x * inv_r[..., None]
    s = torch.sum(l3 * d, dim=-1)
    e2 = 1.0 - q * (1.0 - s * s)
    pos = e2 > 0
    E = torch.sqrt(torch.where(pos, e2, torch.ones_like(e2))) * pos
    w = (E + s) / (1.0 - q)
    return d + (q * w)[..., None] * l3, E


def start(env: Env, o, d) -> State:
    """The photons' initial state; those starting inside the capture
    radius are INSIDE_HORIZON."""
    p, E = null_init(o, d, env.mass)
    batch = o.shape[:-1]
    status = torch.zeros(batch, dtype=torch.int32, device=o.device)
    status = status.masked_fill(radius(o) <= env.r_capture, INSIDE_HORIZON)
    return State(x=o, p=p, E=E, lam=torch.zeros(batch, dtype=o.dtype,
                                                 device=o.device),
                 status=status,
                 hit_obj=torch.full(batch, -1, dtype=torch.int32,
                                    device=o.device))


def rhs(x, p, E, mass):
    r2 = torch.clamp_min(torch.sum(x * x, dim=-1), _R2_FLOOR)
    inv_r = torch.rsqrt(r2)
    inv_r2 = inv_r * inv_r
    n = x * inv_r[..., None]
    u = (2.0 * mass) * inv_r
    s = torch.sum(n * p, dim=-1)
    w = E + s
    dx = p - (u * w)[..., None] * n
    m_r2 = mass * inv_r2
    coef_p = 2.0 * m_r2 * w
    coef_n = m_r2 * w * (w + 2.0 * s)
    return dx, coef_p[..., None] * p - coef_n[..., None] * n


def xdot(x, p, E, mass):
    r2 = torch.clamp_min(torch.sum(x * x, dim=-1), _R2_FLOOR)
    inv_r = torch.rsqrt(r2)
    q, l3 = (2.0 * mass) * inv_r, x * inv_r[..., None]
    w = E + torch.sum(l3 * p, dim=-1)
    return p - (q * w)[..., None] * l3


def final_direction(env: Env, s: State):
    v = xdot(s.x, s.p, s.E, env.mass)
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               1e-20)


def rk4_step(env, x, p, E, dt):
    h = dt[..., None]
    k1x, k1p = rhs(x, p, E, env.mass)
    k2x, k2p = rhs(x + 0.5 * h * k1x, p + 0.5 * h * k1p, E, env.mass)
    k3x, k3p = rhs(x + 0.5 * h * k2x, p + 0.5 * h * k2p, E, env.mass)
    k4x, k4p = rhs(x + h * k3x, p + h * k3p, E, env.mass)
    sixth = 1.0 / 6.0
    return (x + h * sixth * (k1x + 2.0 * (k2x + k3x) + k4x),
            p + h * sixth * (k1p + 2.0 * (k2p + k3p) + k4p))


_DP_A = ((), (1 / 5,), (3 / 40, 9 / 40), (44 / 45, -56 / 15, 32 / 9),
         (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
         (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
         (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84))
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)
_DP_E = tuple(b5 - b4 for b5, b4 in zip(_DP_B5, _DP_B4))


def dopri_step(env, x, p, E, dt):
    h = dt[..., None]
    kx, kp = [], []
    for i in range(7):
        xi, pi = x, p
        for j, aij in enumerate(_DP_A[i]):
            xi = xi + h * aij * kx[j]
            pi = pi + h * aij * kp[j]
        dxi, dpi = rhs(xi, pi, E, env.mass)
        kx.append(dxi)
        kp.append(dpi)

    def comb(ks, bs):
        out = 0.0
        for k, b in zip(ks, bs):
            if b != 0.0:
                out = out + b * k
        return out

    return (x + h * comb(kx, _DP_B5), p + h * comb(kp, _DP_B5),
            h * comb(kx, _DP_E), h * comb(kp, _DP_E))


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


def sphere_events(env, x0, x1):
    c, rad = env.spheres
    d = (x1 - x0)[..., None, :]
    o = x0[..., None, :] - c
    aa = torch.sum(d * d, dim=-1)
    bb = 2.0 * torch.sum(o * d, dim=-1)
    cc = torch.sum(o * o, dim=-1) - rad * rad
    disc = bb * bb - 4.0 * aa * cc
    sq = torch.sqrt(torch.where(disc > 0, disc, torch.ones_like(disc)))
    t = (-bb - sq) / torch.where(aa > 0, 2.0 * aa, torch.ones_like(aa))
    valid = (disc > 0) & (t >= 0.0) & (t <= 1.0)
    t = torch.where(valid, t, _INF)
    t_best, k_best = torch.min(t, dim=-1)
    hit = torch.isfinite(t_best)
    t_pt = torch.where(hit, t_best, torch.zeros_like(t_best))
    pt = x0 + (x1 - x0) * t_pt[..., None]
    return t_best, pt, torch.where(hit, k_best, -1).to(torch.int32)


def apply_events(env: Env, s: State, x1, p1, dt) -> State:
    """Classify the step x -> x1: BUDGET, ESCAPED, CAPTURED, ERROR, then a
    sphere hit, then a disk crossing no later than it; event rays freeze
    at the interpolated event point."""
    active = s.active
    t_disk = t_sph = _INF
    if env.disk is not None:
        t_disk, disk_pt = disk_event(env, s.x, x1)
    if env.spheres is not None:
        t_sph, sph_pt, sph_obj = sphere_events(env, s.x, x1)
    r1 = radius(x1)
    lam1 = s.lam + dt
    finite = torch.isfinite(x1).all(dim=-1) & torch.isfinite(p1).all(dim=-1)
    status = torch.full_like(s.status, ACTIVE)
    status = status.masked_fill(lam1 >= env.lam_max, BUDGET)
    status = status.masked_fill(r1 >= env.r_escape, ESCAPED)
    status = status.masked_fill(r1 <= env.r_capture, CAPTURED)
    status = status.masked_fill(~finite, ERROR)
    if env.spheres is not None:
        status = status.masked_fill(torch.isfinite(t_sph), OBJECT)
    if env.disk is not None:
        status = status.masked_fill(
            torch.isfinite(t_disk) & (t_disk <= t_sph), DISK)
    status = torch.where(active, status, s.status)
    upd = (active & finite)[..., None]
    x = torch.where(upd, x1, s.x)
    lam = torch.where(active, lam1, s.lam)
    hit_obj = s.hit_obj
    if env.spheres is not None:
        sel = active & (status == OBJECT)
        ts = torch.where(torch.isfinite(t_sph), t_sph, 0.0)
        x = torch.where(sel[..., None], sph_pt, x)
        lam = torch.where(sel, s.lam + dt * ts, lam)
        hit_obj = torch.where(sel, sph_obj, hit_obj)
    if env.disk is not None:
        sel = active & (status == DISK)
        td = torch.where(torch.isfinite(t_disk), t_disk, 0.0)
        x = torch.where(sel[..., None], disk_pt, x)
        lam = torch.where(sel, s.lam + dt * td, lam)
    return State(x=x, p=torch.where(upd, p1, s.p), E=s.E, lam=lam,
                 status=status, hit_obj=hit_obj)


def dt_eff(env: Env, cfg: Integrator, s: State):
    dt = torch.where(s.active, cfg.dt, 0.0).to(s.x.dtype)
    if cfg.dt_boost > 1.0:
        r_ref = cfg.dt_boost_r_ref or 6.0 * env.mass
        ratio = radius(s.x) / r_ref
        if cfg.dt_power == 1.5:
            ratio = ratio * torch.sqrt(torch.clamp_min(ratio, 0.0))
        elif cfg.dt_power == 2.0:
            ratio = ratio * ratio
        elif cfg.dt_power != 1.0:
            ratio = torch.clamp_min(ratio, 1e-20) ** cfg.dt_power
        dt = dt * torch.clamp(ratio, 1.0, cfg.dt_boost)
    return dt


def fixed_step(env: Env, cfg: Integrator, s: State) -> State:
    dt = dt_eff(env, cfg, s)
    x1, p1 = rk4_step(env, s.x, s.p, s.E, dt)
    return apply_events(env, s, x1, p1, dt)


def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, v.new_tensor(lo)), v.new_tensor(hi))


def dopri_trip(env: Env, cfg: Integrator, s: State, h):
    """One Dormand-Prince trip: the embedded step of each ACTIVE ray, accept
    or reject by its scaled RMS error, the events of an accepted step, and
    the controller's next h.  Returns (state, h, accepted)."""
    dt = torch.where(s.active, h, 0.0)
    x5, p5, ex, ep = dopri_step(env, s.x, s.p, s.E, dt)
    scale_x = cfg.atol + cfg.rtol * torch.maximum(s.x.abs(), x5.abs())
    scale_p = cfg.atol + cfg.rtol * torch.maximum(s.p.abs(), p5.abs())
    err2 = (((ex / scale_x) ** 2).sum(-1)
            + ((ep / scale_p) ** 2).sum(-1)) / 6.0
    pos = err2 > 0
    err = torch.where(pos, torch.sqrt(torch.where(pos, err2, 1.0)), 0.0)
    accept = ((err <= 1.0) | (h <= cfg.min_step)) & s.active
    s1 = apply_events(env, s, x5, p5, dt)
    a3 = accept[..., None]
    s = State(x=torch.where(a3, s1.x, s.x), p=torch.where(a3, s1.p, s.p),
              E=s.E, lam=torch.where(accept, s1.lam, s.lam),
              status=torch.where(accept, s1.status, s.status),
              hit_obj=torch.where(accept, s1.hit_obj, s.hit_obj))
    factor = _clip(0.9 * torch.where(err > 0, err, 1e-10) ** -0.2, 0.2, 5.0)
    h = torch.where(s.active, _clip(h * factor, cfg.min_step, cfg.max_step), h)
    return s, h, accept


_FIELDS = ("x", "p", "E", "lam", "status", "hit_obj")


def _compact(s: State, idx):
    return State(*(getattr(s, f)[idx] for f in _FIELDS))


def _scatter(s: State, idx, sub: State) -> State:
    return State(*(getattr(s, f).index_put((idx,), getattr(sub, f))
                   for f in _FIELDS))


def _run(env, cfg, n, h, *fields):
    """``n`` steps or trips of the live rays from the state ``fields``; the
    unit that ``torch.utils.checkpoint`` recomputes."""
    s = State(*fields)
    for _ in range(n):
        idx = torch.nonzero(s.active).squeeze(-1)
        if idx.numel() == 0:
            break
        sub = _compact(s, idx)
        if h is None:
            sub = fixed_step(env, cfg, sub)
        else:
            sub, h_sub, _ = dopri_trip(env, cfg, sub, h[idx])
            h = h.index_put((idx,), h_sub)
        s = _scatter(s, idx, sub)
    return (h, *(getattr(s, f) for f in _FIELDS))


def integrate(env: Env, cfg: Integrator, s: State,
              segment: int = 0) -> State:
    """The state after ``cfg.n_steps`` RK4 steps or Dormand-Prince trips
    (rays frozen at their end), for a flat batch.  ``segment`` > 0 runs
    the loop in pieces of that many steps under ``torch.utils.checkpoint``,
    so that autograd keeps one piece's tensors at a time."""
    h = None
    if cfg.method == "dopri":
        h = torch.full(s.E.shape, min(cfg.dt, cfg.max_step),
                       dtype=s.x.dtype, device=s.x.device)
    fields = tuple(getattr(s, f) for f in _FIELDS)
    seg = segment if segment > 0 and torch.is_grad_enabled() else cfg.n_steps
    done = 0
    while done < cfg.n_steps and bool((fields[4] == ACTIVE).any()):
        n = min(seg, cfg.n_steps - done)
        if seg < cfg.n_steps:
            out = torch.utils.checkpoint.checkpoint(
                _run, env, cfg, n, h, *fields, use_reentrant=False)
        else:
            out = _run(env, cfg, n, h, *fields)
        h, fields = out[0], out[1:]
        done += n
    return State(*fields)
