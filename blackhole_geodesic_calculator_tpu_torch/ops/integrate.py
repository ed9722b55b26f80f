"""Batched fixed-step RK4 geodesic integration (PyTorch port of ops/integrate.py).

The whole ray batch is stepped at once; every step classifies each ray
(horizon capture, escape from the domain, affine budget, non-finite state)
and freezes it in the carry, so a terminated ray is an exact identity under
all later steps.  ``integrate`` dispatches between the hand-written CUDA
kernel (ops/cuda_kernel.py) for tensors on a CUDA device and the plain
PyTorch step loop below for tensors on the CPU.

This slice is the forward Schwarzschild path with no disk and no spheres:
the event geometry dataclasses are carried as data, and a configuration that
needs disk or sphere events, spin, Dormand-Prince or timelike rays raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from . import states
from .geodesic import null_init, schwarzschild_rhs, xdot
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
        if self.spin is not None:
            raise NotImplementedError(
                "Kerr spacetimes (spin) are not ported yet")
        return schwarzschild_rhs(x3, p3, E, self.mass)

    def radius(self, x3):
        if self.spin is not None:
            raise NotImplementedError(
                "Kerr spacetimes (spin) are not ported yet")
        return torch.sqrt(torch.sum(x3 * x3, dim=-1))


# =============================================================================
# Static integrator configuration.
# =============================================================================
@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    n_steps: int = 512
    dt: float = 0.1
    method: str = "rk4"          # 'rk4' | 'dopri' (dopri not ported yet)
    mode: str = "scan"           # 'scan' | 'while'; the forward is the same
    # 'auto': the CUDA kernel for tensors on a CUDA device, the plain
    # PyTorch loop for tensors on the CPU; 'cuda' / 'torch' force a path.
    backend: str = "auto"
    remat_segment: int = 0       # 0 -> sqrt(n_steps); used by the gradient path
    # Per-ray radius-proportional step growth:
    #   dt_eff = dt * clip((r/r_ref)^dt_power, 1, boost)
    dt_boost: float = 8.0
    dt_boost_r_ref: float = 0.0  # 0 -> 6 M (twice the photon sphere)
    dt_power: float = 1.0
    # Tile ordering of the TPU kernel; the CUDA kernel runs one thread per
    # ray and takes no ordering, and the outputs never depend on it.
    tile_order: str = "cost"     # 'cost' | 'none'
    # Dormand-Prince controls (kept for config parity with the reference).
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


def _apply_events(env: GeodesicEnv, s: RayState, x1, p1, dt) -> RayState:
    """Classify the step x -> x1 and merge it into the frozen-state carry.

    Priority, lowest first: BUDGET, ESCAPED, CAPTURED, ERROR.  A ray whose
    step is non-finite keeps its old x and p.
    """
    if env.disk is not None or env.spheres is not None:
        raise NotImplementedError(
            "disk and sphere events are not ported yet; they come with the "
            "event variants of the integrator kernels")
    active = s.active

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
    status = torch.where(active, status, s.status)

    upd = (active & finite)[..., None]
    return dataclasses.replace(
        s,
        x=torch.where(upd, x1, s.x),
        p=torch.where(upd, p1, s.p),
        lam=torch.where(active, lam1, s.lam),
        status=status,
    )


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
    if cfg.method != "rk4":
        raise NotImplementedError(
            f"method={cfg.method!r} is not ported yet; the adaptive "
            "Dormand-Prince integrator comes with its kernels")
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
