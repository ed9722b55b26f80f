"""Batched null-geodesic right-hand sides (PyTorch port of ops/geodesic.py).

Hamiltonian form with conserved energy: for the Kerr-Schild family
g = eta + 2H l l the photon super-Hamiltonian is

    Hh = 1/2 (-E^2 + |p|^2) - H(x) (E + l(x).p)^2

with p_t = -E conserved, so only the 6 quantities (x_i, p_i) are evolved.
This slice carries the Schwarzschild forms (H = M/r, l = x/r); the Kerr
forms raise until they are ported.

All functions are shaped for batches: ``x3, p3: (..., 3)``; scalars ``(...,)``.
"""

from __future__ import annotations

import torch

_R2_FLOOR = 1e-12  # keeps captured rays finite until the capture test freezes them


def _schwarzschild_scalars(x3, mass):
    """(2H, l3, r) for a = 0: 2H = r_s/r, l3 = x/r -- cheapest form."""
    r2 = torch.clamp_min(torch.sum(x3 * x3, dim=-1), _R2_FLOOR)
    inv_r = torch.rsqrt(r2)
    r = r2 * inv_r
    return (2.0 * mass) * inv_r, x3 * inv_r[..., None], r


def ks_fields(x3, mass, a):
    """(q, l3, r) with q = 2H for the Kerr-Schild family; a must be None."""
    if a is not None:
        raise NotImplementedError(
            "Kerr spacetimes (spin) are not ported yet; they come with the "
            "Kerr variants of the integrator kernels")
    return _schwarzschild_scalars(x3, mass)


def null_init(x3: torch.Tensor, d: torch.Tensor, mass,
              a=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Initial (p3, E) of a photon at ``x3`` with unit coordinate velocity ``d``.

    Closed form from the null condition Hh = 0 and dx/dlambda = d:

        s = l.d,  E = sqrt(1 - q (1 - s^2)),  w = (E + s)/(1 - q),
        p = d + q w l,                         q = 2H.
    """
    q, l3, _ = ks_fields(x3, mass, a)
    s = torch.sum(l3 * d, dim=-1)
    # Guarded sqrt (not a bare clamp): keeps the jacobian finite for
    # inside-horizon rays, whose zero cotangents would otherwise be NaN.
    e2 = 1.0 - q * (1.0 - s * s)
    pos = e2 > 0
    E = torch.sqrt(torch.where(pos, e2, torch.ones_like(e2))) * pos
    w = (E + s) / (1.0 - q)
    p = d + (q * w)[..., None] * l3
    return p, E


def xdot(x3: torch.Tensor, p3: torch.Tensor, E: torch.Tensor, mass,
         a=None) -> torch.Tensor:
    """Coordinate velocity dx/dlambda = dHh/dp = p - q (E + l.p) l."""
    q, l3, _ = ks_fields(x3, mass, a)
    w = E + torch.sum(l3 * p3, dim=-1)
    return p3 - (q * w)[..., None] * l3


def schwarzschild_rhs(x3: torch.Tensor, p3: torch.Tensor, E: torch.Tensor,
                      mass) -> tuple[torch.Tensor, torch.Tensor]:
    """Hand-derived (dx, dp) for Schwarzschild-KS.

    With n = x/r, u = 2M/r, s = n.p, w = E + s:

        dx_i = p_i - u w n_i
        dp_i = -(M/r^2) [ w^2 n_i - 2 w (p_i - s n_i) ]
    """
    r2 = torch.clamp_min(torch.sum(x3 * x3, dim=-1), _R2_FLOOR)
    inv_r = torch.rsqrt(r2)
    inv_r2 = inv_r * inv_r
    n = x3 * inv_r[..., None]
    u = (2.0 * mass) * inv_r
    s = torch.sum(n * p3, dim=-1)
    w = E + s
    dx = p3 - (u * w)[..., None] * n
    m_r2 = mass * inv_r2
    coef_p = 2.0 * m_r2 * w
    coef_n = m_r2 * w * (w + 2.0 * s)  # from -(w^2 n) - 2 w s n collected on n
    dp = coef_p[..., None] * p3 - coef_n[..., None] * n
    return dx, dp


def hamiltonian(x3: torch.Tensor, p3: torch.Tensor, E: torch.Tensor, mass,
                a=None) -> torch.Tensor:
    """Hh = 1/2(-E^2 + |p|^2) - H (E + l.p)^2; exactly 0 along null geodesics."""
    q, l3, _ = ks_fields(x3, mass, a)
    w = E + torch.sum(l3 * p3, dim=-1)
    return 0.5 * (-E * E + torch.sum(p3 * p3, dim=-1) - q * w * w)
