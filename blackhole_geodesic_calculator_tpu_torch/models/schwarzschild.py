"""Schwarzschild metric in two Cartesian charts (PyTorch port of
models/schwarzschild.py), each with its closed-form inverse.

1. ``schwarzschild_cartesian_metric``, the textbook chart:

       ds^2 = -f dt^2 + dx.dx + (r_s / (r^3 f)) (x.dx)^2,   f = 1 - r_s/r,

   singular at the horizon;
2. ``schwarzschild_ks_metric``, the horizon-penetrating Kerr-Schild form

       g_{mu nu} = eta_{mu nu} + (r_s/r) l_mu l_nu,   l_mu = (1, x/r).

Both share the spatial coordinates, so spatial photon paths are the same
in the two; only t differs.  Geometrized units, r_s = 2M.
"""

from __future__ import annotations

import torch

from .flat import eta_like
from .metric import Metric


def outer(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u_m v_n over the last axis: (..., n, n)."""
    return u[..., :, None] * v[..., None, :]


def blocks(g00: torch.Tensor, spatial: torch.Tensor) -> torch.Tensor:
    """The (..., 4, 4) tensor diag(g00, spatial) with zero time-space
    entries."""
    zero = torch.zeros_like(spatial[..., 0])
    top = torch.cat([g00[..., None], zero], dim=-1)
    rest = torch.cat([zero[..., :, None], spatial], dim=-1)
    return torch.cat([top[..., None, :], rest], dim=-2)


def _cartesian_parts(x4, mass):
    rs = 2.0 * mass
    x3 = x4[..., 1:]
    r2 = torch.sum(x3 * x3, dim=-1)
    r = torch.sqrt(r2)
    return rs, x3, r2, r, 1.0 - rs / r


def _g_schwarzschild_cartesian(x4, mass):
    rs, x3, r2, r, f = _cartesian_parts(x4, mass)
    eye = torch.eye(3, dtype=x4.dtype, device=x4.device)
    spatial = eye + (rs / (f * r2 * r))[..., None, None] * outer(x3, x3)
    return blocks(-f, spatial)


def _g_inv_schwarzschild_cartesian(x4, mass):
    # g^tt = -1/f;  g^ij = delta_ij - (r_s/r^3) x_i x_j
    rs, x3, r2, r, f = _cartesian_parts(x4, mass)
    eye = torch.eye(3, dtype=x4.dtype, device=x4.device)
    spatial = eye - (rs / (r2 * r))[..., None, None] * outer(x3, x3)
    return blocks(-1.0 / f, spatial)


def _ks_null(x4, time_part):
    """(r, l) with l = (time_part, x/r)."""
    x3 = x4[..., 1:]
    r = torch.sqrt(torch.sum(x3 * x3, dim=-1))
    l = torch.cat([torch.full_like(x4[..., :1], time_part),
                   x3 / r[..., None]], dim=-1)
    return r, l


def _g_schwarzschild_ks(x4, mass):
    r, l = _ks_null(x4, 1.0)
    return eta_like(x4) + ((2.0 * mass) / r)[..., None, None] * outer(l, l)


def _g_inv_schwarzschild_ks(x4, mass):
    # g^{mu nu} = eta^{mu nu} - (r_s/r) l^mu l^nu with l^mu = (-1, x/r)
    r, l_up = _ks_null(x4, -1.0)
    return eta_like(x4) - ((2.0 * mass) / r)[..., None, None] * outer(
        l_up, l_up)


def schwarzschild_cartesian_metric(mass) -> Metric:
    return Metric(g_fn=_g_schwarzschild_cartesian, params=(mass,),
                  name="schwarzschild",
                  g_inv_fn=_g_inv_schwarzschild_cartesian)


def schwarzschild_ks_metric(mass) -> Metric:
    return Metric(g_fn=_g_schwarzschild_ks, params=(mass,),
                  name="schwarzschild_ks",
                  g_inv_fn=_g_inv_schwarzschild_ks)
