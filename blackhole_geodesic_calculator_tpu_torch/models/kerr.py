"""Kerr metric in Kerr-Schild Cartesian form, spin parameter ``a`` (PyTorch
port of models/kerr.py:32-50, :72-74).

    g_{mu nu} = eta_{mu nu} + 2 H l_mu l_nu

    H   = M r^3 / (r^4 + a^2 z^2)
    l_mu = (1, (r x + a y)/(r^2 + a^2), (r y - a x)/(r^2 + a^2), z/r)

with the Kerr-Schild radius r(x, y, z) solving

    r^4 - (rho^2 - a^2) r^2 - a^2 z^2 = 0,   rho^2 = x^2 + y^2 + z^2.

``a = 0`` is Schwarzschild in Kerr-Schild form; the spin axis is +z.  ``a``
is the dimensionful a = J / M (0.45 for M = 0.5 is a/M = 0.9).
``kerr_ks_metric`` is the ``Metric`` of the polarization transport.
"""

from __future__ import annotations

import torch

from .flat import eta_like
from .metric import Metric
from .schwarzschild import outer


def ks_radius(x3: torch.Tensor, a) -> torch.Tensor:
    """Kerr-Schild radius r(x, y, z); equals |x3| when a = 0.  No floor
    here: the integrator kernels floor r^2 at 1e-12, the plain integrator
    floors r at 1e-6 (ops/geodesic.ks_fields), and the metric and the
    polarization transport take it unfloored, as in the JAX package."""
    rho2 = torch.sum(x3 * x3, dim=-1)
    z2 = x3[..., 2] * x3[..., 2]
    b = rho2 - a * a
    r2 = 0.5 * (b + torch.sqrt(b * b + 4.0 * a * a * z2))
    return torch.sqrt(r2)


def ks_scalars(x3: torch.Tensor, mass, a, r=None):
    """(H, l3): the Kerr-Schild potential and the spatial null covector;
    ``r`` is the radius where the caller has it (floored), else
    ``ks_radius(x3, a)``."""
    if r is None:
        r = ks_radius(x3, a)
    x, y, z = x3[..., 0], x3[..., 1], x3[..., 2]
    r2a2 = r * r + a * a
    lx = (r * x + a * y) / r2a2
    ly = (r * y - a * x) / r2a2
    lz = z / r
    H = mass * r**3 / (r**4 + a * a * z * z)
    return H, torch.stack([lx, ly, lz], dim=-1)


def _kerr_null(x4, mass, a, time_part):
    """(H, l) with l = (time_part, l3) at x4 = (t, x3)."""
    H, l3 = ks_scalars(x4[..., 1:], mass, a)
    return H, torch.cat([torch.full_like(x4[..., :1], time_part), l3],
                        dim=-1)


def _g_kerr_ks(x4, mass, a):
    H, l = _kerr_null(x4, mass, a, 1.0)
    return eta_like(x4) + (2.0 * H)[..., None, None] * outer(l, l)


def _g_inv_kerr_ks(x4, mass, a):
    # g^{mu nu} = eta^{mu nu} - 2H l^mu l^nu with l^mu = eta^{mu nu} l_nu
    H, l_up = _kerr_null(x4, mass, a, -1.0)
    return eta_like(x4) - (2.0 * H)[..., None, None] * outer(l_up, l_up)


def kerr_ks_metric(mass, a) -> Metric:
    return Metric(g_fn=_g_kerr_ks, params=(mass, a), name="kerr_ks",
                  g_inv_fn=_g_inv_kerr_ks)


def horizon_radius(mass, a):
    """Outer event horizon r_+ = M + sqrt(M^2 - a^2) (Kerr-Schild r)."""
    mass = torch.as_tensor(mass, dtype=torch.float32)
    a = torch.as_tensor(a, dtype=torch.float32, device=mass.device)
    return mass + torch.sqrt(torch.clamp_min(mass * mass - a * a, 0.0))
