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

``carter_constants`` gives a photon's conserved lambda = L_z / E and eta =
Q / E^2 from its state in this chart, ``critical_curve`` the Kerr critical
curve (the shadow's edge) as a table over the spherical photon orbits, and
``critical_weights`` the Trainer's critical-curve mask from them, in
PyTorch operations on any device.
"""

from __future__ import annotations

import math

import torch

from .flat import eta_like
from .metric import Metric
from .schwarzschild import outer


def ks_radius2(x3: torch.Tensor, a) -> torch.Tensor:
    """The Kerr-Schild r^2 at x3, unfloored: 0 in float32 on the ring's
    disk (z = 0, x^2 + y^2 < a^2) and within about 1e-4 |x^2 + y^2 - a^2|
    / |a| of it, where b + sqrt(b^2 + 4 a^2 z^2) cancels."""
    rho2 = torch.sum(x3 * x3, dim=-1)
    z2 = x3[..., 2] * x3[..., 2]
    b = rho2 - a * a
    return 0.5 * (b + torch.sqrt(b * b + 4.0 * a * a * z2))


def ks_radius(x3: torch.Tensor, a) -> torch.Tensor:
    """Kerr-Schild radius r(x, y, z); equals |x3| when a = 0.  No floor
    here: the integrator kernels floor r^2 at 1e-12, the plain integrator
    too (ops/geodesic.ks_fields), and the metric and the polarization
    transport take it unfloored, as in the JAX package."""
    return torch.sqrt(ks_radius2(x3, a))


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


def carter_constants(x3: torch.Tensor, p3: torch.Tensor, E: torch.Tensor,
                     a) -> tuple[torch.Tensor, torch.Tensor]:
    """(lambda, eta) = (L_z / E, Q / E^2) of photons at ``x3`` with
    covariant momentum ``p3`` and energy ``E`` in this chart.

    L_z = x p_y - y p_x is the momentum along the rotation Killing vector
    (-y, x, 0).  Boyer-Lindquist theta is this chart's (z = r cos theta)
    and p_theta = cot(theta) (x p_x + y p_y) - r sin(theta) p_z, so
    Carter's Q = p_theta^2 + cos^2(theta) (L_z^2 / sin^2(theta) - a^2 E^2)
    becomes, with (x p_x + y p_y)^2 + L_z^2 = (x^2 + y^2)(p_x^2 + p_y^2)
    and x^2 + y^2 = (r^2 + a^2) sin^2(theta), a form with no pole on the
    spin axis:

        Q = c2 (r^2 + a^2)(p_x^2 + p_y^2) - 2 z p_z (x p_x + y p_y)
            + (r^2 - z^2) p_z^2 - c2 a^2 E^2,            c2 = z^2 / r^2.

    At a = 0, eta + lambda^2 = |x cross p|^2 / E^2."""
    x, y, z = x3[..., 0], x3[..., 1], x3[..., 2]
    px, py, pz = p3[..., 0], p3[..., 1], p3[..., 2]
    r2 = ks_radius2(x3, a)
    a2 = a * a
    c2 = z * z / r2
    q = (c2 * (r2 + a2) * (px * px + py * py)
         - 2.0 * z * pz * (x * px + y * py)
         + (r2 - z * z) * pz * pz - c2 * a2 * E * E)
    return (x * py - y * px) / E, q / (E * E)


def critical_curve(mass, a, n: int = 1024) -> torch.Tensor:
    """The Kerr critical curve in the (lambda, eta) plane as an (n, 3)
    float64 table of (psi_c, rho_c, drho_c/dpsi) by ascending psi_c, with
    rho = sqrt(eta + lambda^2) and psi = atan2(sqrt(eta), lambda) for a
    hole of positive spin |a| (mirror lambda for a negative one).

    Each row is a spherical photon orbit of Boyer-Lindquist radius r
    between the prograde and retrograde equatorial orbits r_pro, r_retro =
    2M (1 + cos(2/3 arccos(-+|a|/M))) (Bardeen 1973; Teo 2003):

        lambda_c = -(r^3 - 3M r^2 + a^2 r + a^2 M) / (a (r - M))
        eta_c    = -r^3 (r^3 - 6M r^2 + 9M^2 r - 4 a^2 M) / (a^2 (r - M)^2)

    with psi_c rising from 0 to pi as r goes from r_pro to r_retro.  The
    radii are Chebyshev-spaced, densest at the two ends where eta_c goes
    to 0 as (r - r_pro).  |a| is kept in [1e-4, 1 - 1e-4] M, where the
    formulas' 0/0 at a = 0 and the double root at |a| = M are resolved in
    float64; at a -> 0 the curve closes to the circle rho_c = 3 sqrt(3) M.
    Built on the device of ``mass`` from tensors, with no host sync."""
    m = torch.as_tensor(mass).double()
    aa = torch.minimum(torch.maximum(
        torch.as_tensor(a, device=m.device).double().abs(), 1e-4 * m),
        (1.0 - 1e-4) * m)
    ends = 2.0 * m * (1.0 + torch.cos(
        (2.0 / 3.0) * torch.arccos(torch.stack([-aa, aa]) / m)))
    u = torch.linspace(0.0, math.pi, n, dtype=torch.float64,
                       device=m.device)
    r = ends[0] + (ends[1] - ends[0]) * (0.5 - 0.5 * torch.cos(u))
    a2 = aa * aa
    lam = -(r * r * (r - 3.0 * m) + a2 * (r + m)) / (aa * (r - m))
    eta = torch.clamp_min(-r ** 3 * (r * (r - 3.0 * m) ** 2 - 4.0 * a2 * m)
                          / (a2 * (r - m) ** 2), 0.0)
    psi = torch.atan2(torch.sqrt(eta), lam)
    rho = torch.sqrt(eta + lam * lam)
    slope = torch.diff(rho) / torch.diff(psi)
    return torch.stack([psi, rho, torch.cat([slope, slope[-1:]])], -1)


def critical_ratio(lam: torch.Tensor, eta: torch.Tensor, mass, a,
                   table: torch.Tensor | None = None) -> torch.Tensor:
    """rho / rho_c(psi) of photons of constants (lambda, eta): their
    distance from the origin of the (lambda, eta) plane over the critical
    curve's at the same angle psi (``critical_curve``, linear between its
    rows); eta < 0 reads as 0.  1 on the critical curve; at a = 0,
    ell / (3 sqrt(3) M) with ell = |x cross p| / E.  Float32."""
    if table is None:
        table = critical_curve(mass, a)
    sgn = torch.where(torch.as_tensor(a, device=lam.device) < 0, -1.0, 1.0)
    eta0 = torch.clamp_min(eta, 0.0)
    psi = torch.atan2(torch.sqrt(eta0), lam * sgn).double()
    i = torch.clamp(torch.searchsorted(table[:, 0].contiguous(), psi) - 1,
                    0, table.shape[0] - 2)
    row = table[i]
    rho_c = torch.addcmul(row[..., 1], row[..., 2], psi - row[..., 0])
    return (torch.sqrt(eta0 + lam * lam) / rho_c).float()


def critical_weights(x3: torch.Tensor, p3: torch.Tensor, E: torch.Tensor,
                     mass, a, band: float) -> torch.Tensor:
    """0/1 float32 weights of photons at ``x3`` (the hole's frame) with
    covariant momentum ``p3`` and energy ``E``: 0 where |rho / rho_c - 1| <=
    ``band`` (``critical_ratio``) and eta >= 0, 1 elsewhere; rays with eta
    < 0 do not come near the critical curve and are kept.  The curve's
    table is made on the device from ``mass`` and ``a``, with no host copy
    of them."""
    lam, eta = carter_constants(x3, p3, E, a)
    ratio = critical_ratio(lam, eta, mass, a)
    return ((torch.abs(ratio - 1.0) > band) | (eta < 0)).to(torch.float32)
