"""Batched null-geodesic right-hand sides (PyTorch port of ops/geodesic.py).

Hamiltonian form with conserved energy: for the Kerr-Schild family
g = eta + 2H l l the photon super-Hamiltonian is

    Hh = 1/2 (-E^2 + |p|^2) - H(x) (E + l(x).p)^2

with p_t = -E conserved, so only the 6 quantities (x_i, p_i) are evolved.
Schwarzschild (spin ``a`` None: H = M/r, l = x/r) has the cheapest forms;
Kerr (models/kerr.py) goes through ``ks_fields`` (geodesic.py:56-61) and
``kerr_rhs``, the analytic right-hand side of the TPU kernel
(``_rhs_kerr_soa``, pallas_kernel.py:84-142).

All functions are shaped for batches: ``x3, p3: (..., 3)``; scalars ``(...,)``.
"""

from __future__ import annotations

import torch

from ..models.kerr import ks_radius2, ks_scalars

_R2_FLOOR = 1e-12  # keeps captured rays finite until the capture test freezes them


def _schwarzschild_scalars(x3, mass):
    """(2H, l3, r) for a = 0: 2H = r_s/r, l3 = x/r -- cheapest form."""
    r2 = torch.clamp_min(torch.sum(x3 * x3, dim=-1), _R2_FLOOR)
    inv_r = torch.rsqrt(r2)
    r = r2 * inv_r
    return (2.0 * mass) * inv_r, x3 * inv_r[..., None], r


def ks_fields(x3, mass, a):
    """(q, l3, r) with q = 2H for the Kerr-Schild family; a may be None.

    The Kerr r^2 is floored as the Schwarzschild one is, before its square
    root: a captured ray frozen on or by the ring's disk (z = 0, rho < |a|,
    where r^2 rounds to 0) keeps a finite velocity and direction, and a
    finite (zero) gradient, where a floor on r itself passed back the
    square root's infinite derivative at 0 times zero, NaN; elsewhere the
    floor changes no bit."""
    if a is None:
        return _schwarzschild_scalars(x3, mass)
    r = torch.sqrt(torch.clamp_min(ks_radius2(x3, a), _R2_FLOOR))
    H, l3 = ks_scalars(x3, mass, a, r=r)
    return 2.0 * H, l3, r


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


def timelike_init(x3: torch.Tensor, v: torch.Tensor, mass,
                  a=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Initial (p3, E) of a massive particle at ``x3`` with proper-time
    coordinate velocity dx/dtau = ``v`` of any magnitude (JAX
    geodesic.py:86-121).

    Closed form from g u u = -1 with u = (T, v) in the Kerr-Schild chart,
    the future root:

        (q - 1) T^2 + 2 q s T + (|v|^2 + q s^2 + 1) = 0,   q = 2H, s = l.v
        T = (q s + sqrt(q^2 s^2 + (1 - q)(|v|^2 + q s^2 + 1))) / (1 - q)
        p = v + q (T + s) l,        E = T - q (T + s)

    (flat limit: T = sqrt(1 + |v|^2), p = v).  The right-hand side is the
    null one; only the conserved Hh differs (-1/2 instead of 0), so the
    same integrator and kernels apply.
    """
    q, l3, _ = ks_fields(x3, mass, a)
    s = torch.sum(l3 * v, dim=-1)
    v2 = torch.sum(v * v, dim=-1)
    one_m_q = 1.0 - q
    disc = q * q * s * s + one_m_q * (v2 + q * s * s + 1.0)
    # Double-where guard: inside the horizon (q >= 1) there is no future
    # root in this chart; there the sqrt and the division see 1 and T is 1,
    # so the frozen INSIDE_HORIZON rays stay NaN-free in value and in
    # gradient (a bare clamp would pass NaN cotangents through).
    valid = (disc > 0) & (one_m_q > 0)
    one = torch.ones_like(disc)
    T = (q * s + torch.sqrt(torch.where(valid, disc, one))) / torch.where(
        valid, one_m_q, one)
    T = torch.where(valid, T, one)
    qc = q * (T + s)
    p = v + qc[..., None] * l3
    E = T - qc
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


def kerr_rhs_soa(mass, a, E, a0, a1, a2, b0, b1, b2):
    """Hand-derived Kerr-Schild Kerr right-hand side on components: line for
    line the TPU kernel's ``_rhs_kerr_soa`` (pallas_kernel.py:84-142),
    floors included, at position (a0, a1, a2) and momentum (b0, b1, b2);
    returns the 6-tuple (dx, dp).

    dp = +d/dx [H w^2] with w = E + l.p; the gradient of the Kerr-Schild
    radius by implicit differentiation, dr/dx_i = (r^2 x_i + a^2 z
    delta_i2) / (r S), S = 2 r^2 - (rho^2 - a^2).  Equal to autodiff of the
    Hamiltonian (the JAX package's ``ks_rhs``) up to float32 rounding; at
    a = 0 it is the Schwarzschild right-hand side."""
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

    # dH/dx_i = M (3 r^2 D - 4 r^6) dr_i / D^2 - 2 M a^2 z r^3 d_i2 / D^2
    hcoef = mass * (3.0 * r2 * D - 4.0 * r2 * r2 * r2) * inv_D * inv_D
    dH0 = hcoef * dr0
    dH1 = hcoef * dr1
    dH2 = hcoef * dr2 - 2.0 * mass * az * r * r2 * inv_D * inv_D

    # dw_i = b_j dl_j/dx_i (quotient rule; dA/dx_i = 2 r dr_i)
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
    return (b0 - qw * l0, b1 - qw * l1, b2 - qw * l2,
            w2 * dH0 + qw * dw0, w2 * dH1 + qw * dw1, w2 * dH2 + qw * dw2)


def kerr_rhs(x3: torch.Tensor, p3: torch.Tensor, E: torch.Tensor, mass,
             a) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dp) of ``kerr_rhs_soa`` for ``x3, p3: (..., 3)``."""
    k = kerr_rhs_soa(mass, a, E, x3[..., 0], x3[..., 1], x3[..., 2],
                     p3[..., 0], p3[..., 1], p3[..., 2])
    return torch.stack(k[:3], dim=-1), torch.stack(k[3:], dim=-1)


def hamiltonian(x3: torch.Tensor, p3: torch.Tensor, E: torch.Tensor, mass,
                a=None) -> torch.Tensor:
    """Hh = 1/2(-E^2 + |p|^2) - H (E + l.p)^2; exactly 0 along null geodesics."""
    q, l3, _ = ks_fields(x3, mass, a)
    w = E + torch.sum(l3 * p3, dim=-1)
    return 0.5 * (-E * E + torch.sum(p3 * p3, dim=-1) - q * w * w)
