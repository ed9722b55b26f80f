"""The exact discrete adjoint of one RK4 step, written by hand.

Counterpart of ``_step_adjoint`` (pallas_kernel.py:1025-1153) for the step
the gradient path runs: Schwarzschild or Kerr, with or without the disk and
sphere events.  It is the plain PyTorch statement of what
``csrc/rk4_bwd.cu`` computes, line for line:

* ``rhs_vjp`` -- the VJP of ``_rhs_schw_soa`` (:63-81), including the
  ``r^2 >= 1e-12`` floor;
* ``rhs_kerr_vjp`` -- the VJP of ``_rhs_kerr_soa`` (:84-142), derived by
  hand in reverse mode, with no gradient below its r^2 and r S floors;
* ``step_size_vjp`` -- the VJP of ``_dt_soa`` (:156-175) for the four step
  size powers and the clip to [1, boost], on the Euclidean radius or, for
  Kerr, the floored Kerr-Schild radius of ``_ks_radius_soa`` (:145-153);
* ``segment_events`` and ``events_vjp`` -- the event detection of
  ``_events_merge`` (:211-270) and, derived by hand, the transpose of its
  position merge (what the TPU kernel takes with ``jax.vjp`` of
  ``_events_merge``, :1089-1111): a disk or sphere event point
  ``x + (y - x) t`` sends its cotangent to the pre-step x, to the RK4
  endpoint y and, for a sphere, to the hit sphere's centre and radius;
* ``step_adjoint`` -- the RK4 skeleton transposed (:1124-1144) behind the
  transpose of the freeze ``y' = where(active & finite, rk4, y)``
  (:1112-1122) and of the event points;
* ``dopri_trip`` -- one adaptive Dormand-Prince trip, ``_dopri_trip``
  (:390-470) with ``events_merge`` (``_events_merge`` :272-317), and
  ``dopri_trip_vjp``, its transpose derived by hand: what the TPU kernel
  takes with a whole-trip ``jax.vjp`` (``_dopri_trip_adjoint`` :702-746),
  the step controller included.  ``csrc/dopri_trip.cuh`` copies it.

Every function works on structure-of-arrays tuples of tensors of one batch
shape, one tensor per component.  The CUDA kernel cannot run on the CPU, so
the tests hold this module against ``jax.vjp`` and against
``torch.autograd`` of ``integrate._fixed_step`` instead.

A step whose ray is frozen or whose RK4 endpoint is not finite is the
identity on (x, p) and contributes nothing to the E and scalar cotangents:
the kernel skips it, and here its contributions are masked to zero, so no
0 * inf from a frozen ray's Jacobian reaches a shared cotangent.  Only the
selected event carries a cotangent: a miss, an unselected sphere and a disk
crossing that lost to a sphere add exact zeros.  The scalars r_in, r_out,
r_capture, r_escape and lam_max enter only through comparisons, so their
cotangents are zero; so does the Kerr endpoint radius, so the event tail's
transpose is the same for Kerr.
"""

from __future__ import annotations

import typing

import torch

from .geodesic import kerr_rhs_soa
from .integrate import _DP_A, _DP_B5, _DP_E, _clip
from .states import ACTIVE, BUDGET, CAPTURED, DISK, ERROR, ESCAPED, OBJECT

NSCAL = 10
R2_FLOOR = 1e-12
SPIN = 9   # the spin's entry of the scalar vector


def rhs(mass, E, a, b):
    """Schwarzschild Kerr-Schild Hamiltonian RHS (``_rhs_schw_soa``) at
    position ``a`` and momentum ``b`` (3-tuples); returns a 6-tuple."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    r2 = torch.clamp_min(a0 * a0 + a1 * a1 + a2 * a2, R2_FLOOR)
    inv_r = torch.rsqrt(r2)
    inv_r2 = inv_r * inv_r
    n0, n1, n2 = a0 * inv_r, a1 * inv_r, a2 * inv_r
    u = (2.0 * mass) * inv_r
    s = n0 * b0 + n1 * b1 + n2 * b2
    w = E + s
    uw = u * w
    m_r2 = mass * inv_r2
    cp = 2.0 * m_r2 * w
    cn = m_r2 * w * (w + 2.0 * s)
    return (b0 - uw * n0, b1 - uw * n1, b2 - uw * n2,
            cp * b0 - cn * n0, cp * b1 - cn * n1, cp * b2 - cn * n2)


def rhs_vjp(mass, E, a, b, g):
    """VJP of ``rhs`` at (a, b) for the output cotangent ``g`` (6-tuple).

    Returns (g_ab, g_E, g_mass): the 6-tuple cotangent of (a, b) and the
    per-ray cotangents of E and of the mass."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    gx0, gx1, gx2, gp0, gp1, gp2 = g
    rr = a0 * a0 + a1 * a1 + a2 * a2
    r2 = torch.clamp_min(rr, R2_FLOOR)
    inv_r = torch.rsqrt(r2)
    inv_r2 = inv_r * inv_r
    n0, n1, n2 = a0 * inv_r, a1 * inv_r, a2 * inv_r
    u = (2.0 * mass) * inv_r
    s = n0 * b0 + n1 * b1 + n2 * b2
    w = E + s
    uw = u * w
    m_r2 = mass * inv_r2
    cp = 2.0 * m_r2 * w
    cn = m_r2 * w * (w + 2.0 * s)

    # kx = b - uw n,  kp = cp b - cn n
    gb0, gb1, gb2 = gx0 + cp * gp0, gx1 + cp * gp1, gx2 + cp * gp2
    g_uw = -(gx0 * n0 + gx1 * n1 + gx2 * n2)
    g_cp = gp0 * b0 + gp1 * b1 + gp2 * b2
    g_cn = -(gp0 * n0 + gp1 * n1 + gp2 * n2)
    gn0 = -uw * gx0 - cn * gp0
    gn1 = -uw * gx1 - cn * gp1
    gn2 = -uw * gx2 - cn * gp2
    # cp = 2 m_r2 w,  cn = m_r2 w (w + 2 s),  uw = u w
    g_mr2 = 2.0 * w * g_cp + w * (w + 2.0 * s) * g_cn
    g_w = 2.0 * m_r2 * g_cp + m_r2 * (2.0 * w + 2.0 * s) * g_cn + u * g_uw
    g_s = 2.0 * m_r2 * w * g_cn + g_w          # w = E + s
    g_u = w * g_uw
    g_E = g_w
    # s = n . b
    gn0, gn1, gn2 = gn0 + g_s * b0, gn1 + g_s * b1, gn2 + g_s * b2
    gb0, gb1, gb2 = gb0 + g_s * n0, gb1 + g_s * n1, gb2 + g_s * n2
    # m_r2 = mass inv_r^2,  u = 2 mass inv_r,  n = a inv_r
    g_mass = inv_r2 * g_mr2 + 2.0 * inv_r * g_u
    g_inv_r = (2.0 * mass * g_u + 2.0 * inv_r * (mass * g_mr2)
               + gn0 * a0 + gn1 * a1 + gn2 * a2)
    # inv_r = rsqrt(max(rr, floor)): no gradient to a below the floor
    g_rr = torch.where(rr > R2_FLOOR, -0.5 * inv_r * inv_r2 * g_inv_r,
                       torch.zeros_like(rr))
    ga0 = inv_r * gn0 + 2.0 * a0 * g_rr
    ga1 = inv_r * gn1 + 2.0 * a1 * g_rr
    ga2 = inv_r * gn2 + 2.0 * a2 * g_rr
    return (ga0, ga1, ga2, gb0, gb1, gb2), g_E, g_mass


def rhs_kerr_vjp(mass, spin, E, a, b, g):
    """VJP of the Kerr RHS ``geodesic.kerr_rhs_soa`` at position ``a`` and
    momentum ``b`` (3-tuples) for the output cotangent ``g``.

    Returns (g_ab, g_E, g_mass, g_spin): the 6-tuple cotangent of (a, b)
    and the per-ray cotangents of E, the mass and the spin.  The forward
    intermediates are those of ``_rhs_kerr_soa``, with its dw_i collected
    as C dr_i + e_i (C the part common to the three, e_i the rest); the
    lines below transpose them in reverse.  Below the r^2 floor and the
    r S floor no gradient passes, as through ``max`` in JAX."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    gx0, gx1, gx2, gp0, gp1, gp2 = g
    zero = torch.zeros_like(a0)
    # --- forward ---------------------------------------------------------
    s2 = spin * spin
    rho2 = a0 * a0 + a1 * a1 + a2 * a2
    bq = rho2 - s2
    S = torch.sqrt(bq * bq + 4.0 * s2 * a2 * a2)
    r2raw = 0.5 * (bq + S)
    r2 = torch.clamp_min(r2raw, R2_FLOOR)
    r = torch.sqrt(r2)
    rS = r * S
    inv_rS = 1.0 / torch.clamp_min(rS, R2_FLOOR)
    az = s2 * a2
    dr0 = r2 * a0 * inv_rS
    dr1 = r2 * a1 * inv_rS
    dr2 = (r2 * a2 + az) * inv_rS
    inv_A = 1.0 / (r2 + s2)
    n0 = r * a0 + spin * a1
    n1 = r * a1 - spin * a0
    l0, l1, l2 = n0 * inv_A, n1 * inv_A, a2 / r
    D = r2 * r2 + az * a2
    inv_D = 1.0 / D
    inv_D2 = inv_D * inv_D
    H = mass * r * r2 * inv_D
    w = E + l0 * b0 + l1 * b1 + l2 * b2
    q = 2.0 * H
    P = 3.0 * r2 * D - 4.0 * r2 * r2 * r2
    hcoef = mass * P * inv_D2
    K = 2.0 * mass * az * r * r2 * inv_D2
    dH0, dH1, dH2 = hcoef * dr0, hcoef * dr1, hcoef * dr2 - K
    twoR_A2 = 2.0 * r * inv_A * inv_A
    inv_r2 = 1.0 / r2
    C = (b0 * a0 + b1 * a1) * inv_A - (b0 * n0 + b1 * n1) * twoR_A2 \
        - b2 * a2 * inv_r2
    dw0 = C * dr0 + (b0 * r - b1 * spin) * inv_A
    dw1 = C * dr1 + (b0 * spin + b1 * r) * inv_A
    dw2 = C * dr2 + b2 / r
    w2, qw = w * w, q * w

    # --- reverse ---------------------------------------------------------
    # kx = b - qw l,  kp = w2 dH + qw dw
    g_qw = -(gx0 * l0 + gx1 * l1 + gx2 * l2) + gp0 * dw0 + gp1 * dw1 \
        + gp2 * dw2
    g_w2 = gp0 * dH0 + gp1 * dH1 + gp2 * dH2
    gb0, gb1, gb2 = gx0, gx1, gx2
    gl0, gl1, gl2 = -qw * gx0, -qw * gx1, -qw * gx2
    gdH0, gdH1, gdH2 = w2 * gp0, w2 * gp1, w2 * gp2
    gdw0, gdw1, gdw2 = qw * gp0, qw * gp1, qw * gp2
    # w2 = w^2,  qw = q w
    g_w = 2.0 * w * g_w2 + q * g_qw
    g_q = w * g_qw
    # dw_i = C dr_i + e_i
    g_C = gdw0 * dr0 + gdw1 * dr1 + gdw2 * dr2
    gdr0, gdr1, gdr2 = gdw0 * C, gdw1 * C, gdw2 * C
    g_invA = gdw0 * (b0 * r - b1 * spin) + gdw1 * (b0 * spin + b1 * r)
    g_r = (gdw0 * b0 + gdw1 * b1) * inv_A - gdw2 * b2 * inv_r2
    g_spin = (gdw1 * b0 - gdw0 * b1) * inv_A
    gb0 = gb0 + (gdw0 * r + gdw1 * spin) * inv_A
    gb1 = gb1 + (gdw1 * r - gdw0 * spin) * inv_A
    gb2 = gb2 + gdw2 / r
    # C = (b0 a0 + b1 a1) inv_A - (b0 n0 + b1 n1) twoR_A2 - b2 a2 inv_r2
    gb0 = gb0 + g_C * (a0 * inv_A - n0 * twoR_A2)
    gb1 = gb1 + g_C * (a1 * inv_A - n1 * twoR_A2)
    gb2 = gb2 - g_C * a2 * inv_r2
    ga0, ga1, ga2 = g_C * b0 * inv_A, g_C * b1 * inv_A, -g_C * b2 * inv_r2
    g_invA = g_invA + g_C * (b0 * a0 + b1 * a1)
    gn0, gn1 = -g_C * b0 * twoR_A2, -g_C * b1 * twoR_A2
    g_twoR = -g_C * (b0 * n0 + b1 * n1)
    g_invr2 = -g_C * b2 * a2
    # dH_i = hcoef dr_i (dH2 - K)
    g_hcoef = gdH0 * dr0 + gdH1 * dr1 + gdH2 * dr2
    gdr0, gdr1, gdr2 = (gdr0 + gdH0 * hcoef, gdr1 + gdH1 * hcoef,
                        gdr2 + gdH2 * hcoef)
    # K = 2 M az r r2 inv_D^2
    g_K = -gdH2
    g_mass = g_K * 2.0 * az * r * r2 * inv_D2
    g_az = g_K * 2.0 * mass * r * r2 * inv_D2
    g_r = g_r + g_K * 2.0 * mass * az * r2 * inv_D2
    g_r2 = g_K * 2.0 * mass * az * r * inv_D2
    g_invD = g_K * 4.0 * mass * az * r * r2 * inv_D
    # hcoef = M P inv_D^2,  P = 3 r2 D - 4 r2^3
    g_mass = g_mass + g_hcoef * P * inv_D2
    g_P = g_hcoef * mass * inv_D2
    g_invD = g_invD + g_hcoef * mass * P * 2.0 * inv_D
    g_r2 = g_r2 + g_P * (3.0 * D - 12.0 * r2 * r2)
    g_D = g_P * 3.0 * r2
    # q = 2 H,  w = E + l.b
    g_H = 2.0 * g_q
    g_E = g_w
    gl0, gl1, gl2 = gl0 + g_w * b0, gl1 + g_w * b1, gl2 + g_w * b2
    gb0, gb1, gb2 = gb0 + g_w * l0, gb1 + g_w * l1, gb2 + g_w * l2
    # H = M r r2 inv_D
    g_mass = g_mass + g_H * r * r2 * inv_D
    g_r = g_r + g_H * mass * r2 * inv_D
    g_r2 = g_r2 + g_H * mass * r * inv_D
    g_invD = g_invD + g_H * mass * r * r2
    # inv_D = 1 / D,  D = r2^2 + az a2
    g_D = g_D - g_invD * inv_D2
    g_r2 = g_r2 + g_D * 2.0 * r2
    g_az = g_az + g_D * a2
    ga2 = ga2 + g_D * az
    # l0 = n0 inv_A,  l1 = n1 inv_A,  l2 = a2 / r
    gn0, gn1 = gn0 + gl0 * inv_A, gn1 + gl1 * inv_A
    g_invA = g_invA + gl0 * n0 + gl1 * n1
    ga2 = ga2 + gl2 / r
    g_r = g_r - gl2 * l2 / r
    # n0 = r a0 + a a1,  n1 = r a1 - a a0
    g_r = g_r + gn0 * a0 + gn1 * a1
    ga0 = ga0 + gn0 * r - gn1 * spin
    ga1 = ga1 + gn0 * spin + gn1 * r
    g_spin = g_spin + gn0 * a1 - gn1 * a0
    # twoR_A2 = 2 r inv_A^2,  inv_r2 = 1 / r2
    g_r = g_r + g_twoR * 2.0 * inv_A * inv_A
    g_invA = g_invA + g_twoR * 4.0 * r * inv_A
    g_r2 = g_r2 - g_invr2 * inv_r2 * inv_r2
    # inv_A = 1 / A,  A = r2 + a^2
    g_A = -g_invA * inv_A * inv_A
    g_r2 = g_r2 + g_A
    g_s2 = g_A
    # dr0 = r2 a0 inv_rS,  dr1 = r2 a1 inv_rS,  dr2 = (r2 a2 + az) inv_rS
    g_r2 = g_r2 + (gdr0 * a0 + gdr1 * a1 + gdr2 * a2) * inv_rS
    ga0 = ga0 + gdr0 * r2 * inv_rS
    ga1 = ga1 + gdr1 * r2 * inv_rS
    ga2 = ga2 + gdr2 * r2 * inv_rS
    g_az = g_az + gdr2 * inv_rS
    g_invrS = gdr0 * r2 * a0 + gdr1 * r2 * a1 + gdr2 * (r2 * a2 + az)
    # az = a^2 a2
    g_s2 = g_s2 + g_az * a2
    ga2 = ga2 + g_az * s2
    # inv_rS = 1 / max(r S, floor): no gradient below the floor
    g_rS = torch.where(rS > R2_FLOOR, -g_invrS * inv_rS * inv_rS, zero)
    g_r = g_r + g_rS * S
    g_S = g_rS * r
    # r = sqrt(r2)
    g_r2 = g_r2 + 0.5 * g_r / r
    # r2 = max((bq + S) / 2, floor): no gradient below the floor
    g_r2 = torch.where(r2raw > R2_FLOOR, g_r2, zero)
    g_bq = 0.5 * g_r2
    g_S = g_S + 0.5 * g_r2
    # S = sqrt(bq^2 + 4 a^2 a2^2); S = 0 only on the ring singularity
    g_Sq = torch.where(S > 0, 0.5 * g_S / torch.where(S > 0, S, 1.0), zero)
    g_bq = g_bq + 2.0 * bq * g_Sq
    g_s2 = g_s2 + 4.0 * a2 * a2 * g_Sq
    ga2 = ga2 + 8.0 * s2 * a2 * g_Sq
    # bq = rho2 - a^2,  rho2 = a.a,  s2 = a^2
    g_s2 = g_s2 - g_bq
    ga0, ga1, ga2 = (ga0 + 2.0 * a0 * g_bq, ga1 + 2.0 * a1 * g_bq,
                     ga2 + 2.0 * a2 * g_bq)
    g_spin = g_spin + 2.0 * spin * g_s2
    return (ga0, ga1, ga2, gb0, gb1, gb2), g_E, g_mass, g_spin


def radius(a, spin=None):
    """The step-size and endpoint radius of the kernels: Euclidean, or for
    Kerr (``spin`` not None) the Kerr-Schild radius with r^2 floored at
    1e-12 (``_ks_radius_soa``).  Returns (radius, r^2 before the floor,
    S = sqrt((rho^2 - a^2)^2 + 4 a^2 z^2)); the last two are None for
    Schwarzschild."""
    a0, a1, a2 = a
    rho2 = a0 * a0 + a1 * a1 + a2 * a2
    if spin is None:
        return torch.sqrt(rho2), None, None
    bq = rho2 - spin * spin
    S = torch.sqrt(bq * bq + 4.0 * spin * spin * a2 * a2)
    r2 = 0.5 * (bq + S)
    return torch.sqrt(torch.clamp_min(r2, R2_FLOOR)), r2, S


def _ratio_pow(ratio, power):
    """(ratio^power, its derivative) in the four forms of ``_dt_soa``.  The
    derivative is only read where ratio^power lies inside (1, boost), so
    ratio > 1 there."""
    if power == 1.5:                      # the sqrt form of the hot case
        sq = torch.sqrt(torch.clamp_min(ratio, 0.0))
        return ratio * sq, sq + 0.5 * ratio / sq
    if power == 2.0:
        return ratio * ratio, 2.0 * ratio
    if power == 1.0:
        return ratio, torch.ones_like(ratio)
    m = torch.clamp_min(ratio, 1e-20)
    return m ** power, power * m ** (power - 1.0)


def step_size(a, active, scal, power, kerr=False):
    """Per-ray step dt * clip((r / r_ref)^power, 1, boost) (``_dt_soa``);
    ``scal`` is the NSCAL vector (a tensor or a sequence), r the
    Kerr-Schild radius of spin ``scal[9]`` when ``kerr``."""
    dt0, boost, r_ref = scal[1], scal[2], scal[3]
    ra, _, _ = radius(a, scal[SPIN] if kerr else None)
    rp, _ = _ratio_pow(ra / r_ref, power)
    dt = torch.where(active, dt0, torch.zeros_like(ra))
    return dt * torch.clamp(torch.clamp_min(rp, 1.0), max=boost)


def step_size_vjp(a, active, scal, power, gh, kerr=False):
    """VJP of ``step_size`` for the cotangent ``gh`` of the step.

    Returns (g_a, g_dt, g_boost, g_r_ref), all per ray, and with ``kerr``
    also the spin's, g_spin.  The Kerr-Schild radius has dr/dx_i = (r^2 x_i +
    a^2 z delta_i2) / (r S) and dr/da = a (z^2 - r^2) / (r S)
    (pallas_kernel.py:87-88), and no gradient below its floor."""
    dt0, boost, r_ref = scal[1], scal[2], scal[3]
    a0, a1, a2 = a
    zero = torch.zeros_like(a0)
    spin = scal[SPIN] if kerr else None
    ra, r2, S = radius(a, spin)
    ratio = ra / r_ref
    rp, drp = _ratio_pow(ratio, power)
    lo = torch.clamp_min(rp, 1.0)
    c = torch.clamp(lo, max=boost)
    dt_a = torch.where(active, dt0, zero)
    g_c = gh * dt_a
    g_dt = torch.where(active, gh * c, zero)
    g_boost = torch.where(lo > boost, g_c, zero)
    inner = (rp > 1.0) & (lo < boost)
    g_ratio = torch.where(inner, g_c * torch.where(inner, drp, zero), zero)
    g_ra = g_ratio / r_ref
    g_r_ref = -g_ratio * ratio / r_ref
    if not kerr:
        k = g_ra / torch.where(ra > 0, ra, torch.ones_like(ra))
        return (k * a0, k * a1, k * a2), g_dt, g_boost, g_r_ref
    den = ra * S
    live = (r2 > R2_FLOOR) & (den > 0)
    k = torch.where(live, g_ra / torch.where(live, den, 1.0), zero)
    az = spin * spin * a2
    return ((k * r2 * a0, k * r2 * a1, k * (r2 * a2 + az)), g_dt, g_boost,
            g_r_ref, k * spin * (a2 * a2 - r2))


def segment_events(x, y, scal, sph, has_disk):
    """Events on the segment x -> y, as ``_events_merge`` finds them.

    ``x``, ``y``: 3-tuples (pre-step position, RK4 endpoint); ``sph`` the
    (K, 4) table [cx, cy, cz, radius] or None.  Returns (t_disk, t_sph,
    sid): the segment fractions of the disk crossing and of the first
    sphere entry (inf where there is none) and the entered sphere's index
    (-1 where none).  Spheres are tested in index order and a later one
    must come strictly earlier, so ties go to the lowest index."""
    x0, x1, x2 = x
    y0, y1, y2 = y
    inf = torch.full_like(x0, float("inf"))
    t_disk = inf
    if has_disk:
        crossed = ((y2 < 0) & (x2 >= 0)) | ((y2 > 0) & (x2 <= 0))
        denom = y2 - x2
        t = -x2 / torch.where(torch.abs(denom) > 0, denom,
                              torch.ones_like(denom))
        d0p = x0 + (y0 - x0) * t
        d1p = x1 + (y1 - x1) * t
        rr = torch.sqrt(d0p * d0p + d1p * d1p)
        hit = crossed & (rr >= scal[7]) & (rr <= scal[8])
        t_disk = torch.where(hit, t, inf)
    t_sph = inf
    sid = torch.full(x0.shape, -1, dtype=torch.int32, device=x0.device)
    if sph is not None:
        dx0, dx1, dx2 = y0 - x0, y1 - x1, y2 - x2
        aa = dx0 * dx0 + dx1 * dx1 + dx2 * dx2
        denom_a = torch.where(aa > 0, 2.0 * aa, torch.ones_like(aa))
        for k in range(sph.shape[0]):
            o0, o1, o2 = x0 - sph[k, 0], x1 - sph[k, 1], x2 - sph[k, 2]
            bb = 2.0 * (o0 * dx0 + o1 * dx1 + o2 * dx2)
            cc = o0 * o0 + o1 * o1 + o2 * o2 - sph[k, 3] * sph[k, 3]
            disc = bb * bb - 4.0 * aa * cc
            sq = torch.sqrt(torch.where(disc > 0, disc, torch.ones_like(disc)))
            t = (-bb - sq) / denom_a
            valid = (disc > 0) & (t >= 0.0) & (t <= 1.0) & (t < t_sph)
            t_sph = torch.where(valid, t, t_sph)
            sid = torch.where(valid, k, sid).to(torch.int32)
    return t_disk, t_sph, sid


def events_vjp(x, y, upd, scal, sph, has_disk, g):
    """Transpose of the position merge of ``_events_merge``.

    The merge sends x' = y (a ray that moved), x (a frozen or non-finite
    step), x + (y - x) t_disk with z' = 0 (DISK), or x + (y - x) t_sph
    (OBJECT).  ``upd`` = active & finite; ``g`` the 3-tuple cotangent of
    x'.  Returns (g_x, g_y, g_sph): the cotangents of the pre-step x, of
    the RK4 endpoint y and of the (K, 4) sphere table (None without
    spheres).

    Disk: t = -x2 / (y2 - x2), so dt/dx2 = (t - 1) / (y2 - x2) and
    dt/dy2 = -t / (y2 - x2); the crossing test makes y2 - x2 non-zero.
    Sphere: t = (-bb - sqrt(disc)) / (2 aa) with aa = |D|^2, bb = 2 o.D,
    cc = |o|^2 - r^2, D = y - x, o = x - c, so dt/daa = (cc / sq - t) / aa,
    dt/dbb = -(1 + bb / sq) / (2 aa), dt/dcc = 1 / sq; an entry has
    disc > 0 and aa > 0."""
    t_disk, t_sph, sid = segment_events(x, y, scal, sph, has_disk)
    zero = torch.zeros_like(x[0])
    sel_disk = upd & torch.isfinite(t_disk) & (t_disk <= t_sph)
    sel_sph = upd & torch.isfinite(t_sph) & ~sel_disk
    moved = upd & ~sel_disk & ~sel_sph
    D = [y[i] - x[i] for i in range(3)]
    g_x = [torch.where(upd, zero, g[i]) for i in range(3)]
    g_y = [torch.where(moved, g[i], zero) for i in range(3)]
    if has_disk:
        t = torch.where(sel_disk, t_disk, zero)
        den = torch.where(sel_disk, D[2], torch.ones_like(zero))
        gd = [torch.where(sel_disk, g[i], zero) for i in range(2)]
        gt = gd[0] * D[0] + gd[1] * D[1]
        for i in range(2):
            g_x[i] = g_x[i] + (1.0 - t) * gd[i]
            g_y[i] = g_y[i] + t * gd[i]
        g_x[2] = g_x[2] + gt * (t - 1.0) / den
        g_y[2] = g_y[2] - gt * t / den
    g_sph = None
    if sph is not None:
        t = torch.where(sel_sph, t_sph, zero)
        gs = [torch.where(sel_sph, g[i], zero) for i in range(3)]
        gt = gs[0] * D[0] + gs[1] * D[1] + gs[2] * D[2]
        for i in range(3):
            g_x[i] = g_x[i] + (1.0 - t) * gs[i]
            g_y[i] = g_y[i] + t * gs[i]
        aa = D[0] * D[0] + D[1] * D[1] + D[2] * D[2]
        rows = []
        for k in range(sph.shape[0]):
            m = sel_sph & (sid == k)
            o = [x[i] - sph[k, i] for i in range(3)]
            bb = 2.0 * (o[0] * D[0] + o[1] * D[1] + o[2] * D[2])
            cc = o[0] * o[0] + o[1] * o[1] + o[2] * o[2] - sph[k, 3] * sph[k, 3]
            disc = bb * bb - 4.0 * aa * cc
            one = torch.ones_like(zero)
            sq = torch.sqrt(torch.where(m, disc, one))
            aak = torch.where(m, aa, one)
            gtk = torch.where(m, gt, zero)
            g_aa = gtk * (cc / sq - t) / aak
            g_bb = -gtk * (1.0 + bb / sq) / (2.0 * aak)
            g_cc = gtk / sq
            row = []
            for i in range(3):
                gD = 2.0 * g_aa * D[i] + 2.0 * g_bb * o[i]
                go = 2.0 * g_bb * D[i] + 2.0 * g_cc * o[i]
                g_y[i] = g_y[i] + gD
                g_x[i] = g_x[i] - gD + go
                row.append(-go.sum())
            row.append((-2.0 * sph[k, 3] * g_cc).sum())
            rows.append(torch.stack(row))
        g_sph = torch.stack(rows)
    return g_x, g_y, g_sph


def step_adjoint(x, p, E, status, scal, g, power, sph=None, has_disk=False,
                 kerr=False):
    """Transpose of one RK4 step with its events, Schwarzschild or (with
    ``kerr``) Kerr of spin ``scal[9]``.

    ``x``, ``p``: the taped pre-step state (3-tuples); ``E``, ``status``
    per ray; ``scal`` the NSCAL vector; ``g`` the 6-tuple cotangent of the
    step's (x', p'); ``sph`` the (K, 4) sphere table or None; ``has_disk``
    whether the disk is tested.  Returns (g6, g_E, g_scal, g_sph): the
    cotangent of (x, p), the per-ray cotangent of E, the (NSCAL,) scalar
    cotangent summed over the rays (mass, dt, boost, r_ref and, for Kerr,
    the spin; the other entries are zero) and the (K, 4) sphere cotangent
    (None without spheres)."""
    mass, spin = scal[0], scal[SPIN]
    active = status == ACTIVE
    h = step_size(x, active, scal, power, kerr)
    y = (*x, *p)

    def axpy(c, ks):
        return tuple(yi + c * ki for yi, ki in zip(y, ks))

    def stage(pt):
        if kerr:
            return kerr_rhs_soa(mass, spin, E, *pt)
        return rhs(mass, E, pt[:3], pt[3:])

    def stage_vjp(pt, gk):
        """(g_pt, g_E, g_mass, g_spin) of one stage; g_spin 0 without
        spin."""
        if kerr:
            return rhs_kerr_vjp(mass, spin, E, pt[:3], pt[3:], gk)
        return (*rhs_vjp(mass, E, pt[:3], pt[3:], gk), 0.0)

    # forward stage chain, as in the step (integrate.rk4_step / _soa_step)
    ka = stage(y)
    yb = axpy(0.5 * h, ka)
    kb = stage(yb)
    yc = axpy(0.5 * h, kb)
    kc = stage(yc)
    yd = axpy(h, kc)
    kd = stage(yd)
    s6 = h * (1.0 / 6.0)
    ksum = tuple(ka[i] + 2.0 * (kb[i] + kc[i]) + kd[i] for i in range(6))
    ynew = tuple(y[i] + s6 * ksum[i] for i in range(6))
    finite = torch.isfinite(ynew[0])
    for comp in ynew[1:]:
        finite = finite & torch.isfinite(comp)
    upd = active & finite
    zero = torch.zeros_like(h)

    def keep(v):
        return torch.where(upd, v, zero)

    # transpose of the freeze y' = where(upd, ynew, y) and of the event
    # points: gy to the RK4 endpoint, g_old to the pre-step state
    g_sph = None
    if has_disk or sph is not None:
        g_old, gy, g_sph = events_vjp(x, ynew[:3], upd, scal, sph, has_disk,
                                      g[:3])
    else:
        g_old = [torch.where(upd, zero, g[i]) for i in range(3)]
        gy = [keep(g[i]) for i in range(3)]
    gy = (*gy, *(keep(g[i]) for i in range(3, 6)))
    g_old = (*g_old, *(torch.where(upd, zero, g[i]) for i in range(3, 6)))

    # transpose of the RK4 skeleton
    gh = (1.0 / 6.0) * sum(gy[i] * ksum[i] for i in range(6))
    gd, gE_d, gm_d, gs_d = stage_vjp(yd, tuple(s6 * gy[i] for i in range(6)))
    gh = gh + sum(gd[i] * kc[i] for i in range(6))
    gkc = tuple(2.0 * s6 * gy[i] + h * gd[i] for i in range(6))
    gc, gE_c, gm_c, gs_c = stage_vjp(yc, gkc)
    gh = gh + 0.5 * sum(gc[i] * kb[i] for i in range(6))
    gkb = tuple(2.0 * s6 * gy[i] + 0.5 * h * gc[i] for i in range(6))
    gb, gE_b, gm_b, gs_b = stage_vjp(yb, gkb)
    gh = gh + 0.5 * sum(gb[i] * ka[i] for i in range(6))
    gka = tuple(s6 * gy[i] + 0.5 * h * gb[i] for i in range(6))
    ga, gE_a, gm_a, gs_a = stage_vjp(y, gka)
    gx = [gy[i] + gd[i] + gc[i] + gb[i] + ga[i] for i in range(6)]
    g_E = gE_d + gE_c + gE_b + gE_a
    g_mass = gm_d + gm_c + gm_b + gm_a

    # transpose of the per-ray step size
    g_a, g_dt, g_boost, g_r_ref, *gs_h = step_size_vjp(x, active, scal,
                                                        power, gh, kerr)
    for i in range(3):
        gx[i] = gx[i] + g_a[i]

    g6 = tuple(keep(gx[i]) + g_old[i] for i in range(6))
    g_scal = torch.zeros(NSCAL, dtype=h.dtype, device=h.device)
    for j, v in enumerate((g_mass, g_dt, g_boost, g_r_ref)):
        g_scal[j] = keep(v).sum()
    if kerr:
        g_scal[SPIN] = keep(gs_d + gs_c + gs_b + gs_a + gs_h[0]).sum()
    return g6, keep(g_E), g_scal, g_sph


# =============================================================================
# One adaptive Dormand-Prince trip and its transpose.
# =============================================================================
class Controller(typing.NamedTuple):
    """The step controller's constants: the error norm's tolerances and
    the clip of the per-ray step."""

    rtol: float
    atol: float
    min_step: float
    max_step: float


def jax_abs(v):
    """|v| with the derivative JAX gives it: +1 at v = 0 (sign(0) is 0 in
    ``torch.abs``'s), so a component that is exactly 0 scales the error
    norm's gradient as in the reference."""
    return torch.where(v >= 0, v, -v)


def _dmax(a, b):
    """d max(a, b) / d a as ``jax.vjp`` takes it: 1, 1/2 at a tie, 0."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def _dmin(a, b):
    """d min(a, b) / d a: 1, 1/2 at a tie, 0."""
    return torch.where(a < b, 1.0, torch.where(a == b, 0.5, 0.0))


def _stage_rhs(scal, E, pt, kerr):
    if kerr:
        return kerr_rhs_soa(scal[0], scal[SPIN], E, *pt)
    return rhs(scal[0], E, pt[:3], pt[3:])


def _dopri_stages(y, E, dt, scal, kerr):
    """The seven stages of the trip from y (a 6-tuple) with step dt:
    (k_0..k_6, Y_0..Y_6), Y_i = y + sum_j (dt a_ij) k_j."""
    ks, pts = [], []
    for i in range(7):
        pt = y
        for j, a in enumerate(_DP_A[i]):
            if a != 0.0:
                pt = tuple(b + (dt * a) * k for b, k in zip(pt, ks[j]))
        pts.append(pt)
        ks.append(_stage_rhs(scal, E, pt, kerr))
    return ks, pts


def _comb(ks, weights):
    out = [torch.zeros_like(ks[0][0])] * 6
    for k, b in zip(ks, weights):
        if b != 0.0:
            out = [o + b * kc for o, kc in zip(out, k)]
    return out


def _error_norm(y, y5, e, ctl):
    """The scaled RMS error (1/6 sum_c (e_c / s_c)^2)^(1/2), s_c = atol +
    rtol max(|y_c|, |y5_c|); 0 where it is 0 (the double-where guard of
    pallas_kernel.py:445-449).  Returns (errn, err2, s, r = e / s)."""
    scale = [ctl.atol + ctl.rtol * torch.maximum(jax_abs(b), jax_abs(c))
             for b, c in zip(y, y5)]
    r = [ec / sc for ec, sc in zip(e, scale)]
    err2 = torch.zeros_like(r[0])
    for rc in r:
        err2 = err2 + rc * rc
    err2 = err2 * (1.0 / 6.0)
    pos = err2 > 0
    errn = torch.where(pos, torch.sqrt(torch.where(pos, err2, 1.0)), 0.0)
    return errn, err2, scale, r


def events_merge(x, p, y, q, dt, lam, status, hit_obj, scal, sph=None,
                 has_disk=False, kerr=False):
    """The endpoint classification and freeze merge of ``_events_merge``
    (:272-317) for the step (x, p) -> (y, q) of length dt (3-tuples;
    ``sph`` the (K, 4) sphere table or None).  Returns (x', p', lam',
    status', hit_obj'); a frozen ray keeps its state."""
    active = status == ACTIVE
    t_disk, t_sph, sid = segment_events(x, y, scal, sph, has_disk)
    rb, _, _ = radius(y, scal[SPIN] if kerr else None)
    lam1 = lam + dt
    finite = torch.isfinite(y[0])
    for c in (*y[1:], *q):
        finite = finite & torch.isfinite(c)
    st = torch.where(lam1 >= scal[6], BUDGET, ACTIVE)
    st = torch.where(rb >= scal[5], ESCAPED, st)
    st = torch.where(rb <= scal[4], CAPTURED, st)
    st = torch.where(~finite, ERROR, st)
    if sph is not None:
        st = torch.where(torch.isfinite(t_sph), OBJECT, st)
    if has_disk:
        st = torch.where(torch.isfinite(t_disk) & (t_disk <= t_sph), DISK, st)
    st = torch.where(active, st, status).to(status.dtype)
    upd = active & finite
    xn = [torch.where(upd, a, b) for a, b in zip(y, x)]
    pn = [torch.where(upd, a, b) for a, b in zip(q, p)]
    lam1 = torch.where(active, lam1, lam)
    obj = hit_obj
    for ev, t_ev in (("sph", t_sph), ("disk", t_disk)):
        if (ev == "sph" and sph is None) or (ev == "disk" and not has_disk):
            continue
        sel = active & (st == (OBJECT if ev == "sph" else DISK))
        t = torch.where(torch.isfinite(t_ev), t_ev, 0.0)
        n = 3 if ev == "sph" else 2
        for c in range(n):
            xn[c] = torch.where(sel, x[c] + (y[c] - x[c]) * t, xn[c])
        if ev == "disk":
            xn[2] = torch.where(sel, 0.0, xn[2])
        else:
            obj = torch.where(sel, sid, obj)
        lam1 = torch.where(sel, lam + dt * t, lam1)
    return tuple(xn), tuple(pn), lam1, st, obj


def dopri_trip(x, p, E, h, lam, status, hit_obj, scal, ctl, sph=None,
               has_disk=False, kerr=False):
    """One adaptive Dormand-Prince trip (``_dopri_trip``): the embedded
    step of length h from (x, p) (3-tuples), its scaled RMS error, accept
    if it is at most 1 or h is at most min_step, the events of an accepted
    step, and the next h = clip(h f, min_step, max_step), f = clip(0.9
    errn^-0.2, 0.2, 5), for a ray still ACTIVE after the trip; a frozen
    ray keeps everything.  ``ctl`` is a ``Controller``.  Returns (x', p',
    h', lam', status', hit_obj')."""
    y = (*x, *p)
    live = status == ACTIVE
    dt = torch.where(live, h, 0.0)
    ks, _ = _dopri_stages(y, E, dt, scal, kerr)
    c5, ce = _comb(ks, _DP_B5), _comb(ks, _DP_E)
    y5 = tuple(b + dt * c for b, c in zip(y, c5))
    errn = _error_norm(y, y5, [dt * c for c in ce], ctl)[0]
    accept = ((errn <= 1.0) | (h <= ctl.min_step)) & live
    xm, pm, lam1, st1, obj1 = events_merge(
        x, p, y5[:3], y5[3:], dt, lam, status, hit_obj, scal, sph, has_disk,
        kerr)
    x_next = tuple(torch.where(accept, a, b) for a, b in zip(xm, x))
    p_next = tuple(torch.where(accept, a, b) for a, b in zip(pm, p))
    st_next = torch.where(accept, st1, status)
    factor = _clip(0.9 * torch.where(errn > 0, errn, 1e-10) ** -0.2, 0.2,
                   5.0)
    h_next = torch.where((st_next == ACTIVE) & live,
                         _clip(h * factor, ctl.min_step, ctl.max_step), h)
    return (x_next, p_next, h_next, torch.where(accept, lam1, lam), st_next,
            torch.where(accept, obj1, hit_obj))


def dopri_trip_vjp(x, p, E, h, lam, status, scal, ctl, g, gh, sph=None,
                   has_disk=False, kerr=False):
    """Transpose of ``dopri_trip`` with respect to (x, p, E, h, scal, sph)
    for the cotangents ``g`` (6-tuple) of the next (x, p) and ``gh`` of the
    next h, at the taped pre-trip state.  Accept, reject and the event
    selectors are decisions (no gradient); the controller is
    differentiated.  For a ray that was ACTIVE and whose step is finite:

    * the controller: a ray still ACTIVE after the trip has h' = clip(h f)
      and sends gh f to h and gh h 0.9 (-0.2) errn^-1.2 to errn inside
      both clips (half at a tie, nothing past an edge; f is a constant
      where errn = 0); a ray that ended passes gh to h;
    * the state: an accepted trip transposes the merge (``events_vjp``,
      the segment y -> y5) into cotangents of y5 and y; a rejected one
      passes g to y;
    * the error norm, accepted or rejected: errn = sqrt(err2), err2 = 1/6
      sum_c (e_c / s_c)^2, e_c = dt sum_i E_i k_i,c, s_c = atol + rtol
      max(|y_c|, |y5_c|); its cotangent reaches e (then the k_i and dt)
      and s (then y and y5);
    * y5 = y + dt sum_i b_i k_i, then the stages in reverse, i = 6..0:
      ``rhs_vjp``/``rhs_kerr_vjp`` at Y_i adds the E, mass and spin
      cotangents and sends the rest to y, to each k_j (j < i, through
      dt a_ij) and to dt;
    * dt = h.

    A frozen ray, or one whose step is not finite (its state and h no
    longer move, or move to NaN), passes g and gh through and adds
    nothing.  Returns (g6, g_E, g_h, g_scal, g_sph): per ray the cotangents
    of (x, p), E and h, the (NSCAL,) scalar cotangent summed over the rays
    (mass and, for Kerr, the spin; the other entries are zero) and the
    (K, 4) sphere cotangent (None without spheres)."""
    y = (*x, *p)
    live = status == ACTIVE
    zero = torch.zeros_like(h)
    dt = torch.where(live, h, zero)
    ks, pts = _dopri_stages(y, E, dt, scal, kerr)
    c5, ce = _comb(ks, _DP_B5), _comb(ks, _DP_E)
    y5 = tuple(b + dt * c for b, c in zip(y, c5))
    errn, err2, scale, r = _error_norm(y, y5, [dt * c for c in ce], ctl)
    accept = ((errn <= 1.0) | (h <= ctl.min_step)) & live
    finite = torch.isfinite(y5[0])
    for c in y5[1:]:
        finite = finite & torch.isfinite(c)
    ok = live & finite
    st1 = events_merge(x, p, y5[:3], y5[3:], dt, lam, status,
                       torch.full_like(status, -1), scal, sph, has_disk,
                       kerr)[3]
    h_active = (torch.where(accept, st1, status) == ACTIVE) & live

    # the controller: h' = min(max(h f, min_step), max_step),
    # f = min(max(u, 0.2), 5), u = 0.9 errg^-0.2, errg = errn or 1e-10
    errg = torch.where(errn > 0, errn, 1e-10)
    u = 0.9 * errg ** -0.2
    u1 = torch.maximum(u, u.new_tensor(0.2))
    f = torch.minimum(u1, u.new_tensor(5.0))
    v = h * f
    v1 = torch.maximum(v, v.new_tensor(ctl.min_step))
    g_v = torch.where(h_active, gh, zero) * _dmin(v1, ctl.max_step) \
        * _dmax(v, ctl.min_step)
    g_h = torch.where(h_active, g_v * f, gh)
    g_u = g_v * h * _dmin(u1, 5.0) * _dmax(u, 0.2)
    g_errn = torch.where(errn > 0, g_u * 0.9 * (-0.2 * errg ** -1.2), zero)

    # the state: x' = merge(y, y5) if accepted, else y
    upd = accept & finite
    g_y5 = [None] * 6
    g_sph = None
    if has_disk or sph is not None:
        g_old, g_y5[:3], g_sph = events_vjp(x, y5[:3], upd, scal, sph,
                                            has_disk, g[:3])
    else:
        g_old = [torch.where(upd, zero, g[c]) for c in range(3)]
        g_y5[:3] = [torch.where(upd, g[c], zero) for c in range(3)]
    g_y = list(g_old) + [torch.where(upd, zero, g[c]) for c in range(3, 6)]
    g_y5[3:] = [torch.where(upd, g[c], zero) for c in range(3, 6)]

    # the error norm
    safe = torch.where(err2 > 0, errn, 1.0)
    g_err2 = torch.where(err2 > 0, g_errn * (0.5 / safe), zero)
    g_dt = zero
    g_ce = []
    for c in range(6):
        g_r = g_err2 * (1.0 / 6.0) * 2.0 * r[c]
        g_e = g_r / scale[c]
        g_m = -g_r * r[c] / scale[c] * ctl.rtol
        a, b = jax_abs(y[c]), jax_abs(y5[c])
        g_y[c] = g_y[c] + g_m * _dmax(a, b) * torch.where(y[c] >= 0, 1.0,
                                                          -1.0)
        g_y5[c] = g_y5[c] + g_m * _dmax(b, a) * torch.where(y5[c] >= 0, 1.0,
                                                            -1.0)
        g_dt = g_dt + g_e * ce[c]
        g_ce.append(g_e * dt)

    # y5 = y + dt c5
    for c in range(6):
        g_y[c] = g_y[c] + g_y5[c]
        g_dt = g_dt + g_y5[c] * c5[c]
    g_c5 = [dt * gc for gc in g_y5]
    g_k = [[b5 * g_c5[c] + de * g_ce[c] for c in range(6)]
           for b5, de in zip(_DP_B5, _DP_E)]

    # the stages, last first
    g_E, g_mass, g_spin = zero, zero, zero
    for i in range(6, -1, -1):
        pt = pts[i]
        if kerr:
            g_pt, gE_i, gm_i, gs_i = rhs_kerr_vjp(scal[0], scal[SPIN], E,
                                                  pt[:3], pt[3:], g_k[i])
            g_spin = g_spin + gs_i
        else:
            g_pt, gE_i, gm_i = rhs_vjp(scal[0], E, pt[:3], pt[3:], g_k[i])
        g_E, g_mass = g_E + gE_i, g_mass + gm_i
        for c in range(6):
            g_y[c] = g_y[c] + g_pt[c]
        for j, a in enumerate(_DP_A[i]):
            if a != 0.0:
                dot = g_pt[0] * ks[j][0]
                for c in range(1, 6):
                    dot = dot + g_pt[c] * ks[j][c]
                g_dt = g_dt + a * dot
                g_k[j] = [g_k[j][c] + (dt * a) * g_pt[c] for c in range(6)]
    g_h = g_h + g_dt

    g6 = tuple(torch.where(ok, g_y[c], g[c]) for c in range(6))
    g_scal = torch.zeros(NSCAL, dtype=h.dtype, device=h.device)
    g_scal[0] = torch.where(ok, g_mass, zero).sum()
    if kerr:
        g_scal[SPIN] = torch.where(ok, g_spin, zero).sum()
    return (g6, torch.where(ok, g_E, zero), torch.where(ok, g_h, gh), g_scal,
            g_sph)
