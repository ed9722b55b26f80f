"""The exact discrete adjoint of one RK4 step, written by hand.

Counterpart of ``_step_adjoint`` (pallas_kernel.py:1025-1153) for the step
the gradient path runs: Schwarzschild, no disk and no spheres.  It is the
plain PyTorch statement of what ``csrc/rk4_bwd.cu`` computes, line for line:

* ``rhs_vjp`` -- the VJP of ``_rhs_schw_soa`` (:63-81), including the
  ``r^2 >= 1e-12`` floor;
* ``step_size_vjp`` -- the VJP of ``_dt_soa`` (:156-175) for the four step
  size powers and the clip to [1, boost];
* ``step_adjoint`` -- the RK4 skeleton transposed (:1124-1144) behind the
  masked pass-through transpose of the freeze
  ``y' = where(active & finite, rk4, y)`` (:1112-1122).

Every function works on structure-of-arrays tuples of tensors of one batch
shape, one tensor per component.  The CUDA kernel cannot run on the CPU, so
the tests hold this module against ``jax.vjp`` and against
``torch.autograd`` of ``integrate._fixed_step`` instead.

A step whose ray is frozen or whose RK4 endpoint is not finite is the
identity on (x, p) and contributes nothing to the E and scalar cotangents:
the kernel skips it, and here its contributions are masked to zero, so no
0 * inf from a frozen ray's Jacobian reaches a shared cotangent.
"""

from __future__ import annotations

import torch

from .states import ACTIVE

NSCAL = 10
R2_FLOOR = 1e-12


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


def step_size(a, active, scal, power):
    """Per-ray step dt * clip((r / r_ref)^power, 1, boost) (``_dt_soa``);
    ``scal`` is the NSCAL vector (a tensor or a sequence)."""
    dt0, boost, r_ref = scal[1], scal[2], scal[3]
    a0, a1, a2 = a
    ra = torch.sqrt(a0 * a0 + a1 * a1 + a2 * a2)
    rp, _ = _ratio_pow(ra / r_ref, power)
    dt = torch.where(active, dt0, torch.zeros_like(ra))
    return dt * torch.clamp(torch.clamp_min(rp, 1.0), max=boost)


def step_size_vjp(a, active, scal, power, gh):
    """VJP of ``step_size`` for the cotangent ``gh`` of the step.

    Returns (g_a, g_dt, g_boost, g_r_ref), all per ray."""
    dt0, boost, r_ref = scal[1], scal[2], scal[3]
    a0, a1, a2 = a
    zero = torch.zeros_like(a0)
    ra = torch.sqrt(a0 * a0 + a1 * a1 + a2 * a2)
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
    k = g_ra / torch.where(ra > 0, ra, torch.ones_like(ra))
    return (k * a0, k * a1, k * a2), g_dt, g_boost, g_r_ref


def step_adjoint(x, p, E, status, scal, g, power):
    """Transpose of one event-free Schwarzschild RK4 step.

    ``x``, ``p``: the taped pre-step state (3-tuples); ``E``, ``status``
    per ray; ``scal`` the NSCAL vector; ``g`` the 6-tuple cotangent of the
    step's (x', p').  Returns (g6, g_E, g_scal): the cotangent of (x, p),
    the per-ray cotangent of E and the (NSCAL,) scalar cotangent summed over
    the rays (mass, dt, boost and r_ref; the other entries are zero)."""
    mass = scal[0]
    active = status == ACTIVE
    h = step_size(x, active, scal, power)
    y = (*x, *p)

    def axpy(c, ks):
        return tuple(yi + c * ki for yi, ki in zip(y, ks))

    def stage(pt):
        return rhs(mass, E, pt[:3], pt[3:])

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

    # transpose of the freeze y' = where(upd, ynew, y): gy to the RK4
    # endpoint, the rest straight through to the old state
    gy = tuple(keep(gi) for gi in g)
    g_old = tuple(torch.where(upd, zero, gi) for gi in g)

    # transpose of the RK4 skeleton
    gh = (1.0 / 6.0) * sum(gy[i] * ksum[i] for i in range(6))
    gd, gE_d, gm_d = rhs_vjp(mass, E, yd[:3], yd[3:],
                             tuple(s6 * gy[i] for i in range(6)))
    gh = gh + sum(gd[i] * kc[i] for i in range(6))
    gkc = tuple(2.0 * s6 * gy[i] + h * gd[i] for i in range(6))
    gc, gE_c, gm_c = rhs_vjp(mass, E, yc[:3], yc[3:], gkc)
    gh = gh + 0.5 * sum(gc[i] * kb[i] for i in range(6))
    gkb = tuple(2.0 * s6 * gy[i] + 0.5 * h * gc[i] for i in range(6))
    gb, gE_b, gm_b = rhs_vjp(mass, E, yb[:3], yb[3:], gkb)
    gh = gh + 0.5 * sum(gb[i] * ka[i] for i in range(6))
    gka = tuple(s6 * gy[i] + 0.5 * h * gb[i] for i in range(6))
    ga, gE_a, gm_a = rhs_vjp(mass, E, y[:3], y[3:], gka)
    gx = [gy[i] + gd[i] + gc[i] + gb[i] + ga[i] for i in range(6)]
    g_E = gE_d + gE_c + gE_b + gE_a
    g_mass = gm_d + gm_c + gm_b + gm_a

    # transpose of the per-ray step size
    g_a, g_dt, g_boost, g_r_ref = step_size_vjp(x, active, scal, power, gh)
    for i in range(3):
        gx[i] = gx[i] + g_a[i]

    g6 = tuple(keep(gx[i]) + g_old[i] for i in range(6))
    g_scal = torch.zeros(NSCAL, dtype=h.dtype, device=h.device)
    for j, v in enumerate((g_mass, g_dt, g_boost, g_r_ref)):
        g_scal[j] = keep(v).sum()
    return g6, keep(g_E), g_scal
