"""The exact discrete adjoint of one RK4 step, written by hand.

Counterpart of ``_step_adjoint`` (pallas_kernel.py:1025-1153) for the step
the gradient path runs: Schwarzschild, with or without the disk and sphere
events.  It is the plain PyTorch statement of what ``csrc/rk4_bwd.cu``
computes, line for line:

* ``rhs_vjp`` -- the VJP of ``_rhs_schw_soa`` (:63-81), including the
  ``r^2 >= 1e-12`` floor;
* ``step_size_vjp`` -- the VJP of ``_dt_soa`` (:156-175) for the four step
  size powers and the clip to [1, boost];
* ``segment_events`` and ``events_vjp`` -- the event detection of
  ``_events_merge`` (:211-270) and, derived by hand, the transpose of its
  position merge (what the TPU kernel takes with ``jax.vjp`` of
  ``_events_merge``, :1089-1111): a disk or sphere event point
  ``x + (y - x) t`` sends its cotangent to the pre-step x, to the RK4
  endpoint y and, for a sphere, to the hit sphere's centre and radius;
* ``step_adjoint`` -- the RK4 skeleton transposed (:1124-1144) behind the
  transpose of the freeze ``y' = where(active & finite, rk4, y)``
  (:1112-1122) and of the event points.

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
cotangents are zero.
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


def step_adjoint(x, p, E, status, scal, g, power, sph=None, has_disk=False):
    """Transpose of one Schwarzschild RK4 step with its events.

    ``x``, ``p``: the taped pre-step state (3-tuples); ``E``, ``status``
    per ray; ``scal`` the NSCAL vector; ``g`` the 6-tuple cotangent of the
    step's (x', p'); ``sph`` the (K, 4) sphere table or None; ``has_disk``
    whether the disk is tested.  Returns (g6, g_E, g_scal, g_sph): the
    cotangent of (x, p), the per-ray cotangent of E, the (NSCAL,) scalar
    cotangent summed over the rays (mass, dt, boost and r_ref; the other
    entries are zero) and the (K, 4) sphere cotangent (None without
    spheres)."""
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
    return g6, keep(g_E), g_scal, g_sph
