"""The per-ray shading and its VJP, written by hand.

The plain PyTorch statement of what ``csrc/shade.cuh`` computes, line for
line: the final direction and the shading of ``integrate.final_direction``
and ``scene/shading.py`` ``shade``, each ray by its own branch, and the
transpose of each branch.  ``csrc/shade.cu`` (forward) and
``csrc/shade_bwd.cu`` (backward) run it one thread a ray; the CUDA kernels
cannot run on the CPU, so the tests hold this module against
``torch.autograd`` of ``final_direction`` + ``shade`` instead.

Branches, by status (``shade``'s select, in its order of precedence):

* ERROR: red; CAPTURED and INSIDE_HORIZON: black;
* OBJECT, when the scene has spheres: ``sphere``, the emission texture at
  the normal's spherical UV mixed with the Lambert lights and their shadow
  segments against the spheres and the horizon;
* DISK, when the scene has a disk: ``disk``, the Gaussian-profile textured
  disk, times g^beaming (``redshift``) when it has a beaming exponent;
* any other status: the sky at the unit coordinate velocity (``velocity``,
  the right-hand side's dx/dlambda), black without a sky.

The scene enters as a ``ShadeScene``: the scalars in one vector (layout
below; an absent entry is 0), the sphere table (K, 8) of [centre, radius,
emission, albedo], the light positions (L, 3) and the textures.  Every
function works on structure-of-arrays tuples of tensors of one batch shape
(n,), one tensor per component.  A branch's quantities are computed for
every ray and kept by ``torch.where`` where the ray takes the branch, so
nothing of another branch reaches a cotangent.  Texture cotangents are
returned as (texture, corner indices, terms) to scatter; ``shade_vjp``
sums them with ``index_put_``.

Rounding follows the kernel: a division by pi is a multiplication by
float32 1/pi (as PyTorch's CUDA division by a Python scalar), the bilinear
weights and coordinates are rounded operation by operation.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import states
from .adjoint import rhs, rhs_kerr_vjp, rhs_vjp
from .geodesic import kerr_rhs_soa

# The scalar vector's layout.
NSH = 11
MASS, SPIN, R_IN, R_OUT, PHASE, MEAN, STDDEV, INTENSITY, BEAMING, \
    ORBIT_DIR, LIGHT_I = range(NSH)
SPH_COLS = 8   # sphere table: cx, cy, cz, radius, emission, albedo r, g, b
DISK_NONE, DISK_PLAIN, DISK_BEAMING = 0, 1, 2

NORM_FLOOR = 1e-20
R2_FLOOR = 1e-12
ACOS_EPS = 1e-6     # texture.safe_arccos's clamp and safe_arctan2's test
SHADOW_EPS = 1e-5   # shading._occluded's self-intersection offset


def _f32(v: float) -> float:
    """``v`` rounded to float32."""
    return float(torch.tensor(v, dtype=torch.float32))


ACOS_LO, ACOS_HI = _f32(-1.0 + ACOS_EPS), _f32(1.0 - ACOS_EPS)
INV_PI = float(torch.tensor(1.0) / torch.tensor(math.pi))
INV_2PI = float(torch.tensor(1.0) / torch.tensor(2.0 * math.pi))
TWO_PI = _f32(2.0 * math.pi)


@dataclasses.dataclass
class ShadeScene:
    """A scene as the shading kernels take it (scene/shading.py
    ``shade_scene`` packs it).  ``disk`` is DISK_NONE, DISK_PLAIN or
    DISK_BEAMING; ``kerr`` selects the Kerr right-hand side for the sky's
    direction."""

    scal: torch.Tensor                 # (NSH,)
    sph: torch.Tensor                  # (K, SPH_COLS), K = 0 without spheres
    lights: torch.Tensor               # (L, 3), L = 0 without lights
    sky: torch.Tensor | None           # (H, W, 3)
    disk_tex: torch.Tensor | None      # (Hd, Wd, 3)
    sph_tex: torch.Tensor | None       # (K, Ht, Wt, 3)
    kerr: bool
    disk: int

    @property
    def n_sph(self) -> int:
        return self.sph.shape[0]

    @property
    def n_lights(self) -> int:
        return self.lights.shape[0] if self.n_sph else 0


def _where(m, v):
    return torch.where(m, v, torch.zeros_like(v))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


# --- the bilinear lookup (texture._SampleBpy) --------------------------------

@dataclasses.dataclass
class Quad:
    """The four corners and weights of a bilinear lookup."""

    tx: torch.Tensor
    ty: torch.Tensor
    xi0: torch.Tensor
    xi1: torch.Tensor
    yi0: torch.Tensor
    yi1: torch.Tensor


def quad(h: int, w: int, u, v) -> Quad:
    """The corners of bpy coords (u, v) in an (h, w) texture: x wraps, y
    clamps, row 0 is the top.  A non-finite coordinate reads corner 0 (the
    kernel may not read outside the texture); |fx|, |fy| are capped at
    2^30, far beyond any texture, so the int64 conversion is defined."""
    fx = (u + 1.0) * 0.5 * w - 0.5
    fy = (1.0 - v) * 0.5 * h - 0.5
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x0f, fy - y0f

    def index(f):
        f = torch.where(torch.isfinite(f), f, torch.zeros_like(f))
        return torch.clamp(f, -2.0**30, 2.0**30).to(torch.int64)

    x0, y0 = index(x0f), index(y0f)
    return Quad(tx, ty, torch.remainder(x0, w), torch.remainder(x0 + 1, w),
                torch.clamp(y0, 0, h - 1), torch.clamp(y0 + 1, 0, h - 1))


def _corners(tex, q: Quad, k=None):
    """The corner colours (c00, c01, c10, c11), each a 3-tuple; ``tex``
    (H, W, 3), or (K, H, W, 3) read at each ray's ``k``."""
    def at(yi, xi):
        c = tex[yi, xi] if k is None else tex[k, yi, xi]
        return c[..., 0], c[..., 1], c[..., 2]
    return (at(q.yi0, q.xi0), at(q.yi0, q.xi1), at(q.yi1, q.xi0),
            at(q.yi1, q.xi1))


def bilinear(tex, u, v, k=None):
    """(rgb 3-tuple, Quad) of the bilinear lookup at (u, v)."""
    h, w = tex.shape[-3], tex.shape[-2]
    q = quad(h, w, u, v)
    c00, c01, c10, c11 = _corners(tex, q, k)
    ax, ay = 1.0 - q.tx, 1.0 - q.ty
    rgb = tuple((a * ax + b * q.tx) * ay + (c * ax + d * q.tx) * q.ty
                for a, b, c, d in zip(c00, c01, c10, c11))
    return rgb, q


def bilinear_vjp(tex, q: Quad, g, k=None):
    """(du, dv, terms): the coordinate cotangents of the lookup for the
    colour cotangent ``g`` (3-tuple), and the texture's, a list of
    (corner indices, (n, 3) terms) to scatter."""
    h, w = tex.shape[-3], tex.shape[-2]
    c00, c01, c10, c11 = _corners(tex, q, k)
    ax, ay = 1.0 - q.tx, 1.0 - q.ty
    fx = fy = 0.0
    for c in range(3):
        fx = fx + g[c] * ((c01[c] - c00[c]) * ay + (c11[c] - c10[c]) * q.ty)
        fy = fy + g[c] * ((c10[c] - c00[c]) * ax + (c11[c] - c01[c]) * q.tx)
    gs = torch.stack(g, dim=-1)
    terms = [((q.yi0, q.xi0), gs * (ax * ay)[..., None]),
             ((q.yi0, q.xi1), gs * (q.tx * ay)[..., None]),
             ((q.yi1, q.xi0), gs * (ax * q.ty)[..., None]),
             ((q.yi1, q.xi1), gs * (q.tx * q.ty)[..., None])]
    if k is not None:
        terms = [((k,) + idx, t) for idx, t in terms]
    return fx * (0.5 * w), fy * (-0.5 * h), terms


# --- the sky: direction and equirect lookup ----------------------------------

def velocity(x, p, E, scal, kerr: bool):
    """dx/dlambda at (x, p): the first three components of the right-hand
    side (adjoint.rhs, geodesic.kerr_rhs_soa)."""
    if kerr:
        return kerr_rhs_soa(scal[MASS], scal[SPIN], E, *x, *p)[:3]
    return rhs(scal[MASS], E, x, p)[:3]


def velocity_vjp(x, p, E, scal, kerr: bool, gv):
    """(gx, gp, gE, g_mass, g_spin) of ``velocity`` for the cotangent
    ``gv``: the right-hand side's VJP with no cotangent on dp."""
    zero = torch.zeros_like(gv[0])
    g = tuple(gv) + (zero, zero, zero)
    if kerr:
        gab, gE, gm, gsp = rhs_kerr_vjp(scal[MASS], scal[SPIN], E, x, p, g)
    else:
        (gab, gE, gm), gsp = rhs_vjp(scal[MASS], E, x, p, g), zero
    return gab[:3], gab[3:], gE, gm, gsp


def unit(v):
    """(v / max(|v|, floor), |v|, max(|v|, floor))."""
    nv = torch.sqrt(_dot(v, v))
    nc = torch.clamp_min(nv, NORM_FLOOR)
    return tuple(c / nc for c in v), nv, nc


def unit_vjp(v, nv, nc, gd):
    """The cotangent of v for ``unit``'s output cotangent ``gd``."""
    g_nc = -_dot(gd, v) / (nc * nc)
    k = _where(nv >= NORM_FLOOR, g_nc / nv)
    return tuple(g / nc + k * c for g, c in zip(gd, v))


def equirect(d):
    """bpy coords of a unit direction in an equirect texture
    (texture.equirect_uv)."""
    cz = torch.clamp(d[2], ACOS_LO, ACOS_HI)
    theta = 1.0 - torch.arccos(cz) * INV_PI
    deg = (torch.abs(d[0]) < ACOS_EPS) & (torch.abs(d[1]) < ACOS_EPS)
    ay = torch.where(deg, torch.zeros_like(d[1]), d[1])
    ax = torch.where(deg, torch.ones_like(d[0]), d[0])
    return -(torch.atan2(ay, ax) * INV_PI), 2.0 * theta - 1.0


def equirect_vjp(d, gu, gv):
    """The cotangent of d for ``equirect``'s (gu, gv)."""
    deg = (torch.abs(d[0]) < ACOS_EPS) & (torch.abs(d[1]) < ACOS_EPS)
    ay = torch.where(deg, torch.zeros_like(d[1]), d[1])
    ax = torch.where(deg, torch.ones_like(d[0]), d[0])
    g_at = -gu * INV_PI
    r2 = ax * ax + ay * ay
    gd0 = _where(~deg, -g_at * ay / r2)
    gd1 = _where(~deg, g_at * ax / r2)
    g_ac = -(2.0 * gv) * INV_PI
    cz = torch.clamp(d[2], ACOS_LO, ACOS_HI)
    inside = (d[2] >= ACOS_LO) & (d[2] <= ACOS_HI)
    gd2 = _where(inside, -g_ac / torch.sqrt(1.0 - cz * cz))
    return gd0, gd1, gd2


# --- the disk -----------------------------------------------------------------

def disk_coords(x, scal):
    """The disk's intermediates at hit point x: a dict of tensors."""
    x0, x1 = x[0], x[1]
    rr = torch.sqrt(x0 * x0 + x1 * x1)
    width = scal[R_OUT] - scal[R_IN]
    span = torch.clamp_min(width, NORM_FLOOR)
    s = (rr - scal[R_IN]) / span
    sy = torch.where(x1 >= 0, 1.0, -1.0)
    rc = torch.clamp_min(rr, NORM_FLOOR)
    c = x0 / rc
    cc = torch.clamp(c, ACOS_LO, ACOS_HI)
    tx = (scal[PHASE] + torch.arccos(cc) * sy) * INV_PI
    e = s - scal[MEAN]
    den = 2.0 * (scal[STDDEV] * scal[STDDEV])
    gauss = torch.exp(-(e * e) / den)
    sq = torch.sqrt(TWO_PI * scal[STDDEV])
    inten = scal[INTENSITY] * gauss / sq
    return dict(rr=rr, width=width, span=span, s=s, sy=sy, rc=rc, c=c,
                cc=cc, tx=tx, e=e, den=den, gauss=gauss, sq=sq, inten=inten)


def redshift(x, p, E, scal):
    """g = E_inf / E_emitted of the Keplerian disk (shading.disk_redshift)
    and its intermediates; g = 0 where ``valid`` is false."""
    x0, x1 = x[0], x[1]
    a, sd, m = scal[SPIN], scal[ORBIT_DIR], scal[MASS]
    zr = x0 * x0 + x1 * x1 - a * a
    r = torch.sqrt(torch.clamp_min(zr, R2_FLOOR))
    sqr = torch.sqrt(r)
    sqm = torch.sqrt(torch.clamp_min(m, NORM_FLOOR))
    big_n = r * sqr + sd * a * sqm
    omega = sd * sqm / big_n
    d2 = r * sqr - 3.0 * m * sqr + sd * 2.0 * a * sqm
    r75 = r ** 0.75
    sd2 = torch.sqrt(torch.clamp_min(d2, R2_FLOOR))
    big_q = r75 * sd2
    ut = big_n / big_q
    lz = x0 * p[1] - x1 * p[0]
    rel = E - omega * lz
    relc = torch.clamp_min(rel, R2_FLOOR)
    e_emit = ut * relc
    ec = torch.clamp_min(e_emit, R2_FLOOR)
    valid = (d2 > R2_FLOOR) & (rel > 0)
    g = _where(valid, E / ec)
    return g, dict(zr=zr, r=r, sqr=sqr, sqm=sqm, big_n=big_n, omega=omega,
                   d2=d2, r75=r75, sd2=sd2, big_q=big_q, ut=ut, lz=lz,
                   rel=rel, relc=relc, e_emit=e_emit, ec=ec, valid=valid)


def redshift_vjp(x, p, E, scal, z, gg):
    """(gx 3-tuple, gp 3-tuple, gE, g_mass, g_spin, g_orbit_dir) of
    ``redshift`` for the cotangent gg; nothing where g is 0 by
    ``valid``."""
    x0, x1 = x[0], x[1]
    a, sd, m = scal[SPIN], scal[ORBIT_DIR], scal[MASS]
    gg = _where(z["valid"], gg)
    ec, e_emit, ut, relc = z["ec"], z["e_emit"], z["ut"], z["relc"]
    gE = gg / ec
    g_ee = _where(e_emit >= R2_FLOOR, -gg * E / (ec * ec))
    g_ut = g_ee * relc
    g_rel = _where(z["rel"] >= R2_FLOOR, g_ee * ut)
    gE = gE + g_rel
    g_omega = -g_rel * z["lz"]
    g_lz = -g_rel * z["omega"]
    gx0, gx1 = g_lz * p[1], -g_lz * p[0]
    gp0, gp1 = -g_lz * x1, g_lz * x0
    big_n, big_q = z["big_n"], z["big_q"]
    g_n = g_ut / big_q
    g_q = -g_ut * big_n / (big_q * big_q)
    r, sqr, sqm, sd2 = z["r"], z["sqr"], z["sqm"], z["sd2"]
    g_r = g_q * sd2 * 0.75 * r ** -0.25
    g_d2 = _where(z["d2"] >= R2_FLOOR, g_q * z["r75"] / (2.0 * sd2))
    # omega = sd sqm / N
    g_num = g_omega / big_n
    g_n = g_n - g_num * (sd * sqm) / big_n
    g_sd = g_num * sqm
    g_sqm = g_num * sd
    # d2 = r sqr - 3 m sqr + 2 sd a sqm
    g_r = g_r + g_d2 * sqr
    g_sqr = g_d2 * (r - 3.0 * m)
    g_m = -3.0 * g_d2 * sqr
    g_sd = g_sd + g_d2 * 2.0 * a * sqm
    g_a = g_d2 * 2.0 * sd * sqm
    g_sqm = g_sqm + g_d2 * 2.0 * sd * a
    # N = r sqr + sd a sqm
    g_r = g_r + g_n * sqr
    g_sqr = g_sqr + g_n * r
    g_sd = g_sd + g_n * a * sqm
    g_a = g_a + g_n * sd * sqm
    g_sqm = g_sqm + g_n * sd * a
    # sqm = sqrt(max(m, floor)), sqr = sqrt(r), r = sqrt(max(zr, floor))
    g_m = g_m + _where(m >= NORM_FLOOR, g_sqm / (2.0 * sqm))
    g_r = g_r + g_sqr / (2.0 * sqr)
    g_zr = _where(z["zr"] >= R2_FLOOR, g_r / (2.0 * r))
    g_a = g_a - 2.0 * a * g_zr
    gx0 = gx0 + 2.0 * x0 * g_zr
    gx1 = gx1 + 2.0 * x1 * g_zr
    zero = torch.zeros_like(gx0)
    return (gx0, gx1, zero), (gp0, gp1, zero), gE, g_m, g_a, g_sd


def disk(x, p, E, ss: ShadeScene):
    """The disk's colour (3-tuple) at hit point x and its intermediates."""
    z = disk_coords(x, ss.scal)
    rgb, q = bilinear(ss.disk_tex, z["tx"], z["s"])
    out = tuple(c * z["inten"] for c in rgb)
    z.update(rgb=rgb, quad=q, base=out)
    if ss.disk == DISK_BEAMING:
        g, zr = redshift(x, p, E, ss.scal)
        big_g = g ** ss.scal[BEAMING]
        z.update(g=g, redshift=zr, big_g=big_g)
        out = tuple(c * big_g for c in out)
    return out, z


def disk_vjp(x, p, E, ss: ShadeScene, z, gc):
    """(gx, gp, gE, gscal (NSH-tuple), texture terms) of ``disk`` for the
    colour cotangent gc."""
    scal = ss.scal
    zero = torch.zeros_like(gc[0])
    gs = [zero] * NSH
    gx, gp, gE = [zero] * 3, [zero] * 3, zero
    if ss.disk == DISK_BEAMING:
        g, big_g, base, beam = z["g"], z["big_g"], z["base"], scal[BEAMING]
        g_big = _dot(gc, base)
        gc = tuple(c * big_g for c in gc)
        gg = _where(beam != 0, g_big * (beam * g ** (beam - 1.0)))
        gs[BEAMING] = _where((g != 0) | (beam < 0),
                             g_big * big_g * torch.log(g))
        rx, rp, rE, rm, ra, rsd = redshift_vjp(x, p, E, scal, z["redshift"],
                                               gg)
        gx, gp, gE = list(rx), list(rp), rE
        gs[MASS], gs[SPIN], gs[ORBIT_DIR] = rm, ra, rsd
    inten, rgb = z["inten"], z["rgb"]
    g_inten = _dot(gc, rgb)
    g_rgb = tuple(c * inten for c in gc)
    gauss, sq, sdv = z["gauss"], z["sq"], scal[STDDEV]
    gs[INTENSITY] = g_inten * gauss / sq
    g_gauss = g_inten * scal[INTENSITY] / sq
    g_sq = -g_inten * (scal[INTENSITY] * gauss) / (sq * sq)
    g_sd = g_sq * TWO_PI / (2.0 * sq)
    g_t = g_gauss * gauss
    e, den = z["e"], z["den"]
    g_e = g_t * (-2.0 * e) / den
    g_den = g_t * (e * e) / (den * den)
    gs[STDDEV] = g_sd + g_den * 4.0 * sdv
    du, dv, terms = bilinear_vjp(ss.disk_tex, z["quad"], g_rgb)
    g_s = g_e + dv
    gs[MEAN] = -g_e
    gs[PHASE] = du * INV_PI
    g_ac = du * INV_PI * z["sy"]
    c, cc, rc, rr = z["c"], z["cc"], z["rc"], z["rr"]
    inside = (c >= ACOS_LO) & (c <= ACOS_HI)
    g_c = _where(inside, -g_ac / torch.sqrt(1.0 - cc * cc))
    gx[0] = gx[0] + g_c / rc
    g_rr = _where(rr >= NORM_FLOOR, -g_c * x[0] / (rc * rc))
    span = z["span"]
    g_rr = g_rr + g_s / span
    gs[R_IN] = -g_s / span
    g_span = _where(z["width"] >= NORM_FLOOR,
                    -g_s * (rr - scal[R_IN]) / (span * span))
    gs[R_OUT] = g_span
    gs[R_IN] = gs[R_IN] - g_span
    gx[0] = gx[0] + g_rr * x[0] / rr
    gx[1] = gx[1] + g_rr * x[1] / rr
    return tuple(gx), tuple(gp), gE, gs, terms


# --- the spheres --------------------------------------------------------------

def sphere_index(obj, n_sph: int):
    return torch.clamp(obj, 0, n_sph - 1).long()


def occluded(x, ld, dist, ss: ShadeScene):
    """Whether a sphere or the horizon (radius 2M at the origin) blocks the
    segment x -> x + ld dist (shading._occluded)."""
    o = tuple(xc + lc * SHADOW_EPS for xc, lc in zip(x, ld))
    blocked = torch.zeros_like(dist, dtype=torch.bool)
    rows = [(ss.sph[k, :3], ss.sph[k, 3]) for k in range(ss.n_sph)]
    rows.append((ss.scal.new_zeros(3), 2.0 * ss.scal[MASS]))
    for centre, radius in rows:
        oc = tuple(oi - ci for oi, ci in zip(o, centre))
        b = _dot(oc, ld)
        c = _dot(oc, oc) - radius * radius
        disc = b * b - c
        sq = torch.sqrt(torch.where(disc > 0, disc, torch.ones_like(disc)))
        t0 = -b - sq
        blocked = blocked | ((disc > 0) & (t0 > SHADOW_EPS) & (t0 < dist))
    return blocked


def light_terms(x, nrm, ss: ShadeScene, j: int):
    """Light j's Lambert intermediates at x with unit normal nrm."""
    lv = tuple(ss.lights[j, c] - x[c] for c in range(3))
    d2 = _dot(lv, lv)
    dist = torch.sqrt(d2)
    dc = torch.clamp_min(dist, NORM_FLOOR)
    ld = tuple(c / dc for c in lv)
    ndl = _dot(nrm, ld)
    vis = torch.where(occluded(x, ld, dist, ss), 0.0, 1.0)
    ndlc = torch.clamp_min(ndl, 0.0)
    cj = ss.scal[LIGHT_I] * vis * ndlc / d2
    return dict(lv=lv, d2=d2, dist=dist, dc=dc, ld=ld, ndl=ndl, vis=vis,
                ndlc=ndlc, cj=cj)


def sphere(x, obj, ss: ShadeScene):
    """The sphere hit's colour (3-tuple) and its intermediates."""
    k = sphere_index(obj, ss.n_sph)
    row = ss.sph[k]
    nvec = tuple(x[c] - row[..., c] for c in range(3))
    nrm, nn, nc = unit(nvec)
    cz = torch.clamp(nrm[2], ACOS_LO, ACOS_HI)
    th = torch.arccos(cz)
    nx = nrm[0]
    den = torch.where(torch.abs(nx) > NORM_FLOOR, nx,
                      torch.full_like(nx, NORM_FLOOR))
    q = nrm[1] / den
    em, quad_ = bilinear(ss.sph_tex, torch.arctan(q) * INV_2PI,
                         th * INV_PI, k)
    zero = torch.zeros_like(x[0])
    lam = (zero, zero, zero)
    lights = []
    base = tuple(row[..., 5 + c] * ss.scal[LIGHT_I] for c in range(3))
    for j in range(ss.n_lights):
        t = light_terms(x, nrm, ss, j)
        lights.append(t)
        lam = tuple(lc + bc * t["cj"] for lc, bc in zip(lam, base))
    w = row[..., 4]
    out = tuple(w * e + (1.0 - w) * lc for e, lc in zip(em, lam))
    return out, dict(k=k, row=row, nvec=nvec, nrm=nrm, nn=nn, nc=nc, cz=cz,
                     den=den, q=q, em=em, quad=quad_, lam=lam, base=base,
                     lights=lights, w=w)


def light_vjp(x, nrm, ss: ShadeScene, t, base, g_lam):
    """Light j's Lambert transpose: (g_base, g_Li, g_nrm, g_lv), the
    cotangent of the light's position being g_lv and of x -g_lv."""
    g_base = tuple(g * t["cj"] for g in g_lam)
    g_cj = _dot(g_lam, base)
    li, vis, d2 = ss.scal[LIGHT_I], t["vis"], t["d2"]
    g_li = g_cj * vis * t["ndlc"] / d2
    g_ndlc = g_cj * li * vis / d2
    g_d2 = -g_cj * t["cj"] / d2
    g_ndl = _where(t["ndl"] >= 0, g_ndlc)
    g_nrm = tuple(g_ndl * c for c in t["ld"])
    g_ld = tuple(g_ndl * c for c in nrm)
    lv, dc, dist = t["lv"], t["dc"], t["dist"]
    g_dist = _where(dist >= NORM_FLOOR, -_dot(g_ld, lv) / (dc * dc))
    g_d2 = g_d2 + g_dist / (2.0 * dist)
    g_lv = tuple(g / dc + 2.0 * c * g_d2 for g, c in zip(g_ld, lv))
    return g_base, g_li, g_nrm, g_lv


def sphere_vjp(x, ss: ShadeScene, z, gc):
    """(gx, g_li, g_row (n, SPH_COLS), g_lights (n, L, 3), texture terms)
    of ``sphere`` for the colour cotangent gc; g_row is the cotangent of
    each ray's own row of the sphere table."""
    w, em, lam, nrm = z["w"], z["em"], z["lam"], z["nrm"]
    g_row = [torch.zeros_like(x[0])] * SPH_COLS
    g_row[4] = _dot(gc, em) - _dot(gc, lam)
    g_em = tuple(g * w for g in gc)
    g_lam = tuple(g * (1.0 - w) for g in gc)
    g_nrm = [torch.zeros_like(x[0])] * 3
    gx = [torch.zeros_like(x[0])] * 3
    g_li = torch.zeros_like(x[0])
    g_base = [torch.zeros_like(x[0])] * 3
    g_lights = []
    for t in z["lights"]:
        gb, gl, gn, g_lv = light_vjp(x, nrm, ss, t, z["base"], g_lam)
        g_base = [a + b for a, b in zip(g_base, gb)]
        g_li = g_li + gl
        g_nrm = [a + b for a, b in zip(g_nrm, gn)]
        gx = [a - b for a, b in zip(gx, g_lv)]
        g_lights.append(torch.stack(g_lv, dim=-1))
    row = z["row"]
    for c in range(3):
        g_row[5 + c] = g_base[c] * ss.scal[LIGHT_I]
    g_li = g_li + _dot(g_base, tuple(row[..., 5 + c] for c in range(3)))
    du, dv, terms = bilinear_vjp(ss.sph_tex, z["quad"], g_em, z["k"])
    g_ph = du * INV_2PI
    g_th = dv * INV_PI
    inside = (nrm[2] >= ACOS_LO) & (nrm[2] <= ACOS_HI)
    g_nrm[2] = g_nrm[2] + _where(
        inside, -g_th / torch.sqrt(1.0 - z["cz"] * z["cz"]))
    q, den = z["q"], z["den"]
    g_q = g_ph / (1.0 + q * q)
    g_nrm[1] = g_nrm[1] + g_q / den
    g_nrm[0] = g_nrm[0] + _where(torch.abs(nrm[0]) > NORM_FLOOR,
                                 -g_q * nrm[1] / (den * den))
    g_nvec = unit_vjp(z["nvec"], z["nn"], z["nc"], g_nrm)
    for c in range(3):
        gx[c] = gx[c] + g_nvec[c]
        g_row[c] = -g_nvec[c]
    g_lights = (torch.stack(g_lights, dim=-2) if g_lights
                else x[0].new_zeros(x[0].shape + (0, 3)))
    return tuple(gx), g_li, torch.stack(g_row, dim=-1), g_lights, terms


# --- the whole shading ----------------------------------------------------------

def branches(status, ss: ShadeScene):
    """The (sky, disk, sphere, black, error) masks of the rays' branches."""
    error = status == states.ERROR
    black = (status == states.CAPTURED) | (status == states.INSIDE_HORIZON)
    sph = (status == states.OBJECT) & (ss.n_sph > 0) & ~black & ~error
    dsk = (status == states.DISK) & (ss.disk != DISK_NONE) & ~black & ~error
    sky = ~(error | black | sph | dsk)
    return sky, dsk, sph, black, error


def _split(t):
    return t[..., 0], t[..., 1], t[..., 2]


def shade_forward(x, p, E, status, obj, ss: ShadeScene) -> torch.Tensor:
    """The (n, 3) colours: each ray shaded by its own branch."""
    x, p = _split(x), _split(p)
    sky, dsk, sph, _, error = branches(status, ss)
    zero = torch.zeros_like(E)
    out = (zero, zero, zero)
    if ss.sky is not None:
        d, _, _ = unit(velocity(x, p, E, ss.scal, ss.kerr))
        rgb, _ = bilinear(ss.sky, *equirect(d))
        out = tuple(_where(sky, c) for c in rgb)
    if ss.disk != DISK_NONE:
        rgb, _ = disk(x, p, E, ss)
        out = tuple(torch.where(dsk, c, o) for c, o in zip(rgb, out))
    if ss.n_sph:
        rgb, _ = sphere(x, obj, ss)
        out = tuple(torch.where(sph, c, o) for c, o in zip(rgb, out))
    out = (torch.where(error, 1.0, out[0]), _where(~error, out[1]),
           _where(~error, out[2]))
    return torch.stack(out, dim=-1)


def _scatter(out, terms, mask):
    for idx, t in terms:
        out.index_put_(idx, _where(mask[..., None], t), accumulate=True)


def shade_vjp(x, p, E, status, obj, ss: ShadeScene, g: torch.Tensor):
    """The VJP of ``shade_forward`` for the (n, 3) colour cotangent g:
    (gx (n, 3), gp (n, 3), gE (n,), gscal (NSH,), gsph (K, SPH_COLS),
    glights (L, 3), gsky, gdisk_tex, gsph_tex), the textures' None where
    the scene has none."""
    x, p = _split(x), _split(p)
    sky, dsk, sph, _, _ = branches(status, ss)
    gc = _split(g)
    zero = torch.zeros_like(E)
    gx, gp, gE = [zero] * 3, [zero] * 3, zero
    gscal = [zero] * NSH
    gsph = ss.sph.new_zeros((ss.n_sph, SPH_COLS))
    glights = ss.lights.new_zeros((ss.lights.shape[0], 3))
    gsky = gdisk = gsph_tex = None

    def add(mask, dx, dp, de):
        nonlocal gE
        for c in range(3):
            gx[c] = gx[c] + _where(mask, dx[c])
            gp[c] = gp[c] + _where(mask, dp[c])
        gE = gE + _where(mask, de)

    if ss.sky is not None:
        v = velocity(x, p, E, ss.scal, ss.kerr)
        d, nv, nc = unit(v)
        u, w = equirect(d)
        _, q = bilinear(ss.sky, u, w)
        gu, gw, terms = bilinear_vjp(ss.sky, q, gc)
        gd = equirect_vjp(d, gu, gw)
        gv = unit_vjp(v, nv, nc, gd)
        dx, dp, de, gm, ga = velocity_vjp(x, p, E, ss.scal, ss.kerr, gv)
        add(sky, dx, dp, de)
        gscal[MASS] = gscal[MASS] + _where(sky, gm)
        gscal[SPIN] = gscal[SPIN] + _where(sky, ga)
        gsky = torch.zeros_like(ss.sky)
        _scatter(gsky, terms, sky)
    if ss.disk != DISK_NONE:
        _, z = disk(x, p, E, ss)
        dx, dp, de, gs, terms = disk_vjp(x, p, E, ss, z, gc)
        add(dsk, dx, dp, de)
        gscal = [a + _where(dsk, b) for a, b in zip(gscal, gs)]
        gdisk = torch.zeros_like(ss.disk_tex)
        _scatter(gdisk, terms, dsk)
    if ss.n_sph:
        _, z = sphere(x, obj, ss)
        dx, g_li, g_row, g_lights, terms = sphere_vjp(x, ss, z, gc)
        add(sph, dx, (zero,) * 3, zero)
        gscal[LIGHT_I] = gscal[LIGHT_I] + _where(sph, g_li)
        gsph.index_put_((z["k"],), _where(sph[..., None], g_row),
                        accumulate=True)
        glights = glights + _where(sph[..., None, None], g_lights).sum(0)
        gsph_tex = torch.zeros_like(ss.sph_tex)
        _scatter(gsph_tex, terms, sph)
    return (torch.stack(gx, -1), torch.stack(gp, -1), gE,
            torch.stack([t.sum() for t in gscal]), gsph, glights, gsky,
            gdisk, gsph_tex)
