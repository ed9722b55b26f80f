"""Plain shading of the Kerr cells: the frozen reference.

A copy of ``reference/shading.py`` cut to what the Kerr configurations
use (the equirect sky and the Gaussian-profile textured disk) and
extended by the disk's redshift and beaming, as the port's
scene/shading.py stood when the Kerr cell was written.  The bilinear
lookup is plain indexing, so autograd derives its backward.

The disk's matter moves on prograde Keplerian circular orbits of the Kerr
equator (Bardeen, Press & Teukolsky 1972), and its colour is multiplied
by g^beaming, g = E_inf / E_emitted.  Departures from the published
equations, all the port's: the Boyer-Lindquist radius of a hit is
sqrt(x^2 + y^2 - a^2) at the Kerr-Schild z = 0, floored at 1e-6; the
orbits are taken down to the circular photon orbit, not cut at the
innermost stable one, and g is 0 inside it, and where E - Omega L_z <=
0, which only a ray that stepped through the horizon's interior reaches;
E - Omega L_z and the emitted energy are floored at 1e-12; a ray that did not end on the disk
enters the redshift with E = 0 (g = 0), since its g^beaming, which the
shading then discards, can overflow to inf and make the discarded branch's
gradient NaN.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .integrate import CAPTURED, DISK, ERROR, INSIDE_HORIZON

_ACOS_EPS = 1e-6


def safe_arccos(x):
    return torch.arccos(torch.clamp(x, -1.0 + _ACOS_EPS, 1.0 - _ACOS_EPS))


def safe_arctan2(y, x):
    deg = (torch.abs(x) < _ACOS_EPS) & (torch.abs(y) < _ACOS_EPS)
    return torch.atan2(torch.where(deg, torch.zeros_like(y), y),
                       torch.where(deg, torch.ones_like(x), x))


def sample_bpy(tex, x, y):
    """Bilinear sample of tex (H, W, C) at Blender-style coordinates x, y
    in [-1, 1]: x wraps, y = -1 is the bottom row."""
    h, w = tex.shape[0], tex.shape[1]
    fx = (x + 1.0) * 0.5 * w - 0.5
    fy = (1.0 - y) * 0.5 * h - 0.5
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0f)[..., None], (fy - y0f)[..., None]
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    xi0, xi1 = torch.remainder(x0, w), torch.remainder(x0 + 1, w)
    yi0, yi1 = torch.clamp(y0, 0, h - 1), torch.clamp(y0 + 1, 0, h - 1)
    top = tex[yi0, xi0] * (1.0 - tx) + tex[yi0, xi1] * tx
    bot = tex[yi1, xi0] * (1.0 - tx) + tex[yi1, xi1] * tx
    return top * (1.0 - ty) + bot * ty


def sample_equirect(tex, d):
    theta = 1.0 - safe_arccos(d[..., 2]) / math.pi
    phi = safe_arctan2(d[..., 1], d[..., 0]) / math.pi
    return sample_bpy(tex, -phi, 2.0 * theta - 1.0)


def redshift(x, p, E, mass, a):
    """g = E / (u^t (E - Omega L_z)) of photons (p, E) crossing the disk at
    x, for prograde Keplerian orbits:

        Omega = sqrt(M) / (r^(3/2) + a sqrt(M)),
        u^t   = (r^(3/2) + a sqrt(M))
                / (r^(3/4) sqrt(r^(3/2) - 3M sqrt(r) + 2a sqrt(M))),
        L_z   = x p_y - y p_x;

    0 where the orbit does not exist or E - Omega L_z <= 0 (no matter on
    it emits such a photon)."""
    r = torch.sqrt(torch.clamp_min(x[..., 0] ** 2 + x[..., 1] ** 2 - a * a,
                                   1e-12))
    sqr = torch.sqrt(r)
    sqm = torch.sqrt(torch.clamp_min(mass, 1e-20))
    omega = sqm / (r * sqr + a * sqm)
    denom2 = r * sqr - 3.0 * mass * sqr + 2.0 * a * sqm
    ut = (r * sqr + a * sqm) / (
        r ** 0.75 * torch.sqrt(torch.clamp_min(denom2, 1e-12)))
    lz = x[..., 0] * p[..., 1] - x[..., 1] * p[..., 0]
    rel = E - omega * lz
    e_emit = ut * torch.clamp_min(rel, 1e-12)
    g = E / torch.clamp_min(e_emit, 1e-12)
    return torch.where((denom2 > 1e-12) & (rel > 0), g, 0.0)


def shade_disk(disk, s, mass, a):
    """The disk's colour at the hit points: texture at (tex_x, s) times
    the Gaussian radial profile, times g^beaming when the disk beams."""
    x = s.x
    r_in, r_out = disk["r_in"], disk["r_out"]
    rr = torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])
    u = (rr - r_in) / torch.clamp_min(r_out - r_in, 1e-20)
    sign_y = torch.where(x[..., 1] >= 0, 1.0, -1.0)
    tex_x = (disk["phase"] + safe_arccos(x[..., 0] / torch.clamp_min(
        rr, 1e-20)) * sign_y) / math.pi
    sd = disk["stddev"]
    gauss = torch.exp(-((u - disk["mean"]) ** 2) / (2.0 * sd ** 2))
    intensity = disk["intensity"] * gauss / torch.sqrt(2.0 * math.pi * sd)
    rgb = sample_bpy(disk["texture"], tex_x, u) * intensity[..., None]
    if disk.get("beaming") is not None:
        g = redshift(x, s.p, s.E, mass, a)
        rgb = rgb * (g ** disk["beaming"])[..., None]
    return rgb


def shade(scene, s, end_dir):
    """Per-ray RGB from the end state: sky, disk, black for a captured
    ray, red for a non-finite one."""
    d = end_dir / torch.clamp_min(
        torch.linalg.norm(end_dir, dim=-1, keepdim=True), 1e-20)
    color = sample_equirect(scene["background"], d)
    st = s.status
    if scene.get("disk") is not None:
        on = st == DISK
        if scene["disk"].get("beaming") is not None:
            # a ray that ended off the disk enters the redshift with E = 0
            s = dataclasses.replace(s, E=torch.where(on, s.E, 0.0))
        color = torch.where(on[..., None],
                            shade_disk(scene["disk"], s, scene["mass"],
                                       scene["spin"]), color)
    black = (st == CAPTURED) | (st == INSIDE_HORIZON)
    color = torch.where(black[..., None], color.new_tensor((0.0, 0.0, 0.0)),
                        color)
    return torch.where((st == ERROR)[..., None],
                       color.new_tensor((1.0, 0.0, 0.0)), color)
