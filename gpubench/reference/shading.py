"""Plain shading and texture lookups: the frozen reference.

A copy of the port's scene/shading.py and scene/texture.py as they stood
when the benchmark was written, cut to what the configurations use: the
equirect sky, the Gaussian-profile textured disk and emissive textured
spheres (no lights).  The bilinear lookup is plain indexing, so autograd
derives its backward; the port's hand-written one must agree with it.
"""

from __future__ import annotations

import math

import torch

from .integrate import CAPTURED, DISK, ERROR, INSIDE_HORIZON, OBJECT

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


def sphere_uv(normal):
    th = safe_arccos(normal[..., 2])
    nx = normal[..., 0]
    ph = torch.arctan(normal[..., 1] / torch.where(
        torch.abs(nx) > 1e-20, nx, torch.full_like(nx, 1e-20)))
    return ph / (2.0 * math.pi), th / math.pi


def shade_disk(disk, x):
    """The disk's colour at the hit points x: texture at (tex_x, s) times
    the Gaussian radial profile."""
    r_in, r_out = disk["r_in"], disk["r_out"]
    rr = torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])
    s = (rr - r_in) / torch.clamp_min(r_out - r_in, 1e-20)
    sign_y = torch.where(x[..., 1] >= 0, 1.0, -1.0)
    tex_x = (disk["phase"] + safe_arccos(x[..., 0] / torch.clamp_min(
        rr, 1e-20)) * sign_y) / math.pi
    sd = disk["stddev"]
    gauss = torch.exp(-((s - disk["mean"]) ** 2) / (2.0 * sd ** 2))
    intensity = disk["intensity"] * gauss / torch.sqrt(2.0 * math.pi * sd)
    return sample_bpy(disk["texture"], tex_x, s) * intensity[..., None]


def shade_spheres(spheres, x, hit_obj):
    """Each sphere's emission texture at the spherical UV of the hit's
    object-local normal (every sphere emissive, no lights)."""
    centers = spheres["center"]
    obj = torch.clamp(hit_obj, 0, centers.shape[0] - 1).long()
    n = x - centers[obj]
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-20)
    ph, th = sphere_uv(n)
    rgb = torch.zeros_like(n)
    for j in range(spheres["texture"].shape[0]):
        rgb = torch.where((obj == j)[..., None],
                          sample_bpy(spheres["texture"][j], ph, th), rgb)
    return rgb


def shade(scene, s, end_dir):
    """Per-ray RGB from the end state: sky, disk, sphere, black for a
    captured ray, red for a non-finite one."""
    d = end_dir / torch.clamp_min(
        torch.linalg.norm(end_dir, dim=-1, keepdim=True), 1e-20)
    color = sample_equirect(scene["background"], d)
    st = s.status
    if scene.get("disk") is not None:
        color = torch.where((st == DISK)[..., None],
                            shade_disk(scene["disk"], s.x), color)
    if scene.get("spheres") is not None:
        color = torch.where((st == OBJECT)[..., None],
                            shade_spheres(scene["spheres"], s.x, s.hit_obj),
                            color)
    black = (st == CAPTURED) | (st == INSIDE_HORIZON)
    color = torch.where(black[..., None], color.new_tensor((0.0, 0.0, 0.0)),
                        color)
    return torch.where((st == ERROR)[..., None],
                       color.new_tensor((1.0, 0.0, 0.0)), color)
