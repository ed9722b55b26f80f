"""Pinhole camera (PyTorch port of camera/pinhole.py).

The reference ray model:

    aspect   = H / W
    x_render = fov_x * (x - W//2) / W
    y_render = fov_y * (y - H//2) / H * aspect
    dir      = normalize(euler_rotate((x_render, y_render, -1)))

The camera looks down -z in its local frame and is oriented by XYZ Euler
angles like Blender's (R = Rz @ Ry @ Rx).  This slice renders pixel centres
only; the jittered multisample path is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..scene.scene import on_device


def _f(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=on_device(device))


@dataclasses.dataclass
class Camera:
    """Camera parameters (position, XYZ euler, fov pair) as float32 tensors."""

    position: Any   # (3,)
    euler: Any      # (3,) radians, Blender XYZ order
    fov: Any        # (2,) = (fov_x, fov_y)

    @classmethod
    def make(cls, position, euler=(0.0, 0.0, 0.0), fov=(1.0, 1.0),
             device=None):
        return cls(position=_f(position, device), euler=_f(euler, device),
                   fov=_f(fov, device))


def euler_matrix(euler: torch.Tensor) -> torch.Tensor:
    """Blender 'XYZ' Euler to rotation matrix: R = Rz(c) @ Ry(b) @ Rx(a)."""
    a, b, c = euler[0], euler[1], euler[2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    one, zero = torch.ones_like(a), torch.zeros_like(a)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    rx = mat([[one, zero, zero], [zero, ca, -sa], [zero, sa, ca]])
    ry = mat([[cb, zero, sb], [zero, one, zero], [-sb, zero, cb]])
    rz = mat([[cc, -sc, zero], [sc, cc, zero], [zero, zero, one]])
    return _matmul3(_matmul3(rz, ry), rx)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b written as products and sums, so no TF32 setting can touch it."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def pixel_grid(width: int, height: int,
               x_min: int = 0, x_max: int | None = None,
               y_min: int = 0, y_max: int | None = None, device=None):
    """Integer pixel coordinates of the (cropped) render window.

    Returns (ys, xs), each of shape (Hc, Wc)."""
    x_max = width if x_max is None else x_max
    y_max = height if y_max is None else y_max
    ys = torch.arange(y_min, y_max, device=device)
    xs = torch.arange(x_min, x_max, device=device)
    return torch.meshgrid(ys, xs, indexing="ij")


def generate_rays(cam: Camera, width: int, height: int, ys: torch.Tensor,
                  xs: torch.Tensor, key=None):
    """Ray origins (broadcast) and unit directions for pixel centres (ys, xs)."""
    if key is not None:
        raise NotImplementedError(
            "jittered sampling is not ported yet; it comes with the "
            "multisample render path")
    aspect = height / width
    x_render = cam.fov[0] * (xs - width // 2) / width
    y_render = cam.fov[1] * (ys - height // 2) / height * aspect
    d_cam = torch.stack(
        [x_render, y_render, -torch.ones_like(x_render)], dim=-1)
    rot = euler_matrix(cam.euler)
    # d = d_cam @ rot.T, as explicit products and sums
    d = torch.sum(d_cam[..., None, :] * rot, dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = cam.position.expand(d.shape)
    return o, d
