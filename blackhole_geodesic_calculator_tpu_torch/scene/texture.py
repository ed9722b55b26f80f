"""Texture sampling (PyTorch port of scene/texture.py, forward only).

A texture is a (H, W, C) float32 tensor; sampling is a batched bilinear
gather of the four corners.  Coordinates follow Blender's texture evaluate:
x, y in [-1, 1], x wraps (image textures repeat), y = -1 is the bottom row.
"""

from __future__ import annotations

import math

import torch

# arccos has an infinite derivative at +-1; rays aligned with the poles
# would otherwise poison gradients through the unselected branch.
_ACOS_EPS = 1e-6


def safe_arccos(x: torch.Tensor) -> torch.Tensor:
    return torch.arccos(torch.clamp(x, -1.0 + _ACOS_EPS, 1.0 - _ACOS_EPS))


def safe_arctan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 whose gradient is finite at (0, 0)."""
    deg = (torch.abs(x) < _ACOS_EPS) & (torch.abs(y) < _ACOS_EPS)
    return torch.atan2(torch.where(deg, torch.zeros_like(y), y),
                       torch.where(deg, torch.ones_like(x), x))


def sample_bpy(tex: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at bpy-style coords; tex (H, W, C), x/y (...,)."""
    h, w = tex.shape[0], tex.shape[1]
    # [-1, 1] -> continuous pixel coords; y flipped (row 0 is the top).
    fx = (x + 1.0) * 0.5 * w - 0.5
    fy = (1.0 - y) * 0.5 * h - 0.5
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    tx = fx - x0f
    ty = fy - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    # floor-mod, as jnp.mod: the seam wraps for negative columns too
    xi0 = torch.remainder(x0, w)
    xi1 = torch.remainder(x0 + 1, w)
    yi0 = torch.clamp(y0, 0, h - 1)
    yi1 = torch.clamp(y0 + 1, 0, h - 1)
    c00, c01 = tex[yi0, xi0], tex[yi0, xi1]
    c10, c11 = tex[yi1, xi0], tex[yi1, xi1]
    txe, tye = tx[..., None], ty[..., None]
    top = c00 * (1.0 - txe) + c01 * txe
    bot = c10 * (1.0 - txe) + c11 * txe
    return top * (1.0 - tye) + bot * tye


def sample_equirect(tex: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Equirectangular environment lookup from a unit direction:

        theta = 1 - arccos(d_z)/pi
        phi   = atan2(d_y, d_x)/pi
        color = tex.evaluate((-phi, 2*theta - 1))
    """
    theta = 1.0 - safe_arccos(direction[..., 2]) / math.pi
    phi = safe_arctan2(direction[..., 1], direction[..., 0]) / math.pi
    return sample_bpy(tex, -phi, 2.0 * theta - 1.0)
