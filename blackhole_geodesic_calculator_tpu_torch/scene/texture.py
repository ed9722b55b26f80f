"""Differentiable texture sampling (PyTorch port of scene/texture.py).

A texture is a (H, W, C) float32 tensor; sampling is a batched bilinear
gather of the four corners.  Coordinates follow Blender's texture evaluate:
x, y in [-1, 1], x wraps (image textures repeat), y = -1 is the bottom row.
"""

from __future__ import annotations

import math

import torch

from ..ops import cuda_kernel
from ..utils.profiling import annotate

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


class _SampleBpy(torch.autograd.Function):
    """Bilinear sample with the hand-written backward of the JAX package's
    ``sample_bpy`` custom VJP (scene/texture.py:144-206): the corner colours
    are kept from the forward, so the backward gathers nothing.  On a CUDA
    device the backward is one launch of ``ops/csrc/tex_bwd.cu``
    (cuda_kernel.tex_bwd): the coordinate cotangents, the derivatives of
    the bilinear weights, per ray, and, when the texture needs a gradient,
    its cotangent as a fixed-point sum in int64 of the rays' weighted
    cotangents, which is the same bit for bit from run to run (its
    rounding: the kernel's source note).  On the CPU it is
    ``sample_bpy_bwd_plain``.  The backward runs in the profiler span
    ``bhgc.texture.backward``."""

    @staticmethod
    def forward(ctx, tex, x, y):
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
        ctx.save_for_backward(c00, c01, c10, c11, tx, ty, xi0, xi1, yi0,
                              yi1)
        ctx.tex_shape = tex.shape
        return top * (1.0 - tye) + bot * tye

    @staticmethod
    def backward(ctx, g):
        with annotate("bhgc.texture.backward"):
            bwd = cuda_kernel.tex_bwd if g.is_cuda else sample_bpy_bwd_plain
            return bwd(*ctx.saved_tensors, g, ctx.tex_shape,
                       ctx.needs_input_grad[0])


def sample_bpy_bwd_plain(c00, c01, c10, c11, tx, ty, xi0, xi1, yi0, yi1, g,
                         tex_shape, dtex: bool):
    """Plain PyTorch version of ``cuda_kernel.tex_bwd``: (dtex, dx, dy)
    from the forward's saved tensors and the cotangent ``g``; dtex (None
    unless ``dtex``) is four accumulating scatters of the corner weights
    into (H, W, C).  The contributions of the rays that hit one texel add
    in another order than in the JAX package (float32 rounding differs by a
    few ulp)."""
    h, w, c = tex_shape
    txe, tye = tx[..., None], ty[..., None]
    out = None
    if dtex:
        out = g.new_zeros((h, w, c))
        for yi, xi, wgt in ((yi0, xi0, (1.0 - txe) * (1.0 - tye)),
                            (yi0, xi1, txe * (1.0 - tye)),
                            (yi1, xi0, (1.0 - txe) * tye),
                            (yi1, xi1, txe * tye)):
            out.index_put_((yi, xi), g * wgt, accumulate=True)
    # dx, dy: exactly the derivatives of the bilinear weights
    dfx = torch.sum(g * ((c01 - c00) * (1.0 - tye)
                         + (c11 - c10) * tye), dim=-1)
    dfy = torch.sum(g * ((c10 - c00) * (1.0 - txe)
                         + (c11 - c01) * txe), dim=-1)
    return out, dfx * (0.5 * w), dfy * (-0.5 * h)


def sample_bpy(tex: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at bpy-style coords; tex (H, W, C), x/y (...,)."""
    return _SampleBpy.apply(tex, x, y)


def equirect_uv(direction: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """bpy coords of a unit direction in an equirect texture:

        theta = 1 - arccos(d_z)/pi
        phi   = atan2(d_y, d_x)/pi
        uv    = (-phi, 2*theta - 1)
    """
    theta = 1.0 - safe_arccos(direction[..., 2]) / math.pi
    phi = safe_arctan2(direction[..., 1], direction[..., 0]) / math.pi
    return -phi, 2.0 * theta - 1.0


def sample_equirect(tex: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Equirectangular environment lookup from a unit direction."""
    return sample_bpy(tex, *equirect_uv(direction))


def sphere_uv_bpy(normal: torch.Tensor,
                  compat_arctan: bool = True) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Spherical UV of a unit normal, the reference's emission-shader
    convention:

        th = arccos(n_z); ph = arctan(n_y / n_x)   [arctan, not atan2]
        coords = (ph / (2 pi), th / pi)

    ``compat_arctan=False`` takes atan2 instead (a seamless 360-degree
    wrap)."""
    th = safe_arccos(normal[..., 2])
    if compat_arctan:
        nx = normal[..., 0]
        ph = torch.arctan(normal[..., 1] / torch.where(
            torch.abs(nx) > 1e-20, nx, torch.full_like(nx, 1e-20)))
    else:
        ph = torch.atan2(normal[..., 1], normal[..., 0])
    return ph / (2.0 * math.pi), th / math.pi
