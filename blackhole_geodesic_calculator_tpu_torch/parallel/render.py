"""Sharded rendering over the ranks of a mesh (PyTorch port of
parallel/render.py).

* the crop window's pixels are dealt round-robin over the mesh's ray
  coordinates, padded so every rank gets as many slots (a padding slot
  re-traces pixel 0): a ray's cost varies wildly (a shadow ray captures in
  a few steps, a photon-ring grazer runs every step), and contiguous row
  blocks would make the rank holding the photon ring the straggler;
* every rank renders its slots and its share of the samples through the
  renderer's ``render_samples``, all of them in one ``render_rays`` call
  (the CUDA kernels on the card);
* the ranks of a sample group average their samples' means with an
  ``all_reduce``, and the ranks of a ray group ``all_gather`` their slots, whose deal is
  undone by layout (``_undeal_cm``).

The jitter draws are ``sample_draws``'s, the same on every rank, and each
rank reads its slots' and its samples' share of them, so a sharded frame
equals ``render_image``'s on the same draws, bit for bit on one rank.  The
JAX module's bypass of a 1 x 1 mesh is not ported: one rank runs the same
deal and assembly.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..camera.pinhole import Camera
from ..render.renderer import (RenderConfig, _frame, image_draws,
                               polarization_rays, render_samples, stokes_rays)
from ..scene.scene import Scene
from .mesh import SAMPLE_AXIS, Mesh, make_mesh


@functools.lru_cache(maxsize=64)
def _flat_pixels(cfg: RenderConfig, n_shards: int):
    """The crop window's pixels dealt round-robin over ``n_shards`` and
    padded to a multiple of it: (ys, xs, perm, n) on the CPU, ``perm[i]``
    the flat crop pixel that slot i serves (slot s * per + j serves pixel
    j * n_shards + s; a padding slot serves pixel 0), n the crop's pixels.
    Cached: the tensors are shared, never written."""
    x0, x1, y0, y1 = cfg.crop()
    wc = x1 - x0
    n = (y1 - y0) * wc
    total = n + (-n) % n_shards
    slot = torch.arange(total)
    per = total // n_shards
    perm = (slot % per) * n_shards + slot // per
    perm = torch.where(perm < n, perm, 0)
    return y0 + perm // wc, x0 + perm % wc, perm, n


def _undeal_cm(flat_cm: torch.Tensor, n_shards: int, n: int) -> torch.Tensor:
    """(C, total) slot-ordered channels -> (C, n) pixel-ordered: pixel
    order is the (per, n_shards) transpose of the (n_shards, per) slot
    view, and the padding slots land at positions >= n."""
    if n_shards == 1:
        return flat_cm[..., :n]
    C, total = flat_cm.shape
    per = total // n_shards
    t = flat_cm.reshape(C, n_shards, per)
    return torch.transpose(t, 1, 2).reshape(C, total)[:, :n]


def local_slots(cfg: RenderConfig, mesh: Mesh, device):
    """This rank's ray slots: (ys, xs) on ``device``, cached per (cfg,
    ray coordinate, device) as the JAX module caches its device-resident
    pixels: copying a 1024^2 frame's coordinates to the card took longer
    than its render.  The tensors are shared, never written."""
    _, r = mesh.coords()
    return _slots_on(cfg, mesh.rays, r, torch.device(device))


@functools.lru_cache(maxsize=16)
def _slots_on(cfg: RenderConfig, n_shards: int, r: int, device):
    ys, xs, _, _ = _flat_pixels(cfg, n_shards)
    per = ys.numel() // n_shards
    sl = slice(r * per, (r + 1) * per)
    return ys[sl].to(device), xs[sl].to(device)


def local_samples(cfg: RenderConfig, mesh: Mesh) -> range:
    """The samples this rank renders: its share of ``cfg.samples``."""
    if cfg.samples % mesh.samples != 0:
        raise ValueError(
            f"samples={cfg.samples} must be a multiple of the mesh "
            f"'{SAMPLE_AXIS}' extent {mesh.samples}")
    s, _ = mesh.coords()
    k = cfg.samples // mesh.samples
    return range(s * k, (s + 1) * k)


def slot_jitter(cfg: RenderConfig, draws: torch.Tensor | None, ys, xs,
                samples: range):
    """The draws (samples, 2, Hc, Wc) of the samples ``samples`` at the
    slots (ys, xs): (len(samples), 2, slots); None (the pixel centres) for
    no draws."""
    if draws is None:
        return None
    x0, _, y0, _ = cfg.crop()
    return draws[:, :, ys - y0, xs - x0][samples.start:samples.stop]


def _gather_slots(mesh: Mesh, local: torch.Tensor, n: int) -> torch.Tensor:
    """The ray group's (slots, C) tensors -> the (C, n) pixel-ordered
    crop."""
    if mesh.rays > 1:
        parts = [torch.empty_like(local) for _ in range(mesh.rays)]
        dist.all_gather(parts, local.contiguous(), group=mesh.ray_group)
        local = torch.cat(parts)
    return _undeal_cm(local.T, mesh.rays, n)


def render_image_sharded(scene: Scene, cam: Camera, cfg: RenderConfig,
                         mesh: Mesh | None = None,
                         draws: torch.Tensor | None = None) -> torch.Tensor:
    """The full (H, W, 4) RGBA frame rendered over ``mesh`` (default: every
    rank), white outside the crop window, on every rank.

    One sample renders the pixel centres; ``cfg.samples`` > 1 renders this
    rank's samples, jittered by ``sample_draws(cfg, device, draws)`` at its
    slots, in one launch (``render_samples``), and averages those means
    over the sample group.  Equal to ``render_image`` on the same draws,
    bit for bit on one rank: both render through ``render_samples``."""
    mesh = mesh or make_mesh()
    device = cam.position.device
    mine = local_samples(cfg, mesh)
    ys, xs = local_slots(cfg, mesh, device)
    rgb = render_samples(scene, cam, cfg, ys, xs, slot_jitter(
        cfg, image_draws(cfg, device, draws), ys, xs, mine))
    if mesh.samples > 1:
        dist.all_reduce(rgb, group=mesh.sample_group)
        rgb = rgb / mesh.samples
    x0, x1, y0, y1 = cfg.crop()
    hc, wc = y1 - y0, x1 - x0
    img = _gather_slots(mesh, rgb, hc * wc).reshape(3, hc, wc)
    return _frame(cfg, img.permute(1, 2, 0))


def render_stokes_sharded(scene: Scene, cam: Camera, cfg: RenderConfig,
                          mesh: Mesh | None = None):
    """The polarized frame over ``mesh``: (rgb (Hc, Wc, 3), Q (Hc, Wc),
    U (Hc, Wc)) over the crop window, on every rank, equal to
    ``render_stokes``'s (pixel centres, no jitter)."""
    mesh = mesh or make_mesh()
    ys, xs = local_slots(cfg, mesh, cam.position.device)
    rgb, q, u = stokes_rays(scene, cam, cfg, ys, xs)
    x0, x1, y0, y1 = cfg.crop()
    hc, wc = y1 - y0, x1 - x0
    cm = _gather_slots(mesh, torch.cat([rgb, q[:, None], u[:, None]], -1),
                       hc * wc).reshape(5, hc, wc)
    return cm[:3].permute(1, 2, 0), cm[3], cm[4]


def polarization_map_sharded(scene: Scene, cam: Camera, cfg: RenderConfig,
                             mesh: Mesh | None = None) -> torch.Tensor:
    """The polarization rotation map over ``mesh``, (Hc, Wc) with NaN
    where the ray did not escape, on every rank, equal to
    ``polarization_map``'s: the way to spread a large Kerr map, whose
    transport ODE costs far more a ray than the render path."""
    mesh = mesh or make_mesh()
    ys, xs = local_slots(cfg, mesh, cam.position.device)
    ang = polarization_rays(scene, cam, cfg, ys, xs)
    x0, x1, y0, y1 = cfg.crop()
    return _gather_slots(mesh, ang[:, None], (y1 - y0) * (x1 - x0)).reshape(
        y1 - y0, x1 - x0)
