"""Render observability (PyTorch port of render/stats.py): a per-status
ray histogram, affine-length statistics and a settings dump, as data."""

from __future__ import annotations

import torch

from ..camera.pinhole import Camera, pixel_grid
from ..ops import states
from ..scene.scene import Scene
from .renderer import RenderConfig, trace_rays

STATUS_NAMES = {
    states.ACTIVE: "active",
    states.CAPTURED: "captured",
    states.ESCAPED: "escaped",
    states.BUDGET: "budget",
    states.DISK: "disk",
    states.OBJECT: "object",
    states.INSIDE_HORIZON: "inside_horizon",
    states.ERROR: "error",
}


def render_stats(scene: Scene, cam: Camera, cfg: RenderConfig) -> dict:
    """Trace the frame's rays (pixel centres) and return the termination
    report: ``rays_total``, per-status counts, ``rogue_fraction`` (ERROR +
    BUDGET rays), ``lam_mean``/``lam_max`` and the ``settings`` dump.  The
    counts and the affine statistics cross to the host in one copy."""
    x0, x1, y0, y1 = cfg.crop()
    device = cam.position.device
    ys, xs = pixel_grid(cfg.width, cfg.height, x0, x1, y0, y1, device=device)
    with torch.no_grad():
        s = trace_rays(scene, cam, cfg, ys, xs).s
        codes = sorted(STATUS_NAMES)
        counts = torch.bincount(s.status.reshape(-1).long(),
                                minlength=len(codes))[codes]
        host = torch.cat([counts.double(), s.lam.mean().double()[None],
                          s.lam.max().double()[None]]).cpu().tolist()
    by_name = {STATUS_NAMES[code]: int(c)
               for code, c in zip(codes, host[:len(codes)])}
    total = sum(by_name.values())
    rogue = by_name["error"] + by_name["budget"]
    return {
        "rays_total": total,
        "status": by_name,
        "rogue_fraction": rogue / max(total, 1),
        "lam_mean": host[-2],
        "lam_max": host[-1],
        "settings": settings_dump(scene, cam, cfg),
    }


def settings_dump(scene: Scene, cam: Camera, cfg: RenderConfig) -> dict:
    """The render-start settings, as a dict."""
    return {
        "mass": float(scene.bh.mass),
        "spin": None if scene.bh.spin is None else float(scene.bh.spin),
        "bh_loc": scene.bh.loc.tolist(),
        "camera": cam.position.tolist(),
        "euler": cam.euler.tolist(),
        "fov": cam.fov.tolist(),
        "resolution": [cfg.width, cfg.height],
        "samples": cfg.samples,
        "seed": cfg.seed,
        "n_steps": cfg.integrator.n_steps,
        "dt": cfg.integrator.dt,
        "backend": cfg.integrator.backend,
        "lam_max": cfg.lam_max,
        "disk": scene.disk is not None,
        "spheres": 0 if scene.spheres is None
        else int(scene.spheres.center.shape[0]),
        "lights": 0 if scene.lights is None
        else int(scene.lights.position.shape[0]),
    }
