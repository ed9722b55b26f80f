"""The renderer: render(scene, cam) -> image (PyTorch port of
render/renderer.py).

Camera ray generation, the batched geodesic integration and shading run
in turn on the tensors' device; on a CUDA device the integration is the
hand-written kernels of ops/cuda_kernel.py.  The image is differentiable
with respect to the mass, the camera position, the sky and disk textures,
the sphere geometry and every shading parameter: every step is a tensor
operation autograd records, the integrator through its checkpointed
adjoint and the texture lookups through their hand-written backward.
"""

from __future__ import annotations

import dataclasses

import torch

from ..camera.pinhole import Camera, generate_rays, pixel_grid
from ..ops.integrate import (
    DiskGeom,
    GeodesicEnv,
    IntegratorConfig,
    SphereGeom,
    final_direction,
    launch,
)
from ..scene.scene import Scene
from ..scene.shading import shade


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings.

    * samples        -> samples per pixel (only 1 is ported)
    * seed           -> sampling seed of the multisample path
    * lam_max        -> affine budget
    * r_escape       -> 0 means 2x camera distance + 20 r_s
    * marks          -> debug crop window; -1 = off
    """

    width: int = 256
    height: int = 256
    samples: int = 1
    seed: int = 42
    integrator: IntegratorConfig = dataclasses.field(
        default_factory=IntegratorConfig
    )
    lam_max: float = 50.0
    r_escape: float = 0.0
    capture_factor: float = 1.0  # capture at r <= factor * r_s
    mark_x_min: int = -1
    mark_x_max: int = -1
    mark_y_min: int = -1
    mark_y_max: int = -1

    def crop(self):
        x0 = 0 if self.mark_x_min < 0 else self.mark_x_min
        x1 = self.width if self.mark_x_max < 0 else min(
            self.mark_x_max + 1, self.width)
        y0 = 0 if self.mark_y_min < 0 else self.mark_y_min
        y1 = self.height if self.mark_y_max < 0 else min(
            self.mark_y_max + 1, self.height)
        return x0, x1, y0, y1


def scene_env(scene: Scene, cfg: RenderConfig, cam: Camera) -> GeodesicEnv:
    """Build the integrator environment in BH-centred coordinates: the
    sphere centres are shifted by the hole's location, the disk lies in the
    hole's z = 0 plane.  r_escape, the mass and the sphere geometry stay
    tensors on the scene's device, in the autograd graph."""
    if scene.bh.spin is not None:
        raise NotImplementedError(
            "Kerr scenes (spin) are not ported yet")
    device = scene.bh.mass.device
    rs = 2.0 * scene.bh.mass
    if cfg.r_escape > 0:
        r_escape = torch.tensor(cfg.r_escape, dtype=torch.float32,
                                device=device)
    else:
        cam_r = torch.linalg.norm(cam.position - scene.bh.loc)
        r_escape = 2.0 * cam_r + 20.0 * rs
    disk = None
    if scene.disk is not None:
        disk = DiskGeom(r_in=scene.disk.r_in, r_out=scene.disk.r_out)
    spheres = None
    if scene.spheres is not None:
        spheres = SphereGeom(
            center=scene.spheres.center - scene.bh.loc,
            radius=scene.spheres.radius,
        )
    return GeodesicEnv(
        mass=scene.bh.mass,
        spin=scene.bh.spin,
        r_capture=cfg.capture_factor * rs,
        r_escape=r_escape,
        lam_max=torch.tensor(cfg.lam_max, dtype=torch.float32,
                             device=device),
        disk=disk,
        spheres=spheres,
    )


def _bh_frame(scene: Scene) -> Scene:
    """Shift world-frame positions into BH-centred coordinates."""
    spheres = scene.spheres
    if spheres is not None:
        spheres = dataclasses.replace(
            spheres, center=spheres.center - scene.bh.loc)
    lights = scene.lights
    if lights is not None:
        lights = dataclasses.replace(
            lights, position=lights.position - scene.bh.loc)
    return dataclasses.replace(scene, spheres=spheres, lights=lights)


def render_rays(scene: Scene, cam: Camera, cfg: RenderConfig,
                ys: torch.Tensor, xs: torch.Tensor, key=None) -> torch.Tensor:
    """Shade the rays through pixels (ys, xs) of any shape; returns
    ys.shape + (3,)."""
    origin, d = generate_rays(cam, cfg.width, cfg.height, ys, xs, key)

    env = scene_env(scene, cfg, cam)
    scene_bh = _bh_frame(scene)
    o_rel = origin - scene.bh.loc

    s = launch(env, o_rel, d, cfg.integrator)
    end_dir = final_direction(env, s)
    return shade(scene_bh, s, end_dir)


def render_sample(scene: Scene, cam: Camera, cfg: RenderConfig,
                  key=None) -> torch.Tensor:
    """One sample of the (cropped) image; returns (Hc, Wc, 3)."""
    x0, x1, y0, y1 = cfg.crop()
    ys, xs = pixel_grid(cfg.width, cfg.height, x0, x1, y0, y1,
                        device=cam.position.device)
    return render_rays(scene, cam, cfg, ys, xs, key)


def render_image(scene: Scene, cam: Camera, cfg: RenderConfig,
                 key=None) -> torch.Tensor:
    """Full render -> (H, W, 4) RGBA; pixels outside the crop window are
    white with alpha 1.  One sample renders the pixel centres, so ``key``
    (the multisample jitter seed) is not used."""
    if cfg.samples != 1:
        raise NotImplementedError(
            "samples > 1 is not ported yet; it comes with the multisample "
            "render path")
    rgb = render_sample(scene, cam, cfg, None)
    x0, x1, y0, y1 = cfg.crop()
    full = torch.ones((cfg.height, cfg.width, 4), dtype=rgb.dtype,
                      device=rgb.device)
    full[y0:y1, x0:x1, :3] = rgb
    return full
