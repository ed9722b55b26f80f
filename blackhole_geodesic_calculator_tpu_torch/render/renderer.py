"""The renderer: render(scene, cam) -> image (PyTorch port of
render/renderer.py).

Camera ray generation, the batched geodesic integration and shading run
in turn on the tensors' device; on a CUDA device the integration is the
hand-written kernels of ops/cuda_kernel.py.  The image is differentiable
with respect to the mass, the camera position, the sky and disk textures,
the sphere geometry and every shading parameter: every step is a tensor
operation autograd records, the integrator through its checkpointed
adjoint and the texture lookups through their hand-written backward.

A multisampled image renders its samples one at a time, one integrator
launch each, and averages them (the JAX package's sample scan,
renderer.py:159-173); the samples' jitter draws come from a generator on
the tensors' device seeded with ``RenderConfig.seed``, or from the caller
(``sample_draws``).  ``render_image_u8`` tonemaps and quantizes on the
device; ``render_progressive`` yields the image sample by sample or, with
one sample, row band by row band.  ``render_stokes`` adds the Stokes Q
and U of a polarized disk, and ``polarization_map`` maps the rotation of
the polarization basis along each ray (the parallel-transport ODE for a
Kerr hole).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Iterator

import torch

from ..camera.pinhole import Camera, euler_matrix, generate_rays, pixel_grid
from ..models.kerr import horizon_radius, kerr_ks_metric
from ..ops import states
from ..ops.integrate import (
    DiskGeom,
    GeodesicEnv,
    IntegratorConfig,
    SphereGeom,
    final_direction,
    launch,
)
from ..ops.polarization import (_cross, _unit, plane_normal,
                                polarization_rotation,
                                transport_polarization_ode)
from ..scene.scene import Scene
from ..scene.shading import shade, shade_rays
from ..utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings.

    * samples        -> samples per pixel
    * seed           -> seed of the samples' jitter draws (sample_draws)
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
    capture_factor: float = 1.0  # capture at r <= factor * r_horizon
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
    hole's z = 0 plane.  Capture is at ``capture_factor`` times the outer
    horizon: r_s = 2M, or r_+ = M + sqrt(M^2 - a^2) for a Kerr hole (JAX
    renderer.py:97-106), since capturing at 2M would swallow photons that
    orbit inside it around a spinning hole.  r_escape, the mass, the spin
    and the sphere geometry stay tensors on the scene's device, in the
    autograd graph."""
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
    r_horizon = (rs if scene.bh.spin is None
                 else horizon_radius(scene.bh.mass, scene.bh.spin))
    return GeodesicEnv(
        mass=scene.bh.mass,
        spin=scene.bh.spin,
        r_capture=cfg.capture_factor * r_horizon,
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


def sample_draws(cfg: RenderConfig, device,
                 draws: torch.Tensor | None = None) -> torch.Tensor:
    """The (samples, 2, Hc, Wc) float32 jitter draws of a multisampled
    render: uniform in [0, 1), one (u, v) per sample and pixel of the crop
    window, drawn on ``device`` by a ``torch.Generator`` there seeded with
    ``cfg.seed`` -- one seed gives one image, run after run -- or
    ``draws`` as the caller gives them (the tests pass in the JAX
    package's ``jax.random`` draws), checked for shape and device.  Draws
    on another device are refused, never moved."""
    x0, x1, y0, y1 = cfg.crop()
    shape = (cfg.samples, 2, y1 - y0, x1 - x0)
    device = torch.device(device)
    if draws is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(cfg.seed)
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=device)
    if tuple(draws.shape) != shape or draws.dtype != torch.float32:
        raise ValueError(f"draws must be float32 of shape {shape}; got "
                         f"{draws.dtype} {tuple(draws.shape)}")
    if draws.device.type != device.type or (
            device.index is not None and draws.device != device):
        raise ValueError(f"draws are on {draws.device}, the camera on "
                         f"{device}")
    return draws


def render_rays(scene: Scene, cam: Camera, cfg: RenderConfig,
                ys: torch.Tensor, xs: torch.Tensor,
                jitter: torch.Tensor | None = None) -> torch.Tensor:
    """Shade the rays through pixels (ys, xs) of any shape, jittered by
    ``jitter`` (generate_rays) or through the pixel centres; returns
    ys.shape + (3,).  The camera, the integrator and the shading each run
    in a profiler span (``bhgc.render.*``); on a CUDA device the final
    direction and the shading are one kernel launch (``shade_rays``)."""
    with annotate("bhgc.render.rays"):
        origin, d = generate_rays(cam, cfg.width, cfg.height, ys, xs,
                                  jitter)
        env = scene_env(scene, cfg, cam)
        scene_bh = _bh_frame(scene)
        o_rel = origin - scene.bh.loc

    with annotate("bhgc.render.integrate"):
        s = launch(env, o_rel, d, cfg.integrator)
    with annotate("bhgc.render.shade"):
        return shade_rays(env, scene_bh, s)


def render_sample(scene: Scene, cam: Camera, cfg: RenderConfig,
                  jitter: torch.Tensor | None = None) -> torch.Tensor:
    """One sample of the (cropped) image, jittered by ``jitter`` (2, Hc,
    Wc) or through the pixel centres; returns (Hc, Wc, 3)."""
    x0, x1, y0, y1 = cfg.crop()
    ys, xs = pixel_grid(cfg.width, cfg.height, x0, x1, y0, y1,
                        device=cam.position.device)
    return render_rays(scene, cam, cfg, ys, xs, jitter)


def _frame(cfg: RenderConfig, rgb: torch.Tensor) -> torch.Tensor:
    """The (H, W, 4) frame: ``rgb`` in the crop window, white with alpha 1
    elsewhere."""
    x0, x1, y0, y1 = cfg.crop()
    full = torch.ones((cfg.height, cfg.width, 4), dtype=rgb.dtype,
                      device=rgb.device)
    full[y0:y1, x0:x1, :3] = rgb
    return full


def render_image(scene: Scene, cam: Camera, cfg: RenderConfig,
                 draws: torch.Tensor | None = None) -> torch.Tensor:
    """Full render -> (H, W, 4) RGBA; pixels outside the crop window are
    white with alpha 1.  One sample renders the pixel centres and reads no
    draws; ``cfg.samples`` > 1 renders each sample jittered by its draws
    (sample_draws), one integrator launch each, and averages them as the
    JAX scan does: stacked, then the mean over the sample axis.  Autograd
    runs through every sample."""
    if cfg.samples == 1:
        return _frame(cfg, render_sample(scene, cam, cfg))
    draws = sample_draws(cfg, cam.position.device, draws)
    rgbs = [render_sample(scene, cam, cfg, draws[i])
            for i in range(cfg.samples)]
    return _frame(cfg, torch.stack(rgbs).mean(dim=0))


def render_image_u8(scene: Scene, cam: Camera, cfg: RenderConfig,
                    draws: torch.Tensor | None = None, tonemap: bool = False,
                    exposure: float = 1.0) -> torch.Tensor:
    """``render_image`` with the tonemap (Reinhard, times ``exposure``) and
    the uint8 quantization clip(img * 255 + 0.5, 0, 255) done on the
    image's device (JAX renderer.py:278-309): returns the (H, W, 4) uint8
    frame there, so only it crosses to the host, a quarter of the float
    frame's bytes.  Equal to quantizing the float render on the host as
    io_.write_png does.  No gradient is recorded."""
    with torch.no_grad():
        img = render_image(scene, cam, cfg, draws)
        rgb = img[..., :3]
        if tonemap:
            rgb = rgb * exposure
            rgb = rgb / (1.0 + rgb)
        img = torch.cat([rgb, img[..., 3:]], dim=-1)
        return torch.clamp(img * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def render_progressive(scene: Scene, cam: Camera, cfg: RenderConfig,
                       draws: torch.Tensor | None = None,
                       row_bands: int = 16
                       ) -> Iterator[tuple[int, torch.Tensor]]:
    """Generator of (update index, partial (H, W, 4) RGBA), a new tensor
    each time (JAX renderer.py:312-370).

    * samples > 1: one yield per sample, with the running average of the
      samples so far; the draws are render_image's, so the last frame is
      render_image's image.
    * samples == 1: one yield per row band, at most ``row_bands`` bands of
      equal height; the last band is shifted up to end on the crop edge,
      so every traced row is a crop row.  A band's pixels equal the whole
      frame's: each ray is traced on its own.
    """
    x0, x1, y0, y1 = cfg.crop()
    device = cam.position.device

    if cfg.samples == 1:
        n_rows = y1 - y0
        band = max(1, -(-n_rows // max(1, min(row_bands, n_rows))))
        full = torch.ones((cfg.height, cfg.width, 4), dtype=torch.float32,
                          device=device)
        i, yb = 0, y0
        while yb < y1:
            take = min(band, y1 - yb)
            yr = min(yb, y1 - band)
            ys, xs = pixel_grid(cfg.width, cfg.height, x0, x1, yr, yr + band,
                                device=device)
            rgb = render_rays(scene, cam, cfg, ys, xs)
            full = full.clone()
            full[yb:yb + take, x0:x1, :3] = rgb[yb - yr:yb - yr + take]
            yield i, full
            i += 1
            yb += take
        return

    draws = sample_draws(cfg, device, draws)
    acc = None
    for i in range(cfg.samples):
        rgb = render_sample(scene, cam, cfg, draws[i])
        acc = rgb if acc is None else acc + rgb
        yield i, _frame(cfg, acc / (i + 1))


def stokes_rays(scene: Scene, cam: Camera, cfg: RenderConfig,
                ys: torch.Tensor, xs: torch.Tensor):
    """Polarized render of the rays through pixels (ys, xs): (rgb, Q, U),
    rgb of shape ys.shape + (3,), the Stokes Q and U of shape ys.shape
    (JAX renderer.py:198-265).

    Disk light is emitted with degree q sin^2(theta_em) (q = the disk's
    ``pol_frac``, theta_em the angle between the photon and the disk
    normal) and its E-vector along the disk normal's projection transverse
    to the photon; it reaches the camera by the exact Schwarzschild
    transport (ops/polarization.py), also used for a Kerr hole as its
    a -> 0 approximation.  chi = atan2(f.up, f.right) against the camera's
    image axes (the columns of ``euler_matrix``), Q = Ip cos 2chi, U = Ip
    sin 2chi with Ip = degree x the pixel's luminance.  The sky, the
    spheres and a disk without ``pol_frac`` are unpolarized: Q = U = 0."""
    origin, d = generate_rays(cam, cfg.width, cfg.height, ys, xs)
    env = scene_env(scene, cfg, cam)
    o_rel = origin - scene.bh.loc

    s = launch(env, o_rel, d, cfg.integrator)
    end_dir = final_direction(env, s)
    rgb = shade(_bh_frame(scene), s, end_dir)

    zero = torch.zeros(rgb.shape[:-1], dtype=rgb.dtype, device=rgb.device)
    if scene.disk is None or scene.disk.pol_frac is None:
        return rgb, zero, zero

    is_disk = s.status == states.DISK
    # the photon's direction at the crossing: a ray freezes at the event
    # point, so the final unit coordinate velocity is the disk-local one
    k_d = end_dir
    # emitted E-vector: the disk normal's projection transverse to the
    # photon; |f_raw| = sin(theta_em), which sets the degree too
    f_raw = k_d.new_tensor([0.0, 0.0, 1.0]) - k_d * k_d[..., 2:3]
    sin2 = torch.sum(f_raw * f_raw, dim=-1)
    p_eff = scene.disk.pol_frac * sin2
    f_hat = f_raw / torch.clamp_min(torch.sqrt(sin2), 1e-12)[..., None]

    # the components in the (n, e(k)) frame are invariants of the transport
    n = plane_normal(o_rel, d)
    e_d = _unit(_cross(k_d, n))
    alpha = torch.sum(f_hat * n, dim=-1)
    beta = torch.sum(f_hat * e_d, dim=-1)
    e_c = _unit(_cross(d, n))
    f_obs = alpha[..., None] * n + beta[..., None] * e_c

    rot = euler_matrix(cam.euler)
    chi = torch.atan2(torch.sum(f_obs * rot[:, 1], dim=-1),
                      torch.sum(f_obs * rot[:, 0], dim=-1))
    lum = torch.mean(rgb, dim=-1)
    ip = torch.where(is_disk, p_eff * lum, 0.0)
    return rgb, ip * torch.cos(2.0 * chi), ip * torch.sin(2.0 * chi)


def render_stokes(scene: Scene, cam: Camera, cfg: RenderConfig):
    """The polarized frame over the crop window at the pixel centres:
    (rgb (Hc, Wc, 3), Q (Hc, Wc), U (Hc, Wc)); see ``stokes_rays``."""
    x0, x1, y0, y1 = cfg.crop()
    ys, xs = pixel_grid(cfg.width, cfg.height, x0, x1, y0, y1,
                        device=cam.position.device)
    return stokes_rays(scene, cam, cfg, ys, xs)


def polarization_rays(scene: Scene, cam: Camera, cfg: RenderConfig,
                      ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The polarization rotation (radians) of the rays through pixels
    (ys, xs); returns ys.shape (JAX renderer.py:373-424).

    Schwarzschild: the closed form on the integrator's escape directions
    (``launch``), kept for ESCAPED and BUDGET rays, NaN for the others.
    Kerr: the parallel-transport ODE of ``kerr_ks_metric`` from the camera
    with the in-plane launch basis, the angle of the transported vector in
    the escape frame's (e_in, n) basis, NaN for rays that end inside 0.99
    of the stop radius."""
    origin, d = generate_rays(cam, cfg.width, cfg.height, ys, xs)
    env = scene_env(scene, cfg, cam)
    o_rel = origin - scene.bh.loc

    if scene.bh.spin is None:
        s = launch(env, o_rel, d, cfg.integrator)
        d1 = final_direction(env, s)
        ang = polarization_rotation(o_rel, d, d1)
        escaped = (s.status == states.ESCAPED) | (s.status == states.BUDGET)
        return torch.where(escaped, ang, torch.nan)

    metric = kerr_ks_metric(scene.bh.mass, scene.bh.spin)
    x3 = o_rel.reshape(-1, 3)
    d3 = d.reshape(-1, 3)
    n = plane_normal(x3, d3)
    f0 = _unit(_cross(d3, n))             # the in-plane basis at launch
    it = cfg.integrator
    r_stop = float(cfg.r_escape) if cfg.r_escape > 0 else 70.0
    f_obs, d1, x1, _ = transport_polarization_ode(
        metric, x3, d3, f0, n_steps=it.n_steps, dt=it.dt, r_stop=r_stop,
        dt_boost=max(it.dt_boost, 1.0), r_ref=it.dt_boost_r_ref or 1.6)
    e_in1 = _unit(_cross(d1, n))
    ang = torch.atan2(torch.sum(f_obs * n, dim=-1),
                      torch.sum(f_obs * e_in1, dim=-1))
    escaped = torch.linalg.norm(x1, dim=-1) >= 0.99 * r_stop
    return torch.where(escaped, ang, torch.nan).reshape(ys.shape)


# Above this many Kerr pixels, polarization_map warns: the transport ODE
# costs far more a ray than the render path.
_KERR_POLARIZATION_WARN_PIXELS = 256 * 256


def polarization_map(scene: Scene, cam: Camera, cfg: RenderConfig
                     ) -> torch.Tensor:
    """The per-pixel polarization rotation (radians) over the crop window,
    (Hc, Wc): the closed form for Schwarzschild, the transport ODE (frame
    dragging included) for Kerr; NaN where the ray did not escape.  Warns
    above 256^2 Kerr pixels (``parallel.polarization_map_sharded`` spreads
    a map over ranks)."""
    x0, x1, y0, y1 = cfg.crop()
    n_pix = (x1 - x0) * (y1 - y0)
    if scene.bh.spin is not None and n_pix > _KERR_POLARIZATION_WARN_PIXELS:
        warnings.warn(
            f"Kerr polarization map over {n_pix} pixels on one device: the "
            "parallel-transport ODE is ~40x the render path's flops. Use a "
            "mark_* crop window, or spread the map over several ranks with "
            "parallel.polarization_map_sharded.", stacklevel=2)
    ys, xs = pixel_grid(cfg.width, cfg.height, x0, x1, y0, y1,
                        device=cam.position.device)
    return polarization_rays(scene, cam, cfg, ys, xs)
