"""Gen-1 "Limited" renderer: curved spacetime only inside a sphere of
influence around the hole, flat-space ray casting outside (PyTorch port of
render/limited.py).

A camera ray is cast in flat space against the scene's spheres and the
influence sphere; a ray that enters the influence sphere is integrated
from its entry point (``integrate``: the CUDA kernel rk4_fwd on the card,
the plain loop on the CPU) with escape at the sphere's edge, or traced
through a surrogate (a ``SurrogateTable``, or for a spinning hole a
learned ``models.surrogate.NeuralSurrogate``); its exit ray is cast in
flat space again; then everything is shaded:

  * a disk crossing inside the sphere -> the disk's colour (no sky);
  * horizon capture -> black;
  * budget exhausted or a non-finite state inside the sphere -> a RED
    debug pixel (black without debug colours);
  * an exit ray that re-enters the influence sphere -> BLUE if it heads
    to z < 0, else GREEN (debug colours);
  * a sphere hit before or after the hole -> its emission or Lambert
    shading with shadow rays;
  * a miss -> the sky, or the ``test_output`` direction gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..camera.pinhole import Camera, generate_rays, pixel_grid
from ..models.kerr import horizon_radius
from ..ops import states
from ..ops.geodesic import null_init
from ..ops.integrate import (
    DiskGeom,
    GeodesicEnv,
    IntegratorConfig,
    final_direction,
    integrate,
)
from ..scene.scene import Scene, on_device
from ..scene.shading import shade_background, shade_disk, shade_sphere
from .renderer import RenderConfig, _frame, sample_draws

RED = (1.0, 0.0, 0.0)
BLUE = (0.0, 0.0, 1.0)
GREEN = (0.0, 1.0, 0.0)
BLACK = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class LimitedConfig:
    """The Gen-1 renderer's settings."""

    r_influence: float = 20.0      # the influence sphere's radius
    exit_tolerance: float = 0.1    # escape at r_influence (1 + this)
    test_output: bool = False      # the direction-gradient background
    debug_colors: bool = True      # RED / BLUE / GREEN rogue rays
    approx: bool = False           # a surrogate instead of the ODE


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(v, dim=-1, keepdim=True)


@dataclasses.dataclass
class SurrogateTable:
    """The scattering table of the ``approx`` path: by spherical symmetry
    the exit state of a photon entering the influence sphere depends only
    on its impact parameter b, so a 1-D table built once with the real
    integrator replaces each ray's integration with a lookup, a linear
    interpolation and a rotation into the ray's frame.  Schwarzschild only;
    it keeps no trajectory, so the disk is not tested on this path."""

    b: Any          # (n,) impact parameters, ascending
    end_loc: Any    # (n, 3) exit positions in the canonical frame
    end_dir: Any    # (n, 3) exit directions in the canonical frame
    captured: Any   # (n,) bool

    @classmethod
    def build(cls, mass=0.5, r_influence=20.0, exit_tolerance=0.1, n=512,
              max_step=0.05, lam_max=200.0, device=None):
        """Integrate n photons entering at (-sqrt(R^2 - b^2), b, 0) in +x,
        b in [0, 0.999 R], with ceil(lam_max / max_step) fixed steps of
        max_step and no step growth, on ``device`` (the card unless told
        otherwise): the CUDA kernel rk4_fwd there, the plain loop on the
        CPU.  A ray is captured when it ends CAPTURED, INSIDE_HORIZON or on
        the budget."""
        device = on_device(device)
        R = r_influence
        f32 = dict(dtype=torch.float32, device=device)
        bs = torch.linspace(0.0, R * 0.999, n, **f32)
        x0 = torch.stack([-torch.sqrt(torch.clamp_min(R * R - bs * bs, 0.0)),
                          bs, torch.zeros_like(bs)], dim=-1)
        d0 = torch.tensor([1.0, 0.0, 0.0], **f32).expand(n, 3)
        mass = torch.as_tensor(mass, **f32)
        env = GeodesicEnv(
            mass=mass, r_capture=2.0 * mass,
            r_escape=torch.tensor(R * (1.0 + exit_tolerance), **f32),
            lam_max=torch.tensor(lam_max, **f32))
        cfg = IntegratorConfig(n_steps=int(math.ceil(lam_max / max_step)),
                               dt=max_step, dt_boost=1.0)
        entry_in = x0 * (1.0 - 1e-4)
        p0, E0 = null_init(entry_in, d0, env.mass, None)
        s = integrate(env, states.init_state(entry_in, p0, E0), cfg)
        captured = ((s.status == states.CAPTURED)
                    | (s.status == states.INSIDE_HORIZON)
                    | (s.status == states.BUDGET))
        return cls(b=bs, end_loc=s.x, end_dir=final_direction(env, s),
                   captured=captured)

    def trace(self, entry: torch.Tensor, d: torch.Tensor):
        """(exit_loc, exit_dir, captured) of rays entering at ``entry``
        (BH-centred) with directions ``d``."""
        dn = d / torch.clamp_min(_norm(d), 1e-20)
        bvec = entry - torch.sum(entry * dn, dim=-1, keepdim=True) * dn
        b = torch.linalg.norm(bvec, dim=-1)
        e1 = dn
        safe = (b > 1e-6)[..., None]
        ref = torch.where(torch.abs(dn[..., 0:1]) < 0.9,
                          dn.new_tensor([1.0, 0.0, 0.0]),
                          dn.new_tensor([0.0, 1.0, 0.0]))
        fallback = torch.linalg.cross(dn, ref, dim=-1)
        fallback = fallback / torch.clamp_min(_norm(fallback), 1e-20)
        e2 = torch.where(safe, bvec / torch.clamp_min(b[..., None], 1e-20),
                         fallback)
        e3 = torch.linalg.cross(e1, e2, dim=-1)

        idx = torch.clamp(torch.searchsorted(self.b, b.contiguous()), 1,
                          self.b.shape[0] - 1)
        t = (b - self.b[idx - 1]) / torch.clamp_min(
            self.b[idx] - self.b[idx - 1], 1e-20)
        t = torch.clamp(t, 0.0, 1.0)[..., None]
        el = self.end_loc[idx - 1] * (1 - t) + self.end_loc[idx] * t
        ed = self.end_dir[idx - 1] * (1 - t) + self.end_dir[idx] * t
        cap = self.captured[idx - 1] | self.captured[idx]

        def to_world(c):
            return c[..., 0:1] * e1 + c[..., 1:2] * e2 + c[..., 2:3] * e3

        exit_dir = to_world(ed)
        exit_dir = exit_dir / torch.clamp_min(_norm(exit_dir), 1e-20)
        return to_world(el), exit_dir, cap


def _ray_spheres(o, d, centers, radii, t_min=1e-5):
    """The nearest forward ray-sphere hit: (t or inf, sphere index or -1);
    a ray may start inside a sphere; ties go to the first index."""
    oc = o[..., None, :] - centers            # (..., K, 3)
    b = torch.sum(oc * d[..., None, :], dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radii * radii
    disc = b * b - c
    sq = torch.sqrt(torch.where(disc > 0, disc, torch.ones_like(disc)))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > t_min, t0, t1)
    valid = (disc > 0) & (t > t_min)
    t = torch.where(valid, t, torch.inf)
    tb, k = torch.min(t, dim=-1)
    return tb, torch.where(torch.isfinite(tb), k, -1).to(torch.int32)


def _flat_cast(scene: Scene, lcfg: LimitedConfig, o, d):
    """The first hit among the scene's spheres and the influence sphere:
    (t, obj, hit_bh_sphere), obj -1 for none and for the influence
    sphere."""
    t_bh, _ = _ray_spheres(o, d, scene.bh.loc[None, :],
                           o.new_tensor([lcfg.r_influence]))
    if scene.spheres is not None:
        t_ob, obj = _ray_spheres(o, d, scene.spheres.center,
                                 scene.spheres.radius)
    else:
        t_ob = torch.full_like(t_bh, torch.inf)
        obj = torch.full(t_bh.shape, -1, dtype=torch.int32,
                         device=t_bh.device)
    bh_first = t_bh < t_ob
    t = torch.where(bh_first, t_bh, t_ob)
    obj = torch.where(bh_first, -1, obj).to(torch.int32)
    return t, obj, bh_first & torch.isfinite(t_bh)


def _surface_state(x, obj):
    """A RayState of flat-space sphere hits at ``x`` for shade_sphere."""
    batch = obj.shape
    return states.RayState(
        x=x, p=torch.zeros_like(x),
        E=torch.ones(batch, dtype=x.dtype, device=x.device),
        lam=torch.zeros(batch, dtype=x.dtype, device=x.device),
        status=torch.full(batch, states.OBJECT, dtype=torch.int32,
                          device=x.device),
        hit_obj=obj)


def _background(scene, lcfg, d):
    """The sky, or the test_output direction gradient: (0, dz, dy) for
    dz <= 0, else (0, 0, dz)."""
    if not lcfg.test_output:
        return shade_background(scene, d)
    dz, dy = d[..., 2], d[..., 1]
    zero = torch.zeros_like(dz)
    neg = torch.stack([zero, dz, dy], dim=-1)
    pos = torch.stack([zero, zero, dz], dim=-1)
    return torch.where((dz <= 0)[..., None], neg, pos)


def geodesic_state(scene: Scene, cfg: RenderConfig, lcfg: LimitedConfig,
                   entry_in: torch.Tensor, d: torch.Tensor,
                   enters_bh: torch.Tensor):
    """(env, s0): the integrator's environment and the initial state of the
    rays entering the influence sphere at ``entry_in`` (BH-centred) in
    directions ``d``.  Escape is at r_influence (1 + exit_tolerance),
    capture at 2M or, for a Kerr hole, at the outer horizon r_+ (which
    prograde photon orbits pass inside 2M of).  The rays that do not enter
    start ESCAPED and those inside the capture radius INSIDE_HORIZON, so
    the integrator leaves both as they are."""
    disk = None
    if scene.disk is not None:
        disk = DiskGeom(r_in=scene.disk.r_in, r_out=scene.disk.r_out)
    r_cap = (2.0 * scene.bh.mass if scene.bh.spin is None
             else horizon_radius(scene.bh.mass, scene.bh.spin))
    f32 = dict(dtype=torch.float32, device=entry_in.device)
    env = GeodesicEnv(
        mass=scene.bh.mass, spin=scene.bh.spin, r_capture=r_cap,
        r_escape=torch.tensor(
            lcfg.r_influence * (1.0 + lcfg.exit_tolerance), **f32),
        lam_max=torch.tensor(cfg.lam_max, **f32), disk=disk)
    p0, E0 = null_init(entry_in, d, env.mass, env.spin)
    s0 = states.init_state(entry_in, p0, E0)
    s0.status = torch.where(enters_bh, s0.status, states.ESCAPED).to(
        torch.int32)
    inside = env.radius(entry_in) <= env.r_capture
    s0.status = torch.where(inside, states.INSIDE_HORIZON, s0.status).to(
        torch.int32)
    return env, s0


def render_limited_rays(scene: Scene, cam: Camera, cfg: RenderConfig,
                        lcfg: LimitedConfig, ys, xs,
                        jitter: torch.Tensor | None = None,
                        table=None) -> torch.Tensor:
    """The Gen-1 colour of the rays through pixels (ys, xs), jittered by
    ``jitter`` or through the pixel centres: ys.shape + (3,)."""
    o, d = generate_rays(cam, cfg.width, cfg.height, ys, xs, jitter)
    loc = scene.bh.loc

    # stage 1: the flat-space cast from the camera
    t1, obj1, enters_bh = _flat_cast(scene, lcfg, o, d)
    hit1 = torch.isfinite(t1)
    x1 = o + d * torch.where(hit1, t1, 0.0)[..., None]

    # stage 2: through the influence sphere, from just inside its edge
    entry_in = (x1 - loc) * (1.0 - 1e-4)
    disk_x = None
    if lcfg.approx:
        exit_rel, end_dir, cap_t = table.trace(entry_in, d)
        exit_loc = exit_rel + loc
        captured = cap_t & enters_bh
        outside_err = torch.zeros_like(captured)
        exited = enters_bh & ~cap_t
    else:
        env, s0 = geodesic_state(scene, cfg, lcfg, entry_in, d, enters_bh)
        s = integrate(env, s0, cfg.integrator)
        end_dir = final_direction(env, s)
        exit_loc = s.x + loc
        # stage 3: the geodesic's outcome
        captured = ((s.status == states.CAPTURED)
                    | (s.status == states.INSIDE_HORIZON))
        outside_err = (s.status == states.BUDGET) | (s.status == states.ERROR)
        disk_hit = s.status == states.DISK
        exited = s.status == states.ESCAPED
        disk_x = s.x

    # stage 4: the flat-space cast from the exit point
    t2, obj2, re_bh = _flat_cast(scene, lcfg, exit_loc, end_dir)
    hit2 = torch.isfinite(t2) & (obj2 >= 0)
    x2 = exit_loc + end_dir * torch.where(hit2, t2, 0.0)[..., None]

    # shading: a ray that misses the influence sphere sees the sky or a
    # sphere along the camera ray
    color = _background(scene, lcfg, d)
    if scene.spheres is not None:
        scene_bh = dataclasses.replace(
            scene, spheres=dataclasses.replace(
                scene.spheres, center=scene.spheres.center - loc))
        direct = shade_sphere(scene_bh, _surface_state(x1 - loc, obj1))
        color = torch.where((hit1 & (obj1 >= 0))[..., None], direct, color)

    # a ray through the influence sphere sees what its exit ray meets
    bh_color = _background(scene, lcfg, end_dir)
    if scene.spheres is not None:
        after = shade_sphere(scene_bh, _surface_state(x2 - loc, obj2))
        bh_color = torch.where(hit2[..., None], after, bh_color)
    if lcfg.debug_colors:
        rehit = re_bh & exited
        down = (end_dir[..., 2] < 0)[..., None]
        bh_color = torch.where((rehit[..., None] & down),
                               bh_color.new_tensor(BLUE), bh_color)
        bh_color = torch.where((rehit[..., None] & ~down),
                               bh_color.new_tensor(GREEN), bh_color)
    if scene.disk is not None and disk_x is not None:
        bh_color = torch.where(disk_hit[..., None], shade_disk(scene, disk_x),
                               bh_color)
    bh_color = torch.where(captured[..., None], bh_color.new_tensor(BLACK),
                           bh_color)
    err_color = RED if lcfg.debug_colors else BLACK
    bh_color = torch.where(outside_err[..., None],
                           bh_color.new_tensor(err_color), bh_color)
    return torch.where(enters_bh[..., None], bh_color, color)


def render_limited(scene: Scene, cam: Camera, cfg: RenderConfig,
                   lcfg: LimitedConfig | None = None,
                   draws: torch.Tensor | None = None,
                   table=None) -> torch.Tensor:
    """The Gen-1 frame -> (H, W, 4) RGBA, white outside the crop window.
    ``cfg.samples`` > 1 averages jittered samples as ``render_image`` does
    (``sample_draws``).  With ``lcfg.approx`` a surrogate replaces the
    integration: ``table`` -- anything with ``.trace(entry, d)``, a
    ``SurrogateTable`` or a trained ``models.surrogate.NeuralSurrogate``,
    on the rays' device -- or a ``SurrogateTable`` built for the scene's
    hole on its device, for Schwarzschild only: the 1-D table is exact only
    under spherical symmetry, so a spinning hole needs a learned
    surrogate."""
    if lcfg is None:
        lcfg = LimitedConfig()
    if lcfg.approx and table is None:
        if scene.bh.spin is not None:
            raise ValueError(
                "approx mode for a spinning hole needs a learned surrogate "
                "(the 1D table is exact only under spherical symmetry): "
                "train one with models.surrogate.train_surrogate and pass "
                "it as `table=`")
        table = SurrogateTable.build(
            mass=float(scene.bh.mass), r_influence=lcfg.r_influence,
            exit_tolerance=lcfg.exit_tolerance, device=scene.bh.mass.device)
    device = cam.position.device
    x0, x1, y0, y1 = cfg.crop()
    ys, xs = pixel_grid(cfg.width, cfg.height, x0, x1, y0, y1, device=device)
    if cfg.samples == 1:
        rgb = render_limited_rays(scene, cam, cfg, lcfg, ys, xs, None, table)
    else:
        draws = sample_draws(cfg, device, draws)
        rgb = torch.stack([
            render_limited_rays(scene, cam, cfg, lcfg, ys, xs, draws[i],
                                table)
            for i in range(cfg.samples)]).mean(dim=0)
    return _frame(cfg, rgb)
