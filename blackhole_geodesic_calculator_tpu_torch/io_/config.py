"""Scene/render configuration -- the reference's PROPS system, standalone
(PyTorch port of io_/config.py).

The reference keeps its config in ``bpy.props`` scene properties
(RelativisticRenderEngine.py:504-517, LimitedRelativisticRenderEngine.py:
486-506).  Here the same namespace is a JSON-serializable dataclass, field
for field the JAX package's -- same names, order and defaults -- so one
JSON file configures either package.  Sentinel convention preserved: -1 =
off (marks, max steps).  ``build_scene`` and ``build_limited`` build this
package's objects on the card unless the caller names another device.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..camera.pinhole import Camera
from ..convert import _BACKENDS
from ..ops.integrate import IntegratorConfig
from ..render.renderer import RenderConfig
from ..scene.scene import BlackHole, Disk, Lights, Scene, Spheres, on_device
from .image import read_image


@dataclasses.dataclass
class SceneConfig:
    """Mirrors the reference PROPS namespace (defaults from
    RelativisticRenderEngine.py:504-517 / LimitedRelativisticRenderEngine.py
    :486-506) + scene content the reference keeps in Blender objects."""

    # -- reference scene properties ---------------------------------------
    mass: float = 0.5                    # 'mass' default 0.5 (:506)
    max_integration_step: float = 0.1    # 'max_integration_step' (:507)
    integration_depth: float = 50.0      # 'integration_depth' default 50 (:508)
    sampling_seed: int = 42              # 'sampling_seed' default 42 (:509)
    field_of_view_x: float = 1.0         # (:510)
    field_of_view_y: float = 1.0         # (:511)
    samples: int = 1                     # eevee.taa_render_samples analogue
    sky_image: str = ""                  # 'sky_image' path (:512)
    mark_x_min: int = -1                 # debug crop (:513-517)
    mark_x_max: int = -1
    mark_y_min: int = -1
    mark_y_max: int = -1
    # Gen-1 disk props (LimitedRelativisticRenderEngine.py:492-498)
    disk_on: bool = False
    disk_R_in: float = 2.0
    disk_R_out: float = 6.0
    disk_phase: float = 0.0
    disk_mean: float = 0.5
    disk_stddev: float = 0.2
    disk_intensity: float = 1.0
    disk_texture: str = ""
    # relativistic beaming exponent (0/None = off, 4.0 = bolometric) and
    # orbit direction (+1 prograde / -1 retrograde); beyond-reference physics
    disk_beaming: float = 0.0
    disk_orbit_dir: float = 1.0
    # intrinsic polarization degree of the disk emission (0 = off); feeds
    # render.render_stokes (Stokes I/Q/U output)
    disk_pol_frac: float = 0.0
    # Kerr spin (Gen-3 'a', RelativisticRenderEngineCamEdition.py:210)
    spin: float = 0.0
    # -- Gen-1 'Limited' engine props (LimitedRelativisticRenderEngine.py
    # :486-506): engine selects between the reference's generations --
    # 'whole' = whole-scene metric (Gen-2/3), 'limited' = sphere-of-
    # influence hybrid (Gen-1, render/limited.py).
    engine: str = "whole"
    metric: str = "schwarzschild"        # 'schwarzschild' | 'flat' -- the
    # reference's precise curved-vs-flat comparison backend (:487,90;
    # README.md:233).  'flat' renders with mass 0 (straight rays, no
    # horizon) through the SAME pipeline.
    approx: bool = False                 # surrogate instead of the ODE (:60,499)
    ratio_obj_to_blackhole: float = 20.0  # influence-sphere radius (:489)
    exit_tolerance: float = 0.1          # exit-shell thickness (:273-278)
    test_output: bool = False            # debug gradient background (:390-396)
    debug_colors: bool = True            # rogue-ray color coding (README.md:234)
    # Optional npz of a trained models/surrogate.NeuralSurrogate (written by
    # either package): the learned (Kerr-capable) approx backend; empty ->
    # the exact-by-symmetry Schwarzschild table is built on the fly
    # (reference reload semantics, :96-101).
    surrogate_path: str = ""

    # -- scene content (Blender objects in the reference) -----------------
    bh_loc: tuple = (0.0, 0.0, 0.0)
    camera_location: tuple = (0.0, 0.0, 25.0)
    camera_rotation_euler: tuple = (0.0, 0.0, 0.0)
    spheres: list = dataclasses.field(default_factory=list)
    # each: {center, radius, texture?, emission?, albedo?}
    lights: list = dataclasses.field(default_factory=list)
    light_intensity: float = 10.0

    # -- output / integrator ----------------------------------------------
    width: int = 256
    height: int = 256
    n_steps: int = 512
    # 'auto' (the CUDA kernels for tensors on the card, the plain loops on
    # the CPU), 'cuda' or 'torch'; the JAX package's names map through
    # convert's table: 'pallas' -> 'cuda', 'scan' -> 'torch'.
    backend: str = "auto"
    # 'rk4' (fixed-step) or 'dopri' (adaptive Dormand-Prince 5(4), the
    # reference's scipy-RK45 twin -- its README.md:196-211;
    # 'max_integration_step' bounds the adaptive step exactly like the
    # reference passes max_step to solve_ivp, RelativisticRenderEngine.py
    # :293).  Both modes differentiate (the exact discrete adjoint of the
    # adaptive scheme); on the card 'dopri' runs through the hand-written
    # kernels dopri_fwd (K4) forward, dopri_ckpt (K5) and dopri_bwd (K6)
    # for the gradient, on the CPU through the plain trip loops.
    method: str = "rk4"
    mode: str = "scan"
    rtol: float = 1e-5
    atol: float = 1e-8
    # radius-proportional step growth (ops/integrate.IntegratorConfig)
    dt_boost: float = 8.0
    dt_boost_r_ref: float = 0.0
    dt_power: float = 1.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "SceneConfig":
        # '__'-prefixed keys are annotations (JSON has no comments; the
        # shipped examples/ configs document themselves via '__comment')
        d = {k: v for k, v in d.items() if not k.startswith("__")}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d)


def load_config(path: str) -> SceneConfig:
    with open(path) as f:
        return SceneConfig.from_dict(json.load(f))


def integrator_backend(name: str) -> str:
    """The port's integrator backend for a config's ``backend``: the JAX
    package's names through convert's table, the port's own as they
    are."""
    if name in ("cuda", "torch"):
        return name
    if name in _BACKENDS:
        return _BACKENDS[name]
    raise ValueError(f"unknown backend {name!r} (expected one of "
                     f"{sorted({*_BACKENDS, 'cuda', 'torch'})})")


def _resolve_image(spec: str) -> np.ndarray:
    """Image path OR a scene.textures registry name ('background', 'moon',
    'disk_clouds', ...) -> (H, W, 3) float32 array (a copy: the registry's
    cached arrays are never handed out)."""
    from ..scene.textures import TEXTURES, load_texture

    if spec in TEXTURES:
        return np.array(load_texture(spec), np.float32)
    return np.array(read_image(spec), np.float32)


def _texture(spec, default_color=(1.0, 1.0, 1.0), shape=(8, 8)):
    """Texture spec: registry name | image path | [r, g, b] | None
    -> (H, W, 3) float32 array."""
    if isinstance(spec, str) and spec:
        return _resolve_image(spec)
    color = spec if isinstance(spec, (list, tuple)) and len(spec) == 3 \
        else default_color
    return np.broadcast_to(np.asarray(color, np.float32),
                           shape + (3,)).copy()


def resize_linear(tex: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, 3) -> (h, w, 3) as ``jax.image.resize(..., "linear")``: a
    triangle filter on half-pixel centres, widened by the scale where it
    shrinks (torch's bilinear ``antialias=True``)."""
    t = torch.as_tensor(np.ascontiguousarray(tex, np.float32))
    out = F.interpolate(t.permute(2, 0, 1)[None], size=(h, w),
                        mode="bilinear", align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).numpy()


def build_scene(cfg: SceneConfig, device=None
                ) -> tuple[Scene, Camera, RenderConfig]:
    """SceneConfig -> (Scene, Camera, RenderConfig) on ``device`` (the card
    unless the caller names another), the render() ingest step of the
    reference (RelativisticRenderEngine.py:57-118)."""
    device = on_device(device)
    background = None
    if cfg.sky_image:
        background = torch.as_tensor(_resolve_image(cfg.sky_image),
                                     device=device)

    disk = None
    if cfg.disk_on:
        disk = Disk.make(
            r_in=cfg.disk_R_in, r_out=cfg.disk_R_out,
            texture=_texture(cfg.disk_texture, (1.0, 0.6, 0.2)),
            phase=cfg.disk_phase, mean=cfg.disk_mean,
            stddev=cfg.disk_stddev, intensity=cfg.disk_intensity,
            beaming=cfg.disk_beaming if cfg.disk_beaming else None,
            orbit_dir=cfg.disk_orbit_dir,
            pol_frac=cfg.disk_pol_frac if cfg.disk_pol_frac else None,
            device=device)

    spheres = None
    if cfg.spheres:
        centers = [s["center"] for s in cfg.spheres]
        radii = [s["radius"] for s in cfg.spheres]
        texs = [_texture(s.get("texture"), (0.8, 0.8, 0.8))
                for s in cfg.spheres]
        hmax = max(t.shape[0] for t in texs)
        wmax = max(t.shape[1] for t in texs)
        texs = [t if t.shape[:2] == (hmax, wmax) else
                resize_linear(t, hmax, wmax) for t in texs]
        emission = [float(s.get("emission", 1.0)) for s in cfg.spheres]
        albedo = [s.get("albedo", [1.0, 1.0, 1.0]) for s in cfg.spheres]
        spheres = Spheres.make(center=centers, radius=radii,
                               texture=np.stack(texs), emission=emission,
                               albedo=albedo, device=device)

    lights = None
    if cfg.lights:
        lights = Lights.make(position=cfg.lights,
                             intensity=cfg.light_intensity, device=device)

    if cfg.metric not in ("schwarzschild", "flat"):
        raise ValueError(f"unknown metric {cfg.metric!r} "
                         "(expected 'schwarzschild' or 'flat')")
    if cfg.engine not in ("whole", "limited"):
        raise ValueError(f"unknown engine {cfg.engine!r} "
                         "(expected 'whole' or 'limited')")
    # metric='flat': the reference's validation backend (straight rays) --
    # mass 0 turns the Kerr-Schild potential off exactly.
    mass = 0.0 if cfg.metric == "flat" else cfg.mass
    spin = None if cfg.metric == "flat" else (cfg.spin if cfg.spin else None)
    scene = Scene(
        bh=BlackHole.make(mass=mass, loc=cfg.bh_loc, spin=spin,
                          device=device),
        background=background, disk=disk, spheres=spheres, lights=lights)

    cam = Camera.make(position=cfg.camera_location,
                      euler=cfg.camera_rotation_euler,
                      fov=(cfg.field_of_view_x, cfg.field_of_view_y),
                      device=device)

    render_cfg = RenderConfig(
        width=cfg.width, height=cfg.height, samples=cfg.samples,
        seed=cfg.sampling_seed,
        integrator=IntegratorConfig(
            n_steps=cfg.n_steps, dt=cfg.max_integration_step,
            method=cfg.method, mode=cfg.mode,
            rtol=cfg.rtol, atol=cfg.atol,
            max_step=(cfg.max_integration_step if cfg.method == "dopri"
                      and cfg.max_integration_step > 0 else math.inf),
            backend=integrator_backend(cfg.backend), dt_boost=cfg.dt_boost,
            dt_boost_r_ref=cfg.dt_boost_r_ref, dt_power=cfg.dt_power),
        lam_max=cfg.integration_depth if cfg.integration_depth > 0
        else math.inf,
        mark_x_min=cfg.mark_x_min, mark_x_max=cfg.mark_x_max,
        mark_y_min=cfg.mark_y_min, mark_y_max=cfg.mark_y_max)
    return scene, cam, render_cfg


def build_limited(cfg: SceneConfig, device=None):
    """SceneConfig -> (LimitedConfig, surrogate or None) for the Gen-1
    engine (``engine='limited'``), the surrogate on ``device`` (the card
    unless the caller names another).

    The surrogate backend follows the reference's approx semantics
    (LimitedRelativisticRenderEngine.py:60,96-101,499): with
    ``surrogate_path`` a trained ``models/surrogate.NeuralSurrogate`` npz
    (written by either package) is loaded (the learned Kerr-capable path);
    otherwise ``render_limited`` builds the exact-by-symmetry
    Schwarzschild table on the fly.
    """
    from ..render.limited import LimitedConfig

    lcfg = LimitedConfig(
        r_influence=cfg.ratio_obj_to_blackhole,
        exit_tolerance=cfg.exit_tolerance,
        test_output=cfg.test_output,
        debug_colors=cfg.debug_colors,
        approx=cfg.approx,
    )
    table = None
    if cfg.approx and cfg.surrogate_path:
        from ..models.surrogate import load_surrogate

        table = load_surrogate(cfg.surrogate_path, device=on_device(device))
        # A surrogate is only valid for the geometry/physics it was trained
        # on (the npz stores them for exactly this check -- the reference's
        # reload-on-parameter-change semantics, :96-101); a mismatch would
        # render silently wrong physics.
        mass = 0.0 if cfg.metric == "flat" else cfg.mass
        spin = 0.0 if cfg.metric == "flat" else cfg.spin
        mismatches = [
            (name, got, want)
            for name, got, want in (
                ("mass", float(table.mass), mass),
                ("spin", float(table.spin), spin),
                ("ratio_obj_to_blackhole", float(table.r_influence),
                 cfg.ratio_obj_to_blackhole),
                ("exit_tolerance",
                 float(table.r_exit) / float(table.r_influence) - 1.0
                 if table.r_exit is not None else cfg.exit_tolerance,
                 cfg.exit_tolerance),
            )
            if abs(got - want) > 1e-4 * max(abs(want), 1.0)
        ]
        if mismatches:
            detail = ", ".join(f"{n}: surrogate={g:g} vs config={w:g}"
                               for n, g, w in mismatches)
            raise ValueError(
                f"surrogate {cfg.surrogate_path!r} was trained for a "
                f"different setup ({detail}); retrain with "
                f"`bhgc-torch train-surrogate` matching this config")
    return lcfg, table
