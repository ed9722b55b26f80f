"""A configuration's scene, frame by frame, for the program and for the
reference.

``Scenes`` reads a configuration file's ``scene`` (the keys of the
example JSON it names), its ``animation`` (what moves from frame to frame)
and its ``fit`` (which tensors the inverse-rendering step learns and how
far from the truth they start).  It makes the textures from the run's seed
once; ``raw(frame, params)`` gives the tensors of a frame (learned ones
substituted), ``port(raw)`` the program's objects, built with its
constructors, and ``reference(raw)`` the plain reference's dicts.  Both
sides get the very same tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import textures
from .reference import integrate as RI

# What a learned parameter replaces in a frame's tensors (``raw``).
LEARNABLE = ("mass", "orbit_phase", "roll", "camera_position", "sky",
             "sphere_texture")

# The keys of a configuration that this module reads; any other key (a
# spin, another mode) would be left out of both sides alike, so it stops
# the run instead.
READS = {
    "scene": {"mass", "sky_image", "width", "height", "samples",
              "field_of_view_x", "field_of_view_y", "camera_location",
              "disk_on", "disk_R_in", "disk_R_out", "disk_texture",
              "disk_phase", "disk_mean", "disk_stddev", "disk_intensity",
              "spheres", "method", "mode", "n_steps",
              "max_integration_step", "rtol", "atol", "dt_boost",
              "dt_boost_r_ref", "dt_power", "integration_depth"},
    "sphere": {"center", "radius", "texture"},
    "animation": {"kind", "radius", "frames", "tonemap"},
    "fit": {"targets", "learn"},
}


def _only_known(what: str, keys) -> None:
    unknown = sorted(set(keys) - READS[what])
    if unknown:
        raise ValueError(f"the configuration's {what} has keys that the "
                         f"benchmark does not read: {unknown}")


class Scenes:
    def __init__(self, config: dict, seed: int, device, dtype=torch.float32):
        self.config, self.seed = config, int(seed)
        self.device = torch.device(device)
        self.dtype = dtype
        self.sc = config["scene"]
        self.anim = config["animation"]
        self._const = self._port_base = None
        _only_known("scene", self.sc)
        _only_known("animation", self.anim)
        _only_known("fit", config["fit"])
        for s in self.sc.get("spheres") or []:
            _only_known("sphere", s)
        if (self.sc.get("method", "rk4"), self.sc.get("mode", "scan")) not in {
                (m, d) for m in ("rk4", "dopri") for d in ("scan", "while")}:
            raise ValueError("the reference integrates rk4 or dopri, in "
                             "scan or while mode")
        sc, dev = self.sc, self.device
        self.sky = textures.make(sc["sky_image"], seed, dev)
        self.disk_texture = (textures.make(sc["disk_texture"], seed, dev)
                             if sc.get("disk_on") else None)
        self.sphere_texture = None
        if sc.get("spheres"):
            made = {}
            for s in sc["spheres"]:
                if s["texture"] not in made:
                    made[s["texture"]] = textures.make(s["texture"], seed, dev)
            self.sphere_texture = torch.stack(
                [made[s["texture"]] for s in sc["spheres"]])
        for name in config["fit"]["learn"]:
            if name not in LEARNABLE:
                raise ValueError(f"unknown learned parameter {name!r}")

    def _t(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    # -- the frames --------------------------------------------------------
    def n_frames(self) -> int:
        return int(self.anim["frames"])

    def truth(self) -> dict:
        """The true value of each learned parameter."""
        sc = self.sc
        values = {"mass": self._t(sc["mass"]), "orbit_phase": self._t(0.0),
                  "roll": self._t(0.0),
                  "camera_position": self._t(sc["camera_location"]),
                  "sky": self.sky.to(self.dtype),
                  "sphere_texture": None if self.sphere_texture is None
                  else self.sphere_texture.to(self.dtype)}
        return {k: values[k] for k in self.config["fit"]["learn"]}

    def start(self) -> dict:
        """The learned parameters where the fit starts: the truth plus the
        configuration's start errors (None: no error)."""
        out = {}
        for k, v in self.truth().items():
            err = self.config["fit"]["learn"][k]
            out[k] = v.clone() if err is None else v + self._t(err)
        return out

    def _constants(self) -> dict:
        """The tensors that no frame changes, made once."""
        if self._const is None:
            sc = self.sc
            c = {"mass": self._t(sc["mass"]), "loc": self._t((0.0, 0.0, 0.0)),
                 "cam_pos": self._t(sc["camera_location"]),
                 "euler": self._t((0.0, 0.0, 0.0)),
                 "fov": self._t((sc["field_of_view_x"],
                                 sc["field_of_view_y"])),
                 "background": self.sky.to(self.dtype),
                 "disk": None, "spheres": None}
            if self.disk_texture is not None:
                c["disk"] = {
                    "r_in": self._t(sc["disk_R_in"]),
                    "r_out": self._t(sc["disk_R_out"]),
                    "phase": self._t(sc.get("disk_phase", 0.0)),
                    "mean": self._t(sc.get("disk_mean", 0.5)),
                    "stddev": self._t(sc.get("disk_stddev", 0.2)),
                    "intensity": self._t(sc.get("disk_intensity", 1.0)),
                    "texture": self.disk_texture.to(self.dtype)}
            if sc.get("spheres"):
                c["spheres"] = {
                    "center": self._t([s["center"] for s in sc["spheres"]]),
                    "radius": self._t([s["radius"] for s in sc["spheres"]]),
                    "texture": self.sphere_texture.to(self.dtype)}
            self._const = c
        return self._const

    def raw(self, frame: int, params: dict | None = None) -> dict:
        """Frame ``frame``'s tensors, with ``params`` (learned parameters,
        possibly in the autograd graph) in place of their true values.
        Without ``params`` only what moves is made anew, from the host's
        numbers, as the animate command moves its camera."""
        out = dict(self._constants())
        p = params or {}
        n = self.n_frames()
        phase = 2.0 * math.pi * (frame % n) / n
        kind, r = self.anim["kind"], float(self.anim["radius"])
        if kind == "camera_orbit":
            if "orbit_phase" in p or "roll" in p:
                ph = self._t(phase) + p.get("orbit_phase", self._t(0.0))
                zero = torch.zeros_like(ph)
                out["cam_pos"] = torch.stack(
                    [r * torch.sin(ph), zero, r * torch.cos(ph)])
                out["euler"] = torch.stack([zero, ph, p.get("roll", zero)])
            else:
                out["cam_pos"] = self._t(
                    (r * math.sin(phase), 0.0, r * math.cos(phase)))
                out["euler"] = self._t((0.0, phase, 0.0))
        elif kind == "sphere_orbit":
            centers = [list(s["center"]) for s in self.sc["spheres"]]
            centers[0] = [r * math.sin(phase), 0.0, -r * math.cos(phase)]
            out["spheres"] = dict(out["spheres"], center=self._t(centers))
        else:
            raise ValueError(f"unknown animation kind {kind!r}")
        if kind != "camera_orbit" and ("orbit_phase" in p or "roll" in p):
            raise ValueError("a learned orbit phase or roll needs a camera "
                             "orbit")
        for key, name in (("mass", "mass"), ("cam_pos", "camera_position"),
                          ("background", "sky")):
            if name in p:
                out[key] = p[name]
        if "sphere_texture" in p:
            out["spheres"] = dict(out["spheres"], texture=p["sphere_texture"])
        return out

    # -- the program's side ------------------------------------------------
    def port_render_config(self):
        import blackhole_geodesic_calculator_tpu_torch as P

        sc = self.sc
        dopri = sc.get("method", "rk4") == "dopri"
        return P.RenderConfig(
            width=sc["width"], height=sc["height"],
            samples=int(sc.get("samples", 1)),
            integrator=P.IntegratorConfig(
                n_steps=sc["n_steps"], dt=sc["max_integration_step"],
                method=sc.get("method", "rk4"), mode=sc.get("mode", "scan"),
                rtol=sc.get("rtol", 1e-5), atol=sc.get("atol", 1e-8),
                max_step=sc["max_integration_step"] if dopri else math.inf,
                dt_boost=sc.get("dt_boost", 8.0),
                dt_boost_r_ref=sc.get("dt_boost_r_ref", 0.0),
                dt_power=sc.get("dt_power", 1.0)),
            lam_max=sc["integration_depth"])

    def port(self, raw: dict):
        """The program's (Scene, Camera) of a frame.  The first call makes
        them with the program's constructors from the unchanging tensors;
        each frame then puts in what moves or is learned with
        ``dataclasses.replace``, as the animate command and
        examples/fit_orbit.py do."""
        import blackhole_geodesic_calculator_tpu_torch as P

        if self._port_base is None:
            c, dev = self._constants(), self.device
            disk = spheres = None
            if c["disk"] is not None:
                d = c["disk"]
                disk = P.Disk.make(r_in=d["r_in"], r_out=d["r_out"],
                                   texture=d["texture"], phase=d["phase"],
                                   mean=d["mean"], stddev=d["stddev"],
                                   intensity=d["intensity"], device=dev)
            if c["spheres"] is not None:
                s = c["spheres"]
                spheres = P.Spheres.make(center=s["center"],
                                         radius=s["radius"],
                                         texture=s["texture"], device=dev)
            self._port_base = (
                P.Scene(bh=P.BlackHole.make(mass=c["mass"], loc=c["loc"],
                                            device=dev),
                        background=c["background"], disk=disk,
                        spheres=spheres),
                P.Camera.make(position=c["cam_pos"], euler=c["euler"],
                              fov=c["fov"], device=dev))
        scene, cam = self._port_base
        spheres = scene.spheres
        if spheres is not None:
            spheres = dataclasses.replace(
                spheres, center=raw["spheres"]["center"],
                texture=raw["spheres"]["texture"])
        scene = dataclasses.replace(
            scene, bh=dataclasses.replace(scene.bh, mass=raw["mass"],
                                          loc=raw["loc"]),
            background=raw["background"], spheres=spheres)
        cam = dataclasses.replace(cam, position=raw["cam_pos"],
                                  euler=raw["euler"])
        return scene, cam

    # -- the reference's side ----------------------------------------------
    def reference_render_config(self) -> dict:
        sc = self.sc
        dopri = sc.get("method", "rk4") == "dopri"
        return {
            "width": sc["width"], "height": sc["height"],
            "samples": int(sc.get("samples", 1)),
            "lam_max": sc["integration_depth"], "r_escape": 0.0,
            "integrator": RI.Integrator(
                n_steps=sc["n_steps"], dt=sc["max_integration_step"],
                method=sc.get("method", "rk4"),
                dt_boost=sc.get("dt_boost", 8.0),
                dt_boost_r_ref=sc.get("dt_boost_r_ref", 0.0),
                dt_power=sc.get("dt_power", 1.0),
                rtol=sc.get("rtol", 1e-5), atol=sc.get("atol", 1e-8),
                max_step=sc["max_integration_step"] if dopri else math.inf)}

    @staticmethod
    def reference(raw: dict):
        """The reference's (scene, camera) dicts of a frame."""
        scene = {"mass": raw["mass"], "loc": raw["loc"],
                 "background": raw["background"], "disk": raw["disk"],
                 "spheres": raw["spheres"]}
        cam = {"position": raw["cam_pos"], "euler": raw["euler"],
               "fov": raw["fov"]}
        return scene, cam


def draws(gen: torch.Generator, seed: int, frame: int, shape,
          dtype=torch.float32):
    """The jitter draws of frame ``frame`` (or of a fit step): uniform in
    [0, 1), drawn by ``gen`` (a generator on the device, made once and
    reseeded here: a new CUDA generator each frame costs the host more and
    more over a run) seeded by (seed, frame)."""
    gen.manual_seed((int(seed) * 7_919 + 104_729 * (frame + 1)) % (2**63))
    return torch.rand(shape, generator=gen, device=gen.device).to(dtype)
