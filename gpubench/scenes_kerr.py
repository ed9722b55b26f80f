"""A Kerr configuration's scenes, frame by frame, for the program and for
the Kerr reference.

``KerrScenes`` is ``scenes.Scenes`` for a hole with a spin: it reads the
configuration's ``scene`` keys ``spin`` and ``disk_beaming`` on top of
``scenes.READS``, and may learn ``spin`` on top of ``scenes.LEARNABLE``.
The program gets ``BlackHole.make(spin=...)`` and ``Disk.make(beaming=...)``
and the reference (``reference_kerr``) the very same tensors.  Every
other unknown key still stops the run, and so do spheres and the
Dormand-Prince integrator, which the Kerr reference does not have.

A learned spin is the tensor s of a = M tanh(s), M the frame's (learned)
mass, so that every step keeps |a| < M, a hole and not a naked
singularity, whatever the optimizer does; the configuration's start error
of ``spin`` is on a itself.
"""

from __future__ import annotations

import dataclasses

import torch

from . import scenes
from .reference_kerr import integrate as RK

READS = {"scene": {"spin", "disk_beaming"}}
LEARNABLE = scenes.LEARNABLE + ("spin",)


class KerrScenes(scenes.Scenes):
    def __init__(self, config: dict, seed: int, device, dtype=torch.float32):
        sc = dict(config["scene"])
        if "spin" not in sc:
            raise ValueError("a Kerr configuration gives the hole's spin")
        extra = {k: sc.pop(k) for k in READS["scene"] if k in sc}
        if sc.get("spheres"):
            raise ValueError("the Kerr reference has no spheres")
        if sc.get("method", "rk4") != "rk4":
            raise ValueError("the Kerr reference integrates rk4 only")
        self.learn = dict(config["fit"]["learn"])
        for name in self.learn:
            if name not in LEARNABLE:
                raise ValueError(f"unknown learned parameter {name!r}")
        base_learn = {k: v for k, v in self.learn.items() if k != "spin"}
        super().__init__(dict(config, scene=sc, fit=dict(
            config["fit"], learn=base_learn)), seed, device, dtype)
        self.spin = extra["spin"]
        self.beaming = extra.get("disk_beaming")

    def _spin_leaf(self, spin, mass):
        return torch.atanh(self._t(spin) / mass)

    def truth(self) -> dict:
        base = super().truth()
        mass = self._t(self.sc["mass"])
        return {k: self._spin_leaf(self.spin, mass) if k == "spin"
                else base[k] for k in self.learn}

    def start(self) -> dict:
        """The truth plus the configuration's start errors; the spin's
        error is on a, at the start's mass."""
        out = {}
        for k, v in self.truth().items():
            err = self.learn[k]
            if k != "spin":
                out[k] = v.clone() if err is None else v + self._t(err)
        mass = out.get("mass", self._t(self.sc["mass"]))
        if "spin" in self.learn:
            err = self.learn["spin"] or 0.0
            out["spin"] = self._spin_leaf(self.spin + err, mass)
        return {k: out[k] for k in self.learn}

    def _constants(self) -> dict:
        if self._const is None:
            c = super()._constants()
            c["spin"] = self._t(self.spin)
            if c["disk"] is not None:
                c["disk"]["beaming"] = (None if self.beaming is None
                                        else self._t(self.beaming))
        return self._const

    def raw(self, frame: int, params: dict | None = None) -> dict:
        """``Scenes.raw`` with the spin: a = M tanh(s) of a learned s."""
        out = super().raw(frame, params)
        if params and "spin" in params:
            out["spin"] = out["mass"] * torch.tanh(params["spin"])
        return out

    # -- the program's side ------------------------------------------------
    def port(self, raw: dict):
        """The program's (Scene, Camera) of a frame, made with its
        constructors once and then given what moves or is learned, as
        ``Scenes.port`` does."""
        import blackhole_geodesic_calculator_tpu_torch as P

        if self._port_base is None:
            c, dev = self._constants(), self.device
            disk = None
            if c["disk"] is not None:
                d = c["disk"]
                disk = P.Disk.make(r_in=d["r_in"], r_out=d["r_out"],
                                   texture=d["texture"], phase=d["phase"],
                                   mean=d["mean"], stddev=d["stddev"],
                                   intensity=d["intensity"],
                                   beaming=d["beaming"], device=dev)
            self._port_base = (
                P.Scene(bh=P.BlackHole.make(mass=c["mass"], loc=c["loc"],
                                            spin=c["spin"], device=dev),
                        background=c["background"], disk=disk),
                P.Camera.make(position=c["cam_pos"], euler=c["euler"],
                              fov=c["fov"], device=dev))
        scene, cam = self._port_base
        scene = dataclasses.replace(
            scene, bh=dataclasses.replace(scene.bh, mass=raw["mass"],
                                          loc=raw["loc"], spin=raw["spin"]),
            background=raw["background"])
        cam = dataclasses.replace(cam, position=raw["cam_pos"],
                                  euler=raw["euler"])
        return scene, cam

    # -- the reference's side ----------------------------------------------
    def reference_render_config(self) -> dict:
        sc = self.sc
        return {
            "width": sc["width"], "height": sc["height"],
            "samples": int(sc.get("samples", 1)),
            "lam_max": sc["integration_depth"], "r_escape": 0.0,
            "integrator": RK.Integrator(
                n_steps=sc["n_steps"], dt=sc["max_integration_step"],
                dt_boost=sc.get("dt_boost", 8.0),
                dt_boost_r_ref=sc.get("dt_boost_r_ref", 0.0),
                dt_power=sc.get("dt_power", 1.0))}

    @staticmethod
    def reference(raw: dict):
        """The Kerr reference's (scene, camera) dicts of a frame."""
        scene = {"mass": raw["mass"], "spin": raw["spin"], "loc": raw["loc"],
                 "background": raw["background"], "disk": raw["disk"]}
        cam = {"position": raw["cam_pos"], "euler": raw["euler"],
               "fov": raw["fov"]}
        return scene, cam
