"""The closed loop of inverse-rendering steps (``loops/fit.py``) over a
Kerr configuration: its scenes are ``scenes_kerr.KerrScenes`` and its
plain reference ``reference_kerr``, so a hole's spin, and a learned spin,
reach the program and the reference alike.

The step, the window's draw of the step the check replays, and the
compared numbers are ``fit.Loop``'s.  The reference goes through a frame
in blocks of ``REF_BLOCK_RAYS`` rays, each integrated in checkpointed
pieces of ``REF_SEGMENT`` steps: half the Schwarzschild loop's piece,
since a Kerr step keeps about twice the tensors for autograd.

The program must mask a Kerr hole by its own critical curve, as the
reference does: set-up first runs one Trainer step of the program on
rays that lie on the curve's prograde side by the reference, and stops a
program that gives them weight (``_refuse_without_kerr_mask``).

``Loop.__init__`` sets ``base.Loop``'s and ``fit.Loop``'s fields itself,
with ``KerrScenes`` where ``base.Loop`` makes a ``scenes.Scenes`` (which
refuses a spin); gpubench/tests/test_gpubench_kerr.py holds its fields
to ``fit.Loop``'s.
"""

from __future__ import annotations

import dataclasses
import random

import torch

from ..reference_kerr import integrate as KI
from ..reference_kerr import render as RK
from ..scenes_kerr import KerrScenes
from .base import REF_BLOCK_RAYS
from .fit import Loop as _Fit

REF_SEGMENT = 8
# The mask's probe: a frame of PROBE^2 pixel-centre rays at the truth, and
# the rays within half the band of the critical curve at angles psi below
# PROBE_PSI, by Bardeen's prograde edge (at a/M = 0.9, 0.55 of the
# Schwarzschild 3 sqrt(3) M, outside that rule's band).
PROBE = 256
PROBE_PSI = 0.3


class Loop(_Fit):
    def __init__(self, cell, seed, device):
        # base.Loop's and fit.Loop's fields, with the Kerr scenes
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.traffic = cell["traffic"]
        self.config = cell["config"]
        self.scenes = KerrScenes(self.config, seed, device)
        self.samples = int(self.config["scene"].get("samples", 1))
        self.cfg = self.scenes.port_render_config()
        self.tracing = False
        self.traced = []
        self.gen = None
        self.targets = list(self.config["fit"]["targets"])
        self.cycle = len(self.targets)
        self.first = self.n_check = int(self.traffic.get("checked_steps", 3))
        opt = self.traffic["optimizer"]
        if opt["name"] != "adam":
            raise ValueError(f"unknown optimizer {opt['name']!r}")
        self.lr = float(opt["lr"])
        self.clip = self.traffic.get("clip_norm")
        self.mask = self.traffic.get("mask_critical")
        self.frame = self.targets[0]
        self.rng = random.Random(self.seed)
        self.n_window = 0
        self.window = None
        self.compared = None

    def setup(self):
        self._refuse_without_kerr_mask()
        super().setup()

    def _refuse_without_kerr_mask(self):
        """Stops a program whose Trainer does not leave out the rays by a
        Kerr hole's critical curve: a Trainer step on the probe's rays
        alone (``PROBE``), against a target no colour reaches, reads a
        loss of 0 only if each of them has weight 0."""
        if self.mask is None:
            return
        import blackhole_geodesic_calculator_tpu_torch as P

        sc, truth = self.scenes, self.scenes.truth()
        rcfg = dict(sc.reference_render_config(), width=PROBE, height=PROBE,
                    samples=1)
        best = None
        with torch.no_grad():
            for frame in self.targets:
                scene, cam = sc.reference(sc.raw(frame, truth))
                ys, xs = RK.pixels(rcfg, self.device)
                o, d = RK.generate_rays(cam, PROBE, PROBE, ys, xs)
                o = o - scene["loc"]
                a = scene["spin"]
                p0, e0 = KI.null_init(o, d, scene["mass"], a)
                lam, eta = (v.double() for v in RK.carter(o, p0, e0, a))
                lam = torch.where(a < 0, -lam, lam)
                eta0 = torch.clamp_min(eta, 0.0)
                psi = torch.atan2(torch.sqrt(eta0), lam)
                ratio = torch.sqrt(eta0 + lam * lam) / RK.critical_rho(
                    psi, scene["mass"], a)
                near = ((eta >= 0) & (psi < PROBE_PSI)
                        & ((ratio - 1.0).abs() < 0.5 * self.mask))
                if best is None or int(near.sum()) > int(best[1].sum()):
                    best = (frame, near, ys[near], xs[near])
        frame, near, ys, xs = best
        if ys.numel() < 8:
            raise ValueError("no target frame shows the prograde side of "
                             "the critical curve: the Kerr mask's probe "
                             "has no rays")
        tr = P.Trainer(
            cfg=dataclasses.replace(self.cfg, width=PROBE, height=PROBE,
                                    samples=1),
            param_fn=lambda p: sc.port(sc.raw(frame, p)),
            optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0),
            mask_critical=self.mask)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in truth.items()}
        _, _, loss = tr.step(params, tr.init(params), torch.full(
            (ys.numel(), 3), -1.0, device=self.device), ys, xs)
        if float(loss) != 0.0:
            raise RuntimeError(
                "the program's Trainer keeps rays that lie on the Kerr "
                "critical curve (loss %r on %d of them): this loop "
                "compares its Kerr mask with the reference's"
                % (float(loss), ys.numel()))

    def _ref_scenes(self, dtype) -> KerrScenes:
        return KerrScenes(self.config, self.seed, self.device, dtype)

    def _block_rows(self) -> int:
        return max(1, REF_BLOCK_RAYS // (self.cfg.width * self.samples))

    def _target(self, sc, rcfg, t: int, dtype):
        with torch.no_grad():
            return RK.render_rgb(
                *sc.reference(sc.raw(self.targets[t], sc.truth())), rcfg,
                self._draws(20_000 + t, dtype))

    def _ref_step(self, sc, rcfg, k: int, params: dict, dtype):
        """The reference's loss and clipped gradients of step ``k`` at
        ``params``."""
        t = k % len(self.targets)
        frame = self.targets[t]
        loss, grads = RK.step_loss_and_grads(
            lambda p: sc.reference(sc.raw(frame, p)), params, rcfg,
            self._target(sc, rcfg, t, dtype), self._draws(10_000 + k, dtype),
            self.mask, self._block_rows(), REF_SEGMENT)
        if self.clip is not None:
            grads = RK.clip_by_global_norm(grads, self.clip)
        return loss, grads

    def reference_steps(self, dtype=torch.float32) -> dict:
        """``fit.Loop.reference_steps`` by the Kerr reference."""
        sc = self._ref_scenes(dtype)
        rcfg = sc.reference_render_config()
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in sc.start().items()}
        p0 = {k: v.detach().clone() for k, v in params.items()}
        adam = RK.Adam(params, self.lr)
        losses, grads = [], []
        for k in range(self.n_check):
            loss, g = self._ref_step(sc, rcfg, k, params, dtype)
            params = adam.step(params, g)
            losses.append(loss)
            grads.append(g)
        out = {"losses": losses, "grads": grads, "grad": grads[0],
               "change": {k: params[k].detach() - p0[k] for k in params}}
        if self.window is not None:
            w = self.window
            before = {n: s["p"].to(dtype).clone().requires_grad_(True)
                      for n, s in w["before"].items()}
            loss, g = self._ref_step(sc, rcfg, w["k"], before, dtype)
            adam = RK.Adam(before, self.lr, state={
                n: (s["m"].to(dtype), s["v"].to(dtype), s["t"])
                for n, s in w["before"].items()})
            new = adam.step(before, g)
            out["window"] = {"loss": loss, "grad": g, "change": {
                n: new[n].detach() - before[n].detach() for n in new}}
        return out

    def traced_rays(self):
        """The Kerr reference's (env, integrator, initial state) of each
        traced step."""
        sc = self._ref_scenes(torch.float32)
        rcfg = sc.reference_render_config()
        for k, params in self.traced:
            frame = self.targets[k % len(self.targets)]
            scene, cam = sc.reference(sc.raw(frame, params))
            ys, xs = RK.pixels(rcfg, self.device)
            env, s0 = RK.initial_state(scene, cam, rcfg, ys, xs,
                                       self._draws(10_000 + k))
            yield env, rcfg["integrator"], s0
