"""A closed loop of inverse-rendering steps: a ``Trainer`` built once, its
step called on target k mod T with fresh draws; a step is done when its
loss is on the host, as ``Trainer.fit_frames`` reads it.

Set-up renders the targets and runs the first ``checked_steps`` steps
through the same call: the reference replays them from the same start.
One step of the window, drawn uniformly from the seed as the window runs
(a reservoir of one), is recorded with the parameters and Adam's moments
before it: the reference redoes that step from the program's state, with
the same target and draws.
"""

from __future__ import annotations

import random

import torch

from .. import compare
from ..reference import render as R
from .base import REF_SEGMENT
from .base import Loop as _Base


class Loop(_Base):
    unit = "step"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
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
        self.window = None      # the window step that the check replays
        self.compared = None

    def _param_fn(self, params):
        return self.scenes.port(self.scenes.raw(self.frame, params))

    def setup(self):
        import blackhole_geodesic_calculator_tpu_torch as P

        sc = self.scenes
        with torch.no_grad():
            images = [P.render_image(*sc.port(sc.raw(f, sc.truth())),
                                     self.cfg, draws=self._draws(20_000 + t))
                      for t, f in enumerate(self.targets)]
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in sc.start().items()}
        self.p0 = {k: v.detach().clone() for k, v in self.params.items()}
        lr = self.lr
        self.trainer = P.Trainer(
            cfg=self.cfg, param_fn=self._param_fn,
            optimizer=lambda ps: torch.optim.Adam(ps, lr=lr),
            clip_norm=self.clip, mask_critical=self.mask)
        self.opt_state = self.trainer.init(self.params)
        self.beta1 = self.opt_state.optimizer.param_groups[0]["betas"][0]
        self.flat = []
        for img in images:
            flat, self.ys, self.xs = self.trainer.shard_target(img)
            self.flat.append(flat)
        self.losses, self.grads = [], []
        for k in range(self.n_check):
            self.item(k)

    def _state(self) -> dict:
        """Each leaf's value and Adam's moments and step count for it (an
        optimizer that kept no moment got no gradient yet)."""
        opt = self.opt_state.optimizer
        out = {}
        for n, p in self.params.items():
            s = opt.state.get(p, {})
            zero = torch.zeros_like(p)
            out[n] = {"p": p.detach().clone(),
                      "m": s["exp_avg"].clone() if "exp_avg" in s else zero,
                      "v": (s["exp_avg_sq"].clone() if "exp_avg_sq" in s
                            else zero),
                      "t": int(s["step"]) if "step" in s else 0}
        return out

    def item(self, k: int):
        t = k % len(self.targets)
        self.frame = self.targets[t]
        if self.tracing:
            self.traced.append((k, {n: p.detach().clone()
                                    for n, p in self.params.items()}))
        before = None
        if k < self.n_check:
            before = self._state()
        else:
            self.n_window += 1
            if self.rng.randrange(self.n_window) == 0:
                before = self._state()
        self.params, self.opt_state, loss = self.trainer.step(
            self.params, self.opt_state, self.flat[t], self.ys, self.xs,
            self._draws(10_000 + k))
        loss = float(loss)
        if before is None:
            return
        after = self._state()
        b1 = self.beta1
        # the gradient as the optimizer got it, from its first moment
        grad = {n: (after[n]["m"] - b1 * before[n]["m"]) / (1.0 - b1)
                for n in after}
        if k < self.n_check:
            self.losses.append(loss)
            self.grads.append(grad)
            if k == self.n_check - 1:
                self.change = {n: after[n]["p"] - self.p0[n] for n in after}
        else:
            self.window = {"k": k, "before": before, "loss": loss,
                           "grad": grad,
                           "change": {n: after[n]["p"] - before[n]["p"]
                                      for n in after}}

    def release(self):
        """Frees the program's state; what the check needs stays."""
        self.trainer = self.opt_state = self.flat = self.params = None
        self.scenes = None

    def _target(self, sc, rcfg, t: int, dtype):
        with torch.no_grad():
            return R.render_rgb(
                *sc.reference(sc.raw(self.targets[t], sc.truth())), rcfg,
                self._draws(20_000 + t, dtype))

    def _ref_step(self, sc, rcfg, k: int, params: dict, dtype):
        """The reference's loss and clipped gradients of step ``k`` at
        ``params``."""
        t = k % len(self.targets)
        frame = self.targets[t]
        loss, grads = R.step_loss_and_grads(
            lambda p: sc.reference(sc.raw(frame, p)), params, rcfg,
            self._target(sc, rcfg, t, dtype), self._draws(10_000 + k, dtype),
            self.mask, self._block_rows(), REF_SEGMENT)
        if self.clip is not None:
            grads = R.clip_by_global_norm(grads, self.clip)
        return loss, grads

    def reference_steps(self, dtype=torch.float32) -> dict:
        """The first ``checked_steps`` steps again by the plain reference,
        from the same start, targets' truth and draws (the losses, each
        step's clipped gradient, the parameters' change), and the window
        step again from the program's parameters and moments before it."""
        sc = self._ref_scenes(dtype)
        rcfg = sc.reference_render_config()
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in sc.start().items()}
        p0 = {k: v.detach().clone() for k, v in params.items()}
        adam = R.Adam(params, self.lr)
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
            adam = R.Adam(before, self.lr, state={
                n: (s["m"].to(dtype), s["v"].to(dtype), s["t"])
                for n, s in w["before"].items()})
            new = adam.step(before, g)
            out["window"] = {"loss": loss, "grad": g, "change": {
                n: new[n].detach() - before[n].detach() for n in new}}
        return out

    def _program(self) -> dict:
        out = {"losses": self.losses, "grads": self.grads,
               "grad": self.grads[0], "change": self.change}
        if self.window is not None:
            out["window"] = {k: self.window[k]
                             for k in ("loss", "grad", "change")}
        return out

    def numbers(self) -> dict:
        self.compared = (self._program(), self.reference_steps())
        return compare.fit_numbers(*self.compared)

    def control(self, dtype) -> dict:
        self.compared = (self.reference_steps(dtype), self.reference_steps())
        return compare.fit_numbers(*self.compared)

    def traced_rays(self):
        sc = self._ref_scenes(torch.float32)
        rcfg = sc.reference_render_config()
        for k, params in self.traced:
            frame = self.targets[k % len(self.targets)]
            scene, cam = sc.reference(sc.raw(frame, params))
            ys, xs = R.pixels(rcfg, self.device)
            env, s0 = R.initial_state(scene, cam, rcfg, ys, xs,
                                      self._draws(10_000 + k))
            yield env, rcfg["integrator"], s0
