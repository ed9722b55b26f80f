"""A closed loop of forward frames of the configuration's animation: frame
f is ``render_image_u8`` of frame f's scene and camera on frame f's
jitter draws, copied to the host; the next frame is asked for once it is
there.  The check compares a sample of the window's frames, drawn from
the seed, with the reference's frames from the same inputs."""

from __future__ import annotations

import random

import torch

from .. import compare
from ..reference import render as R
from .base import Loop as _Base


class Loop(_Base):
    unit = "frame"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.cycle = self.scenes.n_frames()
        self.first = 0
        self.tonemap = bool(self.config["animation"].get("tonemap", False))
        self.n_check = int(self.traffic.get("check_frames", 2))
        self.rng = random.Random(self.seed)
        self.kept = []          # a sample of (frame, host uint8 image)

    def _render(self, frame: int) -> torch.Tensor:
        import blackhole_geodesic_calculator_tpu_torch as P

        scene, cam = self.scenes.port(self.scenes.raw(frame))
        u8 = P.render_image_u8(scene, cam, self.cfg,
                               draws=self._draws(frame),
                               tonemap=self.tonemap)
        return u8.cpu()

    def setup(self):
        for f in range(int(self.traffic.get("warmup_frames", 2))):
            self._render(f)

    def item(self, i: int):
        frame = i % self.scenes.n_frames()
        if self.tracing:
            self.traced.append(frame)
        host = self._render(frame)
        # a uniform sample of the window's frames, drawn from the seed
        if len(self.kept) < self.n_check:
            self.kept.append((frame, host))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.n_check:
                self.kept[j] = (frame, host)

    def release(self):
        self.scenes = None

    def reference_frame(self, frame: int, dtype=torch.float32):
        sc = self._ref_scenes(dtype)
        scene, cam = sc.reference(sc.raw(frame))
        with torch.no_grad():
            rgb = R.render_rgb(scene, cam, sc.reference_render_config(),
                               self._draws(frame, dtype))
        return R.to_u8(rgb, self.tonemap).cpu()

    def numbers(self) -> dict:
        out = {}
        for frame, host in self.kept:
            got = compare.frame_numbers(host, self.reference_frame(frame))
            for k, v in got.items():
                out[k] = max(out.get(k, 0.0), v)
        return out

    def control(self, dtype) -> dict:
        """The reference in ``dtype`` in the program's place, on the frames
        that the window kept."""
        out = {}
        for frame, _ in self.kept:
            got = compare.frame_numbers(self.reference_frame(frame, dtype),
                                        self.reference_frame(frame))
            for k, v in got.items():
                out[k] = max(out.get(k, 0.0), v)
        return out

    def traced_rays(self):
        sc = self._ref_scenes(torch.float32)
        rcfg = sc.reference_render_config()
        for frame in self.traced:
            scene, cam = sc.reference(sc.raw(frame))
            ys, xs = R.pixels(rcfg, self.device)
            env, s0 = R.initial_state(scene, cam, rcfg, ys, xs,
                                      self._draws(frame))
            yield env, rcfg["integrator"], s0
