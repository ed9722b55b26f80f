"""What the loops share: the configuration's scenes, the program's render
config, the jitter draws and the reference's blocks."""

from __future__ import annotations

import torch

from ..scenes import Scenes, draws

# Rays a block of the reference's gradient, and steps a checkpointed piece
# of its loop: what keeps autograd through a 1024^2 x 5-sample frame
# within the card's memory.
REF_BLOCK_RAYS = 1 << 20
REF_SEGMENT = 16


class Loop:
    def __init__(self, cell: dict, seed: int, device):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.traffic = cell["traffic"]
        self.config = cell["config"]
        self.scenes = Scenes(self.config, seed, device)
        self.samples = int(self.config["scene"].get("samples", 1))
        self.cfg = self.scenes.port_render_config()
        self.tracing = False
        self.traced = []
        self.gen = None

    def _draws(self, key: int, dtype=torch.float32):
        if self.samples == 1:
            return None
        if self.gen is None:
            self.gen = torch.Generator(device=self.device)
        return draws(self.gen, self.seed, key, (
            self.samples, 2, self.cfg.height, self.cfg.width), dtype)

    def _block_rows(self) -> int:
        return max(1, REF_BLOCK_RAYS // (self.cfg.width * self.samples))

    def _ref_scenes(self, dtype) -> Scenes:
        return Scenes(self.config, self.seed, self.device, dtype)
