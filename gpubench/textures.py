"""The benchmark's textures, made from the run's seed on the device.

Procedural stand-ins of the three kinds the examples name (scene/
textures.py's registry: a starfield over a faint nebula, disk clouds with
contrast and tint, a cratered moon), drawn by a ``torch.Generator`` on the
device in a few large calls.  They are inputs: both the program and the
reference get the same tensors.  One seed gives one set of textures; every
seed gives textures of the same size, so the work of a frame does not
depend on it beyond the pixels' colours.
"""

from __future__ import annotations

import math

import torch

# The registry's names and what they are made of (scene/textures.py).
KINDS = {
    "background": {"kind": "stars"},
    "moon": {"kind": "moon"},
    "disk_clouds_high_contr_color1": {"kind": "clouds", "contrast": 2.0,
                                      "tint": (1.0, 0.6, 0.25)},
}


def _generator(seed: int, salt: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (2**63))
    return g


def _smooth_noise(h, w, octaves, gen, device):
    """Seamless value noise in [0, 1]: a sum of random Fourier modes, three
    per octave, halving in amplitude."""
    n = 3 * octaves
    k = 2 ** (torch.arange(octaves, device=device).repeat_interleave(3) + 1)
    u = torch.rand((n, 3), generator=gen, device=device)
    ky = 1 + torch.floor(u[:, 0] * k)
    kx = 1 + torch.floor(u[:, 1] * k)
    ph = 2.0 * math.pi * u[:, 2]
    amp = 0.5 ** torch.arange(octaves, device=device).repeat_interleave(3)
    yy = (torch.arange(h, device=device) / h)[None, :, None]
    xx = (torch.arange(w, device=device) / w)[None, None, :]
    v = torch.zeros((h, w), device=device)
    for i in range(n):   # one mode at a time: (h, w) at most in memory
        v += amp[i] * torch.sin(2.0 * math.pi * (ky[i] * yy[0] + kx[i] * xx[0])
                                + ph[i])
    v -= v.min()
    return v / torch.clamp_min(v.max(), 1e-9)


def make(name: str, seed: int, device, size=(512, 1024)) -> torch.Tensor:
    """The (H, W, 3) float32 texture ``name`` for ``seed`` on ``device``."""
    spec = KINDS[name]
    h, w = size
    gen = _generator(seed, sum(map(ord, name)), device)
    if spec["kind"] == "stars":
        img = 0.02 * _smooth_noise(h, w, 3, gen, device)[..., None].expand(
            h, w, 3).clone()
        n = h * w // 150
        flat = torch.randint(0, h * w, (n,), generator=gen, device=device)
        mag = torch.rand((n,), generator=gen, device=device) ** 0.25
        tint = 0.7 + 0.3 * torch.rand((n, 3), generator=gen, device=device)
        img = img.reshape(h * w, 3)
        img.scatter_reduce_(0, flat[:, None].expand(n, 3), mag[:, None] * tint,
                            reduce="amax")
        return torch.clamp(img.reshape(h, w, 3), 0.0, 1.0).contiguous()
    if spec["kind"] == "moon":
        base = 0.35 + 0.3 * _smooth_noise(h, w, 5, gen, device)
        craters = _smooth_noise(h, w, 6, gen, device)
        base = base - 0.25 * (craters > 0.75) * (craters - 0.75) * 4.0
        g = torch.clamp(base, 0.0, 1.0)
        return torch.stack([g, g, g * 0.95], -1).contiguous()
    v = _smooth_noise(h, w, 6, gen, device)
    v = torch.clamp(0.5 + (v - 0.5) * spec["contrast"], 0.0, 1.0)
    return (v[..., None] * torch.tensor(spec["tint"], device=device)
            ).contiguous()
