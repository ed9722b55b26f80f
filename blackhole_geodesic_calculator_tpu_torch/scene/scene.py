"""Scene description -- pure data (PyTorch port of scene/scene.py).

Every physical quantity is a float32 tensor on the scene's device: the
black hole (Schwarzschild, or Kerr with a spin), the sky, a z = 0 accretion
disk, textured spheres and point lights.  A spun hole renders through the
Kerr variants of the integrator kernels (pallas_kernel.py:1377-1379,
:1619-1621) on the GPU and the plain Kerr step loop on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def _f(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass
class BlackHole:
    """mass (r_s = 2M, geometrized), Kerr spin a (None = Schwarzschild) and
    world location."""

    mass: Any
    loc: Any
    spin: Any = None

    @classmethod
    def make(cls, mass=0.5, loc=(0.0, 0.0, 0.0), spin=None, device=None):
        return cls(mass=_f(mass, device), loc=_f(loc, device),
                   spin=None if spin is None else _f(spin, device))


@dataclasses.dataclass
class Disk:
    """z = 0 annulus accretion disk with a Gaussian radial profile."""

    r_in: Any
    r_out: Any
    phase: Any
    mean: Any
    stddev: Any
    intensity: Any
    texture: Any  # (H, W, 3)
    beaming: Any = None
    orbit_dir: Any = None  # +1 prograde (default), -1 retrograde
    pol_frac: Any = None

    @classmethod
    def make(cls, r_in, r_out, texture, phase=0.0, mean=0.5, stddev=0.2,
             intensity=1.0, beaming=None, orbit_dir=1.0, pol_frac=None,
             device=None):
        f = lambda v: _f(v, device)  # noqa: E731
        return cls(r_in=f(r_in), r_out=f(r_out), phase=f(phase),
                   mean=f(mean), stddev=f(stddev), intensity=f(intensity),
                   texture=f(texture),
                   beaming=None if beaming is None else f(beaming),
                   orbit_dir=f(orbit_dir),
                   pol_frac=None if pol_frac is None else f(pol_frac))


@dataclasses.dataclass
class Spheres:
    """K textured/emissive spheres."""

    center: Any          # (K, 3)
    radius: Any          # (K,)
    emission: Any        # (K,) float 0/1 mask
    albedo: Any          # (K, 3) base color for the Lambert branch
    texture: Any         # (K, Ht, Wt, 3) emission textures (stacked)

    @classmethod
    def make(cls, center, radius, texture, emission=None, albedo=None,
             device=None):
        center = _f(center, device)
        k = center.shape[0]
        if emission is None:
            emission = torch.ones((k,), dtype=torch.float32, device=device)
        if albedo is None:
            albedo = torch.ones((k, 3), dtype=torch.float32, device=device)
        return cls(center=center, radius=_f(radius, device),
                   emission=_f(emission, device), albedo=_f(albedo, device),
                   texture=_f(texture, device))


@dataclasses.dataclass
class Lights:
    """Point lamps for the Lambertian branch."""

    position: Any    # (L, 3)
    intensity: Any   # scalar

    @classmethod
    def make(cls, position, intensity=10.0, device=None):
        return cls(position=_f(position, device),
                   intensity=_f(intensity, device))


@dataclasses.dataclass
class Scene:
    """Full scene; None fields disable features."""

    bh: BlackHole
    background: Any = None       # (H, W, 3) equirect sky or None
    disk: Disk | None = None
    spheres: Spheres | None = None
    lights: Lights | None = None
