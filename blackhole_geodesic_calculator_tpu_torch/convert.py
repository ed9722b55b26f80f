"""Carry scenes, cameras and render configs over from the JAX package.

Each function takes the JAX package's object -- or the same dataclass tree
with numpy leaves -- walks ``dataclasses.fields`` and builds this package's
twin: every array leaf is copied into a float32 numpy array and then goes
through ``torch.as_tensor(..., device=device)`` -- the card unless the
caller passes ``device="cpu"`` -- and ``None`` stays ``None``.  numpy
reads a JAX array without importing JAX, so this module never imports it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .camera.pinhole import Camera
from .ops.integrate import IntegratorConfig
from .render.renderer import RenderConfig
from .scene.scene import (BlackHole, Disk, Lights, Scene, Spheres,
                          on_device)

# The reference's integrator backends and their counterparts here.
_BACKENDS = {"auto": "auto", "pallas": "cuda", "scan": "torch"}

_TWINS = {cls.__name__: cls
          for cls in (Scene, BlackHole, Disk, Spheres, Lights, Camera)}


def _tree(obj, device):
    """Dataclass tree with array leaves -> the same tree of float32 tensors."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        cls = _TWINS.get(type(obj).__name__)
        if cls is None:
            raise TypeError(f"no PyTorch twin for {type(obj).__name__}")
        return cls(**{f.name: _tree(getattr(obj, f.name), device)
                      for f in dataclasses.fields(obj)})
    # np.array copies: a JAX array reads as a read-only buffer, which the
    # tensor must not alias
    return torch.as_tensor(np.array(obj, dtype=np.float32), device=device)


def scene_from_reference(obj, device=None) -> Scene:
    """The scene on ``device``: the card unless the caller names another."""
    return _tree(obj, on_device(device))


def camera_from_reference(obj, device=None) -> Camera:
    """The camera on ``device``: the card unless the caller names another."""
    return _tree(obj, on_device(device))


def render_config_from_reference(obj) -> RenderConfig:
    """RenderConfig from the reference's; its integrator backend maps
    'pallas' -> 'cuda', 'scan' -> 'torch' and 'auto' -> 'auto'."""
    it = obj.integrator
    integ = IntegratorConfig(**{
        f.name: getattr(it, f.name)
        for f in dataclasses.fields(IntegratorConfig)})
    integ = dataclasses.replace(integ, backend=_BACKENDS[integ.backend])
    fields = {f.name: getattr(obj, f.name)
              for f in dataclasses.fields(RenderConfig)}
    fields["integrator"] = integ
    return RenderConfig(**fields)
