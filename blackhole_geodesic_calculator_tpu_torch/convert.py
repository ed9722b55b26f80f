"""Carry scenes, cameras, configs, metrics and surrogate tables over from
the JAX package.

Each function takes the JAX package's object -- or the same dataclass tree
with numpy leaves -- walks ``dataclasses.fields`` and builds this package's
twin: every array leaf is copied into a float32 numpy array and then goes
through ``torch.as_tensor(..., device=device)`` -- the card unless the
caller passes ``device="cpu"`` -- and ``None`` stays ``None``.  A metric
holds closures, so it is rebuilt by its name from its parameters; a
surrogate table keeps its ``captured`` flags boolean; a learned surrogate
keeps its precision.  numpy reads a JAX
array without importing JAX, so this module never imports it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .camera.pinhole import Camera
from .models import (Metric, NeuralSurrogate, flat_metric, kerr_ks_metric,
                     schwarzschild_cartesian_metric, schwarzschild_ks_metric)
from .ops.integrate import IntegratorConfig
from .render.limited import LimitedConfig, SurrogateTable
from .render.renderer import RenderConfig
from .scene.scene import (BlackHole, Disk, Lights, Scene, Spheres,
                          on_device)

# The reference's integrator backends and their counterparts here.
_BACKENDS = {"auto": "auto", "pallas": "cuda", "scan": "torch"}

# The reference's metric families by name: each builds from its params.
_METRICS = {"flat": flat_metric,
            "schwarzschild": schwarzschild_cartesian_metric,
            "schwarzschild_ks": schwarzschild_ks_metric,
            "kerr_ks": kerr_ks_metric}

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


def metric_from_reference(obj, device=None) -> Metric:
    """The metric of the reference's name, its params float32 tensors on
    ``device`` (the card unless the caller names another).  A generic
    metric (a closure of the caller's) has no twin and raises."""
    make = _METRICS.get(obj.name)
    if make is None:
        raise TypeError(f"no PyTorch twin for the metric {obj.name!r}; "
                        f"known: {sorted(_METRICS)}")
    return make(*(_tree(p, on_device(device)) for p in obj.params))


def limited_config_from_reference(obj) -> LimitedConfig:
    """The Gen-1 renderer's settings, field for field."""
    return LimitedConfig(**{f.name: getattr(obj, f.name)
                            for f in dataclasses.fields(LimitedConfig)})


def surrogate_table_from_reference(obj, device=None) -> SurrogateTable:
    """The scattering table on ``device`` (the card unless the caller
    names another): b, end_loc and end_dir float32, captured bool."""
    device = on_device(device)
    return SurrogateTable(
        b=_tree(obj.b, device), end_loc=_tree(obj.end_loc, device),
        end_dir=_tree(obj.end_dir, device),
        captured=torch.as_tensor(np.array(obj.captured, dtype=bool),
                                 device=device))


def surrogate_from_reference(obj, device=None) -> NeuralSurrogate:
    """The learned surrogate on ``device`` (the card unless the caller
    names another): its (W, b) pairs, mass, spin, influence and exit radii
    (1.1 R where the reference's is None) float32, its precision kept."""
    device = on_device(device)
    return NeuralSurrogate(
        [(_tree(w, device), _tree(b, device)) for w, b in obj.params],
        mass=_tree(obj.mass, device), spin=_tree(obj.spin, device),
        r_influence=_tree(obj.r_influence, device),
        r_exit=None if obj.r_exit is None else _tree(obj.r_exit, device),
        precision=obj.precision)
