"""Flat (Minkowski) metric, the validation backend (PyTorch port of
models/flat.py): geodesics through it are straight lines."""

from __future__ import annotations

import torch

from .metric import Metric

ETA = torch.diag(torch.tensor([-1.0, 1.0, 1.0, 1.0]))


def eta_like(x4: torch.Tensor) -> torch.Tensor:
    """ETA on the device and in the type of ``x4``."""
    return ETA.to(device=x4.device, dtype=x4.dtype)


def _g_flat(x4):
    return eta_like(x4).expand(x4.shape[:-1] + (4, 4))


def flat_metric() -> Metric:
    return Metric(g_fn=_g_flat, params=(), name="flat")
