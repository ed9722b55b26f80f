"""Spacetime metric families (PyTorch port of models/__init__.py, without
the learned surrogate, which is not ported yet).

flat          -- Minkowski validation metric.
schwarzschild -- the reference's spacetime, two Cartesian charts.
kerr          -- spinning hole, Kerr-Schild form.
"""

from .metric import Metric
from .flat import flat_metric, ETA
from .schwarzschild import (
    schwarzschild_cartesian_metric,
    schwarzschild_ks_metric,
)
from .kerr import kerr_ks_metric, ks_radius, ks_scalars, horizon_radius

__all__ = [
    "Metric",
    "flat_metric",
    "ETA",
    "schwarzschild_cartesian_metric",
    "schwarzschild_ks_metric",
    "kerr_ks_metric",
    "ks_radius",
    "ks_scalars",
    "horizon_radius",
]
