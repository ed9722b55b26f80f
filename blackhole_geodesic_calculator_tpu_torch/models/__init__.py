"""Spacetime metric families and the learned surrogate (PyTorch port of
models/__init__.py).

flat          -- Minkowski validation metric.
schwarzschild -- the reference's spacetime, two Cartesian charts.
kerr          -- spinning hole, Kerr-Schild form.
surrogate     -- the learned (MLP) scattering map of the Gen-1 hybrid's
                 approx path, trained against the live integrator.
"""

from .metric import Metric
from .flat import flat_metric, ETA
from .schwarzschild import (
    schwarzschild_cartesian_metric,
    schwarzschild_ks_metric,
)
from .kerr import kerr_ks_metric, ks_radius, ks_scalars, horizon_radius
from .surrogate import (
    SurrogateConfig,
    NeuralSurrogate,
    train_surrogate,
    evaluate_surrogate,
    save_surrogate,
    load_surrogate,
)

__all__ = [
    "SurrogateConfig",
    "NeuralSurrogate",
    "train_surrogate",
    "evaluate_surrogate",
    "save_surrogate",
    "load_surrogate",
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
