"""States, geodesic right-hand sides, the integrator, its hand-written
adjoint and its CUDA kernels (``cuda_kernel``, built at first launch).

The integrator's dispatch ``integrate`` is not exported here, unlike the
JAX package's: ``from ...ops import integrate`` names the module."""

from . import states
from .geodesic import (
    hamiltonian,
    kerr_rhs,
    null_init,
    schwarzschild_rhs,
    timelike_init,
    xdot,
)
from .integrate import (
    DiskGeom,
    GeodesicEnv,
    IntegratorConfig,
    SphereGeom,
    dopri_step,
    final_direction,
    integrate_adaptive,
    integrate_adaptive_scan,
    integrate_fixed,
    integrate_fixed_fast,
    launch,
    rk4_step,
    trajectory,
)
from .states import RayState, init_state

__all__ = [
    "DiskGeom", "GeodesicEnv", "IntegratorConfig", "RayState", "SphereGeom",
    "dopri_step", "final_direction", "hamiltonian", "init_state",
    "integrate_adaptive", "integrate_adaptive_scan",
    "integrate_fixed", "integrate_fixed_fast", "kerr_rhs", "launch",
    "null_init", "rk4_step", "schwarzschild_rhs", "states", "timelike_init",
    "trajectory", "xdot",
]
