"""States, geodesic right-hand sides, the integrator, its hand-written
adjoint and its CUDA kernels."""
