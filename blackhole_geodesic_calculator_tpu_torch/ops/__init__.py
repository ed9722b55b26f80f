"""States, geodesic right-hand sides, the integrator and its CUDA kernel."""
