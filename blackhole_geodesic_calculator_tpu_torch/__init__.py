"""PyTorch and CUDA port of blackhole_geodesic_calculator_tpu.

A second package beside the JAX one, which stays the reference.  It imports
``torch`` and never ``jax``.  This slice carries the forward render of a
Schwarzschild hole against an equirect sky: the camera, the fixed-step RK4
integrator (a hand-written CUDA kernel on the GPU, a plain PyTorch loop on
the CPU) and the sky shading.
"""

from .camera.pinhole import Camera
from .ops.integrate import GeodesicEnv, IntegratorConfig, launch
from .render.renderer import RenderConfig, render_image
from .scene.scene import BlackHole, Disk, Lights, Scene, Spheres

__all__ = [
    "BlackHole", "Camera", "Disk", "GeodesicEnv", "IntegratorConfig",
    "Lights", "RenderConfig", "Scene", "Spheres", "launch", "render_image",
]
