"""PyTorch and CUDA port of blackhole_geodesic_calculator_tpu.

A second package beside the JAX one, which stays the reference.  It imports
``torch`` and never ``jax``.  It renders a Schwarzschild or Kerr hole
against an equirect sky, with a z = 0 accretion disk and textured or lit
spheres, and differentiates the image with respect to the mass, the spin,
the camera position, the textures and the sphere geometry: the camera, the
fixed-step RK4 integrator (hand-written CUDA kernels on the GPU, for the
forward and for the checkpointed forward and exact adjoint of the gradient;
plain PyTorch loops on the CPU) and the shading.
"""

from .camera.pinhole import Camera
from .ops.integrate import GeodesicEnv, IntegratorConfig, launch
from .render.renderer import RenderConfig, render_image
from .scene.scene import BlackHole, Disk, Lights, Scene, Spheres

__all__ = [
    "BlackHole", "Camera", "Disk", "GeodesicEnv", "IntegratorConfig",
    "Lights", "RenderConfig", "Scene", "Spheres", "launch", "render_image",
]
