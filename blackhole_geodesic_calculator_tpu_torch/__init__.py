"""PyTorch and CUDA port of blackhole_geodesic_calculator_tpu.

A second package beside the JAX one, which stays the reference.  It imports
``torch`` and never ``jax``.  It renders a Schwarzschild or Kerr hole
against an equirect sky, with a z = 0 accretion disk and textured or lit
spheres, at one sample per pixel or multisampled with jittered rays, as
float or on-device quantized uint8 frames (``render_image_u8``, written by
``io_.write_png``) or progressively; and it differentiates the image with
respect to the mass, the spin, the camera position, the textures and the
sphere geometry.  Photons and massive particles (``launch(...,
time_like=True)``) go through the fixed-step RK4 or adaptive
Dormand-Prince integrators: hand-written CUDA kernels on the GPU, for the
forward and for the checkpointed forward and exact adjoint of the
gradient; plain PyTorch loops on the CPU.
"""

from .camera.pinhole import Camera
from .ops.integrate import GeodesicEnv, IntegratorConfig, launch
from .render.renderer import (RenderConfig, render_image, render_image_u8,
                              render_progressive)
from .scene.scene import BlackHole, Disk, Lights, Scene, Spheres

__all__ = [
    "BlackHole", "Camera", "Disk", "GeodesicEnv", "IntegratorConfig",
    "Lights", "RenderConfig", "Scene", "Spheres", "launch", "render_image",
    "render_image_u8", "render_progressive",
]
