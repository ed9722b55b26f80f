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
gradient; plain PyTorch loops on the CPU.  It also renders the Stokes Q
and U of a polarized disk (``render_stokes``), maps the rotation of the
polarization along each ray (``polarization_map``: the closed form for
Schwarzschild, the parallel-transport ODE of the ``models`` metrics for
Kerr), and renders with the Gen-1 hybrid (``render_limited``: curved
space only inside a sphere of influence, through a ``SurrogateTable`` or
a ``NeuralSurrogate``, the MLP ``train_surrogate`` fits to the live
integrator).  ``parallel`` splits renders over the ranks of a
torch.distributed group and fits scene parameters to target images
(``Trainer``), and ``io_`` checkpoints a training run.  The host
surfaces: ``io_.config`` builds scenes from the JSON configs of
examples/, ``scene.textures`` names the textures, ``native`` is the C++
runtime (the float64 oracle, PNG/PFM IO, the async ``FrameWriter``),
``compat`` the curvedpy-compatible API and ``cli`` the ``bhgc-torch``
command line.
"""

# models before ops: the surrogate imports the integrator, whose modules
# import models.kerr
from .models.surrogate import (NeuralSurrogate, SurrogateConfig,
                               train_surrogate)
from .camera.pinhole import Camera
from .ops.integrate import GeodesicEnv, IntegratorConfig, launch
from .parallel import Trainer, render_image_sharded
from .render.limited import LimitedConfig, SurrogateTable, render_limited
from .render.renderer import (RenderConfig, polarization_map,
                              polarization_rays, render_image,
                              render_image_u8, render_progressive,
                              render_stokes, stokes_rays)
from .scene.scene import BlackHole, Disk, Lights, Scene, Spheres

__all__ = [
    "BlackHole", "Camera", "Disk", "GeodesicEnv", "IntegratorConfig",
    "LimitedConfig", "Lights", "NeuralSurrogate", "RenderConfig", "Scene",
    "Spheres", "SurrogateConfig", "SurrogateTable", "Trainer", "launch",
    "polarization_map", "polarization_rays", "render_image",
    "render_image_sharded", "render_image_u8", "render_limited",
    "render_progressive", "render_stokes", "stokes_rays", "train_surrogate",
]
