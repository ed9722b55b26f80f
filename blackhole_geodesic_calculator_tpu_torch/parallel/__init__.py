"""Distributed layer: (samples, rays) meshes over torch.distributed ranks,
ray-sharded rendering with a load-balancing deal, sample-parallel
multisampling, and training steps with gradients averaged over the ranks
(PyTorch port of parallel/).  ``ray_sharding`` and ``replicated`` are not
ported: every rank holds the replicated values whole (mesh.py)."""

from .mesh import Mesh, make_mesh, RAY_AXIS, SAMPLE_AXIS
from .render import (polarization_map_sharded, render_image_sharded,
                     render_stokes_sharded)
from .train import Trainer, default_loss
from .multihost import (
    init_distributed, global_mesh, gather_image, render_shards_with_retry,
    render_with_failover,
)

__all__ = [
    "Mesh", "make_mesh", "RAY_AXIS", "SAMPLE_AXIS",
    "render_image_sharded", "polarization_map_sharded",
    "render_stokes_sharded",
    "Trainer", "default_loss",
    "init_distributed", "global_mesh", "gather_image",
    "render_shards_with_retry", "render_with_failover",
]
