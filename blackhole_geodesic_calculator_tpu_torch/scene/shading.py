"""Branchless shading (PyTorch port of scene/shading.py, sky scenes).

Each shader runs densely over the batch and a status-mask select composes
the final colour: escaped and budget rays look up the sky, captured and
inside-horizon rays are black, non-finite rays are red.  The disk and
sphere shaders are not ported yet and raise.
"""

from __future__ import annotations

import torch

from ..ops import states
from ..ops.states import RayState
from .scene import Scene
from .texture import sample_equirect

ERROR_COLOR = (1.0, 0.0, 0.0)   # rogue-ray colour
BLACK = (0.0, 0.0, 0.0)


def shade_background(scene: Scene, directions: torch.Tensor) -> torch.Tensor:
    """Equirect sky lookup; black when no sky is configured."""
    if scene.background is None:
        return torch.zeros(directions.shape[:-1] + (3,),
                           dtype=directions.dtype, device=directions.device)
    d = directions / torch.clamp_min(
        torch.linalg.norm(directions, dim=-1, keepdim=True), 1e-20)
    return sample_equirect(scene.background, d)


def shade(scene: Scene, s: RayState, end_dir: torch.Tensor) -> torch.Tensor:
    """Compose the final per-ray RGB from the termination taxonomy."""
    if scene.disk is not None or scene.spheres is not None:
        raise NotImplementedError(
            "disk and sphere shading are not ported yet; they come with the "
            "event variants of the integrator kernels")
    st = s.status
    color = shade_background(scene, end_dir)  # ESCAPED and BUDGET
    black = (st == states.CAPTURED) | (st == states.INSIDE_HORIZON)
    color = torch.where(black[..., None], color.new_tensor(BLACK), color)
    color = torch.where((st == states.ERROR)[..., None],
                        color.new_tensor(ERROR_COLOR), color)
    return color
