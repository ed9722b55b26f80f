"""Per-ray state and termination taxonomy (PyTorch port of ops/states.py).

Ray outcomes are a dense int32 status tensor carried through the integrator,
so classification is branchless; the codes are the JAX package's, value for
value, so statuses compare directly between the two packages.
"""

from __future__ import annotations

import dataclasses

import torch

# Status codes (order matters only for readability; comparisons are explicit).
ACTIVE = 0        # still integrating
CAPTURED = 1      # crossed the horizon -> black
ESCAPED = 2       # left the domain r > r_escape -> background lookup
BUDGET = 3        # affine budget exhausted
DISK = 4          # crossed the accretion-disk annulus
OBJECT = 5        # hit a scene sphere
INSIDE_HORIZON = 6  # ray *started* inside the horizon
ERROR = 7         # non-finite state: rendered as red


@dataclasses.dataclass
class RayState:
    """Structure-of-arrays state for a batch of rays; all leaves share (...,).

    x, p     : position / spatial covariant momentum, (..., 3) float32
    E        : conserved energy -p_t, set once by the null condition
    lam      : accumulated affine parameter
    status   : termination taxonomy above, int32
    hit_obj  : sphere index for OBJECT hits, else -1, int32
    """

    x: torch.Tensor
    p: torch.Tensor
    E: torch.Tensor
    lam: torch.Tensor
    status: torch.Tensor
    hit_obj: torch.Tensor

    @property
    def active(self) -> torch.Tensor:
        return self.status == ACTIVE


def init_state(x0: torch.Tensor, p0: torch.Tensor,
               E: torch.Tensor) -> RayState:
    batch = x0.shape[:-1]
    return RayState(
        x=x0,
        p=p0,
        E=E,
        lam=torch.zeros(batch, dtype=x0.dtype, device=x0.device),
        status=torch.zeros(batch, dtype=torch.int32, device=x0.device),
        hit_obj=torch.full(batch, -1, dtype=torch.int32, device=x0.device),
    )
