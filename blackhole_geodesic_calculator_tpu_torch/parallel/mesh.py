"""The (samples, rays) mesh over the ranks of a torch.distributed group
(PyTorch port of parallel/mesh.py).

A mesh lays the ranks of the default process group out samples-major:
rank i of the mesh sits at (i // rays, i % rays).  Ranks that share a ray
coordinate render different multisample jitters of the same pixels and
average them (an ``all_reduce`` over the sample group); ranks that share a
sample coordinate render different pixels and gather them (an
``all_gather`` over the ray group).  Without an initialised group the mesh
is this process alone, 1 x 1.

The JAX module's ``ray_sharding``, ``replicated`` and ``put_global`` have
no counterpart: they place one global array's shards on the devices of a
mesh, and here there is no global array.  Every rank holds the full
replicated values (scene, camera, parameters) and computes its own ray
slots, so nothing is placed.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch.distributed as dist

SAMPLE_AXIS = "samples"
RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``ranks`` laid out (samples, rays), samples-major, and this rank's
    sample and ray groups (None where the axis has extent 1 or spans the
    whole default group, whose collectives need no group)."""

    samples: int
    rays: int
    ranks: tuple[int, ...]
    sample_group: Any = None
    ray_group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return {SAMPLE_AXIS: self.samples, RAY_AXIS: self.rays}

    @property
    def size(self) -> int:
        return len(self.ranks)

    def coords(self) -> tuple[int, int]:
        """This process's (sample, ray) coordinates: (0, 0) on a 1 x 1
        mesh, which is always this process alone."""
        if self.size == 1:
            return 0, 0
        if not dist.is_initialized() or dist.get_world_size() != self.size:
            raise RuntimeError(
                f"a mesh of {self.size} ranks needs torch.distributed "
                "initialised with them (parallel.init_distributed)")
        i = self.ranks.index(dist.get_rank())
        return i // self.rays, i % self.rays


def _group(ranks: list[int]):
    """A process group of ``ranks``; None for the whole default group.
    Every rank of the default group must call this, in the same order."""
    if len(ranks) == dist.get_world_size():
        return None
    return dist.new_group(ranks)


def make_mesh(devices=None, sample_parallel: int = 1) -> Mesh:
    """Mesh over the ranks ``devices`` (default: every rank of the default
    group, or this process alone without one), shaped (samples, rays).

    ``sample_parallel`` ranks cooperate on different multisample jitters
    of the same pixels; the rest split the pixels.  A mesh of several ranks
    spans the whole default group, and every rank must call this with the
    same arguments: it creates the sample and ray groups, collectively.  A
    mesh of one rank is this process alone, whatever the group."""
    if devices is None:
        devices = (range(dist.get_world_size()) if dist.is_initialized()
                   else [0])
    ranks = tuple(int(r) for r in devices)
    n = len(ranks)
    if n % sample_parallel != 0:
        raise ValueError(
            f"sample_parallel={sample_parallel} must divide device count {n}")
    rays = n // sample_parallel
    if n == 1 or not dist.is_initialized():
        return Mesh(sample_parallel, rays, ranks)
    if sorted(ranks) != list(range(dist.get_world_size())):
        raise ValueError(f"a mesh of several ranks spans the default group "
                         f"of {dist.get_world_size()}; got ranks {ranks}")
    i = ranks.index(dist.get_rank())
    me_s, me_r = i // rays, i % rays
    sample_group = ray_group = None
    # every rank creates every group, in the same order
    for s in range(sample_parallel if rays > 1 else 0):
        g = _group([ranks[s * rays + r] for r in range(rays)])
        if s == me_s:
            ray_group = g
    for r in range(rays if sample_parallel > 1 else 0):
        g = _group([ranks[s * rays + r] for s in range(sample_parallel)])
        if r == me_r:
            sample_group = g
    return Mesh(sample_parallel, rays, ranks, sample_group, ray_group)
