"""Multi-process execution and failure recovery (PyTorch port of
parallel/multihost.py).

* ``init_distributed`` -- ``torch.distributed.init_process_group``, NCCL
  on a host with CUDA and gloo without, so the same script runs as one
  process or as N ranks;
* ``global_mesh`` -- the (samples, rays) mesh over every rank;
* ``gather_image`` -- each rank's part of a framebuffer gathered on every
  rank;
* ``render_shards_with_retry`` and ``render_with_failover`` -- fault
  tolerance by construction: a render is a pure function of (scene,
  camera, pixel coordinates, draws), so a failed shard or frame is simply
  rendered again, and the image does not depend on how often it failed.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join the default process group; False (a no-op) for one process.

    ``coordinator_address`` is rank 0's ``host:port`` (or a ``tcp://``
    URL); with no arguments the group comes from the environment that
    torchrun sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), and
    without it this is the single-process no-op.  Safe to call twice; a
    second call with another world size raises."""
    if num_processes is not None and num_processes <= 1:
        return False
    if dist.is_initialized():
        have = dist.get_world_size()
        if num_processes is not None and num_processes != have:
            raise RuntimeError(
                f"torch.distributed already initialized with "
                f"num_processes={have}; refusing conflicting request "
                f"num_processes={num_processes}")
        return True
    if coordinator_address is None and num_processes is None and (
            process_id is None):
        env = os.environ
        if not all(k in env for k in ("MASTER_ADDR", "MASTER_PORT",
                                      "WORLD_SIZE", "RANK")):
            return False
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        if world <= 1:
            return False
        init_method = "env://"
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("init_distributed needs coordinator_address, "
                             "num_processes and process_id together")
        world, rank = int(num_processes), int(process_id)
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    return True


def global_mesh(sample_parallel: int = 1) -> Mesh:
    """(samples, rays) mesh over every rank (every rank calls this with
    the same arguments)."""
    return make_mesh(sample_parallel=sample_parallel)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def gather_image(local_part, axis: int = 0) -> np.ndarray:
    """Every rank's ``local_part`` concatenated along ``axis`` in rank
    order, on every rank, as a numpy array (one process: its own part)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return _host(local_part)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, _host(local_part))
    return np.concatenate(parts, axis=axis)


def render_shards_with_retry(
    render_shard: Callable[[int], np.ndarray],
    n_shards: int,
    max_retries: int = 2,
    backoff_s: float = 1.0,
    on_event: Callable[[str], None] | None = None,
) -> list[np.ndarray]:
    """``render_shard(i)`` for every shard, each retried up to
    ``max_retries`` times after ``backoff_s`` x attempt seconds; a shard
    still failing raises (fail-stop beats a silently black tile).  The
    shard must be a pure function of its index, so a retried shard gives
    the same pixels."""
    log = on_event or (lambda msg: None)
    out: list[np.ndarray] = []
    for i in range(n_shards):
        attempt = 0
        while True:
            try:
                out.append(_host(render_shard(i)))
                break
            except Exception as e:  # noqa: BLE001 -- retry any shard fault
                attempt += 1
                log(f"shard {i} attempt {attempt} failed: {e!r}")
                if attempt > max_retries:
                    raise
                time.sleep(backoff_s * attempt)
    return out


def _live_ranks() -> list[int]:
    return (list(range(dist.get_world_size())) if dist.is_initialized()
            else [0])


def render_with_failover(scene, cam, cfg, mesh: Mesh | None = None,
                         draws: torch.Tensor | None = None,
                         max_retries: int = 2, backoff_s: float = 1.0,
                         on_event: Callable[[str], None] | None = None,
                         probe: Callable[[], list] | None = None):
    """``render_image_sharded`` with rank-loss failover.

    A failed frame is retried on the same mesh after ``backoff_s`` x
    attempt seconds (a transient fault); when ``probe`` -- the live ranks,
    by default every rank of the group -- no longer matches the mesh's,
    the mesh drops to 1 x 1, this rank alone, and renders the whole frame
    (the same pixels: the render is a pure function of its inputs).  After
    ``max_retries`` failed retries the fault is raised."""
    from . import render as _render

    log = on_event or (lambda msg: None)
    probe = probe or _live_ranks
    if mesh is None:
        mesh = make_mesh()
    attempt = 0
    while True:
        try:
            return _render.render_image_sharded(scene, cam, cfg, mesh=mesh,
                                                draws=draws)
        except Exception as e:  # noqa: BLE001 -- any rank/runtime fault
            attempt += 1
            log(f"render on {mesh.size}-rank mesh failed (attempt "
                f"{attempt}): {e!r}")
            if attempt > max_retries:
                raise
            time.sleep(backoff_s * attempt)
            alive = list(probe())
            if alive and {str(r) for r in alive} != {
                    str(r) for r in mesh.ranks}:
                me = dist.get_rank() if dist.is_initialized() else 0
                log(f"mesh reconfigured: {mesh.size} -> 1 rank "
                    f"({len(alive)} alive)")
                mesh = make_mesh([me])
