"""Timing instrumentation (PyTorch port of utils/timing.py).

Named accumulating wall-clock timers with a per-phase report, and timing
that waits for the card: CUDA launches return before the work is done,
so an unsynchronized timer measures the launch, not the work.  On the CPU
nothing is asynchronous and nothing is synchronized.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors anywhere in ``out`` (tensors,
    dataclasses, and lists, tuples and dicts of them)."""
    found = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                found.add(v.device)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif hasattr(v, "__dataclass_fields__"):
            for name in v.__dataclass_fields__:
                walk(getattr(v, name))

    walk(out)
    return found


def synchronize(out):
    """Wait for the card to finish the work behind every CUDA tensor in
    ``out``; returns ``out``."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)
    return out


class PhaseTimers:
    """Accumulating per-phase wall-clock timers with a report."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False):
        """Time the block; ``sync=True`` waits for the card's queued work
        (``torch.cuda.synchronize()``, where CUDA is initialised) before
        stopping the clock."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_available() and \
                    torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.total, key=self.total.get, reverse=True):
            t, n = self.total[name], self.count[name]
            lines.append(f"{name:24s} {t:8.3f}s total  {t / n * 1e3:8.2f}ms avg"
                         f"  x{n}")
        return "\n".join(lines)


def timed(fn, *args, sync=True, **kwargs):
    """(result, seconds), synchronizing the devices of the result's CUDA
    tensors before the clock stops."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync:
        out = synchronize(out)
    return out, time.perf_counter() - t0


def benchmark(fn, *args, warmup: int = 1, repeat: int = 5, **kwargs):
    """Best-of-N timing after warmup; returns (result, best_seconds)."""
    out = None
    for _ in range(warmup):
        out = synchronize(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(repeat):
        out, dt = timed(fn, *args, **kwargs)
        best = min(best, dt)
    return out, best
