"""Utilities: timing.  (The JAX package's ``trace``, ``annotate`` and
``device_memory_stats`` come from its XProf parser, utils/profiling.py,
which is not ported; ``torch.profiler`` takes its place.)"""

from .timing import PhaseTimers, benchmark, timed

__all__ = ["PhaseTimers", "timed", "benchmark"]
