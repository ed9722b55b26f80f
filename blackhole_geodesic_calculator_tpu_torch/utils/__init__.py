"""Utilities: timing, profiling, observability."""

from .timing import PhaseTimers, benchmark, timed
from .profiling import (trace, annotate, device_memory_stats,
                        profile_steps, op_table, format_op_table)

__all__ = ["PhaseTimers", "timed", "benchmark", "trace", "annotate",
           "device_memory_stats"]
