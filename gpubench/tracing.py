"""The traced run: ``torch.profiler`` over the traced items, its Chrome
trace read back, and the record the per-layer metrics read.

Device work is the trace's kernels, memcpys and memsets (CUPTI's records
on the card).  The traced window runs from the start of the first item's
span to the end of the last's; each item ends with its result on the host,
so the device's work of an item lies inside it.  The trace file goes to
the run's temporary directory and is deleted once read.
"""

from __future__ import annotations

import collections
import functools
import importlib.util
import json
import os
import re
import tempfile
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
ITEM_SPAN = "gpubench.item"
PROGRAM = "blackhole_geodesic_calculator_tpu_torch"


def kernel_name(name: str) -> str:
    """A kernel's name without return type, anonymous namespace, template
    arguments and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.strip()


@functools.cache
def program_kernels() -> frozenset:
    """The names of the program's own kernels: the ``__global__`` functions
    of its CUDA sources and the ``triton.jit`` functions of its Python
    ones, read as text."""
    spec = importlib.util.find_spec(PROGRAM)
    root = Path(spec.origin).parent
    names = set()
    for path in list(root.rglob("*.cu")) + list(root.rglob("*.cuh")):
        names |= set(re.findall(
            r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(?:void\s+)?(\w+)\s*\(", path.read_text(errors="ignore")))
    for path in root.rglob("*.py"):
        names |= set(re.findall(r"@triton\.jit[^\n]*\n\s*def\s+(\w+)",
                                path.read_text(errors="ignore")))
    return frozenset(names)


class Profiler:
    """Starts ``torch.profiler`` on the CPU and the card; ``stop()``
    writes the trace under the temporary directory, reads it and deletes
    it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> list:
        self.prof.stop()
        fd, path = tempfile.mkstemp(prefix="gpubench_", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.unlink(path)


class Record:
    """What one traced run saw: the device's events and the host's inside
    the traced window, the number of items, and the loop (for the work of
    the rooflines)."""

    def __init__(self, events: list, n_items: int, loop):
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("name") == ITEM_SPAN
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise RuntimeError("the trace holds no item span")
        self.t0 = min(float(e["ts"]) for e in spans)
        self.t1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
        self.n_items, self.loop = n_items, loop
        self.device, self.host = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            if ts + dur <= self.t0 or ts >= self.t1:
                continue
            if e.get("cat") in DEVICE_CATS:
                name = (kernel_name(e["name"]) if e["cat"] == "kernel"
                        else e["cat"])
                self.device.append((name, e["cat"], ts, dur))
            elif e.get("cat") in HOST_CATS and e["name"] != ITEM_SPAN:
                self.host.append((e["name"], ts, dur))
        self.device.sort(key=lambda d: d[2])
        self._replay = self._replayed = None

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> list:
        """The union of the device's events, clipped to the window."""
        out = []
        for _, _, ts, dur in self.device:
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def launches(self) -> int:
        return len(self.device)

    def kernel_us(self, name: str) -> float:
        return sum(d for n, c, _, d in self.device
                   if c == "kernel" and n == name)

    def library_kernel_us(self) -> float:
        """Device time of the kernels that are not the program's own."""
        own = program_kernels()
        return sum(d for n, c, _, d in self.device
                   if c == "kernel" and n not in own)

    def replay(self):
        """The reference's loop over the traced rays, counted (once)."""
        if not self._replayed:
            from .work import _common

            self._replay = _common.replay(self.loop.traced_rays())
            self._replayed = True
        return self._replay

    def roofline(self, work_module) -> float | None:
        """Percent of the kernel's traced device time that its bound
        needs; None where the kernel did not run."""
        us = self.kernel_us(work_module.KERNEL)
        rep = self.replay() if us > 0 else None
        if rep is None:
            return None
        from .work._common import bound_ms

        ops, nbytes = work_module.work(rep)
        return 100.0 * bound_ms(ops, nbytes) / (us / 1e3)

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle gaps
        summed by what the host was doing in them (the innermost host
        event over the gap's middle), ten longest; seconds."""
        ops = collections.Counter()
        for name, _, _, dur in self.device:
            ops[name] += dur / 1e6
        idle, edge = [], self.t0
        for a, b in self.busy_intervals() + [[self.t1, self.t1]]:
            if a > edge:
                idle.append((0.5 * (edge + a), a - edge))
            edge = max(edge, b)
        # one sweep over the gaps' middles and the host events by start
        hosts = sorted(self.host, key=lambda h: h[1])
        gaps, active, j = collections.Counter(), [], 0
        for mid, length in sorted(idle):
            while j < len(hosts) and hosts[j][1] <= mid:
                active.append(hosts[j])
                j += 1
            active = [h for h in active if h[1] + h[2] >= mid]
            label = (min(active, key=lambda h: h[2])[0] if active
                     else "host, no operator")
            gaps[label] += length / 1e6
        return {"device_ops": [[n, s] for n, s in ops.most_common(10)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(10)]}
