"""Profiler integration on ``torch.profiler`` (PyTorch port of
utils/profiling.py).

* ``trace(dir)`` captures the host's operators, and the card's kernels and
  copies when a CUDA device is present, and writes a Chrome trace under
  ``dir`` (chrome://tracing, Perfetto or TensorBoard read it);
* ``annotate(name)`` scopes a named region of the timeline, and costs a
  flag read when no profiler runs;
* ``profile_steps(fn, *args)`` + ``op_table(...)`` read that trace back
  and return per-op device times, and ``collective_report`` the share of
  the collectives and their overlap with compute, without a viewer.

Which events count as the "device": with a card, the kernels, memcpys and
memsets the trace records on the GPU; on a host without one, the CPU
operators (``cpu_op``), each by its self time -- the trace nests an aten
operator inside its caller, where XLA's op events are flat, so the nested
operators are cut into the pieces their children leave uncovered
(``_flat_pieces``) and no time is counted twice.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import math
import os
import shutil
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: ``with trace('/tmp/trace'): render(...)``; on exit
    it is written to ``logdir/<ns>.pt.trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"{time.time_ns():020d}.pt.trace.json"))


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """Named span context for profiler timelines: ``record_function`` while
    a profiler runs (its span shares the trace, and the clock, with the
    card's kernels), else one shared ``nullcontext``: a bare
    ``record_function`` dispatches two operators even with no profiler
    running.  The Python flag is the process's, so spans opened on
    autograd's device thread see it too."""
    if not (torch.autograd.profiler._is_profiler_enabled
            or torch._C._autograd._profiler_enabled()):
        return _OFF
    return torch.profiler.record_function(name)


def device_memory_stats():
    """Per-device live/peak/limit/reserved bytes of each CUDA device under
    the JAX ``memory_stats`` names; ``{"cpu": None}`` without one."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    out = {}
    for i in range(torch.cuda.device_count()):
        d = torch.device("cuda", i)
        out[str(d)] = {
            "bytes_in_use": torch.cuda.memory_allocated(d),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(d),
            "bytes_limit": torch.cuda.get_device_properties(d).total_memory,
            "bytes_reserved": torch.cuda.memory_reserved(d),
        }
    return out


def _load_trace_events(logdir: str):
    """All trace events from the newest .pt.trace.json under ``logdir``."""
    paths = sorted(glob.glob(os.path.join(logdir, "*.pt.trace.json")))
    if not paths:
        raise FileNotFoundError(f"no trace artifact under {logdir}")
    with open(paths[-1]) as f:
        return json.load(f)["traceEvents"]


def kernel_name(name: str) -> str:
    """A device kernel's name without its return type, namespaces of no
    interest, template arguments and parameters:
    "void (anonymous namespace)::rk4_bwd_kernel<1, false, 0>(float
    const*, ...)" -> "rk4_bwd_kernel"."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.strip()


def _op_events(events):
    """The events that count as device work, as (lane, name, ts, dur):
    the GPU's kernels (by ``kernel_name``), memcpys and memsets when the
    trace has any, else the host's ``cpu_op`` events.  A lane is a
    (pid, tid): a CUDA stream or a host thread."""
    cats = DEVICE_CATS if any(e.get("cat") in DEVICE_CATS
                              for e in events) else ("cpu_op",)
    return [((e["pid"], e["tid"]),
             kernel_name(e["name"]) if e["cat"] == "kernel" else e["name"],
             float(e["ts"]), float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in cats and "dur" in e]


def _flat_pieces(evs):
    """Nested events of each lane cut into flat pieces: each stretch of a
    lane's time goes to the innermost event open over it.  A piece's
    duration summed by name is that name's self time; events that do not
    nest (kernels on one stream) come back whole."""
    lanes = collections.defaultdict(list)
    for lane, name, ts, dur in evs:
        lanes[lane].append((ts, -dur, name))
    out = []
    for lane, items in lanes.items():
        items.sort()
        stack = []           # (end, name), innermost last
        t = None

        def close_to(until):
            nonlocal t
            if until > t:
                out.append((lane, stack[-1][1], t, until - t))
            t = until

        for ts, neg, name in items:
            while stack and stack[-1][0] <= ts:
                close_to(stack[-1][0])
                stack.pop()
            if stack:
                close_to(ts)
            end = ts - neg
            if stack:
                end = min(end, stack[-1][0])
            t = ts
            stack.append((end, name))
        while stack:
            close_to(stack[-1][0])
            stack.pop()
    return out


def _device_complete_events(events):
    """Device-side complete events as flat (lane, name, ts, dur) tuples
    (``_op_events`` cut by ``_flat_pieces``), as op_table counts them."""
    return _flat_pieces(_op_events(events))


def op_table(logdir: str, top: int = 20, repeats: int = 1):
    """Per-op device-time table from a captured trace.

    Returns ``[(name, total_ms, count), ...]`` sorted by time, summed over
    the device events (``_device_complete_events``: with a card its
    kernels, memcpys and memsets; without one the CPU operators by self
    time) and divided by ``repeats`` (the number of identical steps
    traced).  ``count`` is the number of events over all ``repeats``."""
    events = _load_trace_events(logdir)
    dur = collections.Counter()
    for _, name, _, us in _device_complete_events(events):
        dur[name] += us
    cnt = collections.Counter(name for _, name, _, _ in _op_events(events))
    return [(name, us / 1000.0 / repeats, cnt[name])
            for name, us in dur.most_common(top)]


def profile_steps(fn, *args, repeats: int = 3, top: int = 20,
                  logdir: str | None = None):
    """Run ``fn(*args)`` ``repeats`` times under the tracer and return the
    per-op device-time table (ms per step).  ``fn`` is called once first,
    outside the trace, so that kernel builds and caches stay out of it."""
    own = logdir is None
    logdir = logdir or tempfile.mkdtemp(prefix="bgc_profile_")
    fn(*args)
    _sync()
    try:
        with trace(logdir):
            for _ in range(repeats):
                fn(*args)
            _sync()
        return op_table(logdir, top=top, repeats=repeats)
    finally:
        if own:
            shutil.rmtree(logdir, ignore_errors=True)


# The JAX package's collective markers (XLA's op names) and the names
# torch.distributed's collectives take in a trace: c10d's operators
# ("c10d::allreduce_", "c10d::broadcast_", ...), the gloo and NCCL spans
# and NCCL's kernels ("ncclDevKernel_AllReduce_...").  A bare "broadcast"
# is left out: it would take in aten::broadcast_tensors.
_COLLECTIVE_MARKERS = (
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all", "psum", "allreduce", "allgather",
    "nccl", "gloo", "c10d::", "all_reduce", "all_gather", "reduce_scatter",
)


def _merge_intervals(ivals):
    ivals = sorted(ivals)
    out = []
    for s, t in ivals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _overlap_us(ival, merged):
    """Length of ``ival`` covered by the merged interval list."""
    s, t = ival
    cov = 0.0
    for a, b in merged:
        if b <= s:
            continue
        if a >= t:
            break
        cov += min(b, t) - max(a, s)
    return cov


def collective_report(logdir: str, repeats: int = 1) -> dict:
    """Collective share and compute-overlap from a captured trace.

    Of all device op time (``_device_complete_events``), how much is
    collectives (all-reduce / all-gather / reduce-scatter / ...), and what
    fraction of collective WALL time runs concurrently with non-collective
    compute (on any stream or thread): how much of the communication was
    hidden behind compute.  Returns a dict with ``compute_ms``,
    ``collective_ms``, ``collective_share``, ``overlap_fraction`` (NaN
    when there are no collectives), and ``top_collectives`` [(name, ms),
    ...], all per step (divided by ``repeats``)."""
    evs = _device_complete_events(_load_trace_events(logdir))
    is_coll = lambda name: any(m in name.lower()  # noqa: E731
                               for m in _COLLECTIVE_MARKERS)
    coll = [(ts, ts + dur, name, dur) for _, name, ts, dur in evs
            if is_coll(name)]
    comp = [(ts, ts + dur) for _, name, ts, dur in evs if not is_coll(name)]
    coll_us = sum(d for *_, d in coll)
    comp_us = sum(t - s for s, t in comp)
    merged = _merge_intervals(comp)
    hidden = sum(_overlap_us((s, t), merged) for s, t, _, _ in coll)
    top = collections.Counter()
    for _, _, name, dur in coll:
        top[name] += dur
    return {
        "compute_ms": comp_us / 1e3 / repeats,
        "collective_ms": coll_us / 1e3 / repeats,
        "collective_share": (coll_us / (coll_us + comp_us)
                             if coll_us + comp_us else 0.0),
        "overlap_fraction": (hidden / coll_us) if coll_us else math.nan,
        "top_collectives": [(n, us / 1e3 / repeats)
                            for n, us in top.most_common(8)],
    }


def profile_collectives(fn, *args, repeats: int = 3) -> dict:
    """Run ``fn`` once to warm it, then ``repeats`` times under the tracer,
    and return ``collective_report`` of the capture."""
    logdir = tempfile.mkdtemp(prefix="bgc_coll_")
    try:
        fn(*args)
        _sync()
        with trace(logdir):
            for _ in range(repeats):
                fn(*args)
            _sync()
        return collective_report(logdir, repeats=repeats)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def format_op_table(rows) -> str:
    lines = [f"{'device ms/step':>14}  {'calls':>6}  op"]
    for name, ms, c in rows:
        lines.append(f"{ms:14.3f}  {c:6d}  {name[:80]}")
    return "\n".join(lines)
