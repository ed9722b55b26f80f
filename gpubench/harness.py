"""One run of one cell: set-up, the measured or traced window, the check
against the reference, and the result line.

Everything that belongs to one cell is found by name: the workload in
``BENCHMARK.json``, its configuration's file, ``traffic/<mix>.json``,
``limits/<workload>.json``, the loop ``loops/<loop>.py`` that the mix
names and, in a traced run, the reader ``metrics/<metric>.py`` of each
per-layer metric that the cell reports.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import loops, tracing

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "blackhole_geodesic_calculator_tpu")


def load_cell(root: Path, workload: str) -> dict:
    """The cell ``workload`` of ``root/BENCHMARK.json``: its entry, its
    configuration, traffic and limits, and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    wl = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return {
        "workload": wl, "end_to_end": e2e, "per_layer": per_layer,
        "config": json.loads((root / entry["file"]).read_text()),
        "traffic": json.loads(
            (HERE / "traffic" / f"{wl['traffic']}.json").read_text()),
        "limits": json.loads(
            (HERE / "limits" / f"{workload}.json").read_text()),
    }


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``; a metric split by the cells'
    end-to-end metrics (``idle_share.frames``, ``idle_share.fit``) is
    read by ``metrics/<part before the first dot>.py`` when it has no
    file of its own."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda") -> dict:
    """One run; returns the result line's object."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    traffic = cell["traffic"]
    loop = loops.make(cell, seed, device)
    loop.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    first = loop.first
    times = []
    if trace:
        n = int(traffic.get("trace_frames", traffic.get("trace_steps", 4)))
        loop.tracing = True
        prof = tracing.Profiler()
        for i in range(first, first + n):
            with torch.profiler.record_function(tracing.ITEM_SPAN):
                loop.item(i)
        events = prof.stop()
        window_s = None
    else:
        # the window ends with the first item after ``seconds`` that closes
        # a whole cycle of the mix (the animation's frames, the targets), so
        # every run does the same kinds of work in the same proportions
        t0 = time.perf_counter()
        i = first
        while True:
            a = time.perf_counter()
            loop.item(i)
            b = time.perf_counter()
            times.append(b - a)
            i += 1
            if b - t0 >= seconds and len(times) % loop.cycle == 0:
                break
        window_s = b - t0
        n = len(times)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    loop.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    result = {"correct": None, "attempted": n, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if cuda else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if cuda else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        rec = tracing.Record(events, n, loop)
        del events
        result["device"]["busy_s"] = rec.busy_us() / 1e6
        result["device"]["window_s"] = rec.window_us / 1e6
        for m in cell["per_layer"]:
            value = metric_reader(m["name"])(rec)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = rec.breakdown()
    else:
        per_s = n / window_s
        e2e = {"frames_per_s": per_s, "steps_per_s": per_s,
               "frame_ms_p95": float(np.percentile(times, 95)) * 1e3,
               "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        for m in cell["end_to_end"]:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
    numbers = loop.numbers()
    limits = cell["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result
