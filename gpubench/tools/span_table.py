"""The traced window of a cell put down to the program's spans, one seed
after another in one process (the benchmark's own runs never run this):

    python gpubench/tools/span_table.py --workload <name> --seeds 1,2,3

Each seed runs the cell's set-up and its traced items, as ``--trace 1``
does, without the check against the reference, and prints one JSON line:
the window's ms per item, each span's exclusive device ms and operations
per item with its three largest operations, the unattributed and the
unmatched device time, how long after its launching call each operation
starts (``early``: those that start before it), the six span readers,
the checks of the attribution (the spans plus the unattributed rest
against the window's device time, the device time of the profiler's
events against the record's, ``indexing_backward`` within the
texture backward, K2 and K3 within the integrator) and the threads the
spans opened on.
"""

import argparse
import collections
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
READERS = ("texture_bwd_ms", "integrator_ms", "autograd_ms", "shading_ms",
           "trainer_ms", "host_gap_ms")


def launch_to_start(rec) -> dict:
    """How long after its launching call (found by ``correlation``) each
    operation starts: quantiles, and ``early``: the operations that start
    before it (none, when the host's and the card's clocks are one), the
    most any leads its call by, and their names."""
    from gpubench import spans

    got = spans.links(rec)
    lags, early = [], collections.Counter()
    for name, ts, _, corr, _ in got["device"]:
        if corr in got["calls"]:
            lags.append(ts - got["calls"][corr][0])
            if lags[-1] < 0:
                early[name] += 1
    lags.sort()
    q = {f"p{p}": lags[min(len(lags) - 1, len(lags) * p // 100)]
         for p in (0, 1, 5, 25, 50)} if lags else {}
    return {**q, "n": len(lags), "early": sum(early.values()),
            "early_max_us": max(0.0, -lags[0]) if lags else 0.0,
            "early_by_name": early.most_common(6)}


def table(rec) -> dict:
    """The attribution of one record, per item, with its checks."""
    from gpubench import harness, spans

    got = spans.attribute(rec)
    n = rec.n_items
    out = {"window_ms_per_item": rec.window_us / 1e3 / n,
           "busy_ms_per_item": rec.busy_us() / 1e3 / n}
    if got is None:
        return out
    total = got["total_us"]
    out["spans"] = {
        name: {"ms": s["us"] / 1e3 / n, "ops": s["ops"] / n,
               "top": [[k, v / 1e3 / n] for k, v in collections.Counter(
                   s["by_name"]).most_common(3)]}
        for name, s in got["spans"].items()}
    out["device_ms"] = total / 1e3 / n
    out["record_device_ms"] = sum(d for *_, d in rec.device) / 1e3 / n
    out["unattributed_ms"] = got["unattributed_us"] / 1e3 / n
    out["unattributed_share"] = got["unattributed_us"] / total
    out["unmatched_share"] = got["unmatched_us"] / total
    out["launch_to_start_us"] = launch_to_start(rec)
    read = {m: harness.metric_reader(f"{m}.fit")(rec) for m in READERS}
    out["readers"] = read
    five = sum(v or 0.0 for k, v in read.items() if k != "host_gap_ms")
    out["checks"] = {
        "sum_vs_device": (five + out["unattributed_ms"]) / out["device_ms"],
        "links_vs_record": out["device_ms"] / out["record_device_ms"],
        "texture_minus_indexing_bwd": (read["texture_bwd_ms"] or 0.0) - (
            rec.kernel_us("indexing_backward_kernel_small_stride") / 1e3 / n),
        "integrator_minus_k2_k3": (read["integrator_ms"] or 0.0) - (
            (rec.kernel_us("rk4_ckpt_kernel") + rec.kernel_us(
                "rk4_bwd_kernel")) / 1e3 / n)}
    threads = collections.defaultdict(set)
    for name, _, _, tid in spans.links(rec)["spans"]:
        threads[str(tid)].add(name)
    out["threads"] = {t: sorted(v) for t, v in threads.items()}
    return out


def main(argv=None) -> int:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from gpubench import harness, loops, spans, tracing

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(ROOT, args.workload)
    traffic = cell["traffic"]
    n = int(traffic.get("trace_frames", traffic.get("trace_steps", 4)))
    print(f"# card: {harness.card_line()}", file=sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        loop = loops.make(cell, seed, args.device)
        loop.setup()
        if args.device == "cuda":
            torch.cuda.synchronize()
        prof = tracing.Profiler()
        for i in range(loop.first, loop.first + n):
            with torch.profiler.record_function(tracing.ITEM_SPAN):
                loop.item(i)
        rec = tracing.Record(prof.stop(), n, loop)
        line = {"workload": args.workload, "seed": seed, **table(rec)}
        # what the readers' search for the profiler compares
        direct = spans.from_profiler(prof.prof)
        line["profiler_vs_record"] = {
            "window_us": [direct and direct["window_us"], rec.window_us],
            "device_ops": [direct and len(direct["device"]),
                           len(rec.device)]}
        print(json.dumps(line), flush=True)
        loop.release()
        del rec, prof
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
