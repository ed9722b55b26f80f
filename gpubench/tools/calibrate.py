"""The readings that the limits of ``limits/<workload>.json`` are set from,
many seeds in one process (the benchmark's own runs never run this):

    python gpubench/tools/calibrate.py --workload <name> --seeds 1,2,3 \
        --mode sound|control|witness|<fault> [--seconds 3]

* ``sound``: the program as it stands against the reference: the lower
  readings;
* ``control``: the reference computed in bfloat16, the next precision
  below the configurations' float32, in the program's place;
* a fault of ``faults.py`` planted in the program;
* ``witness`` (fit): the program and the float32 reference, each against
  the reference in float64, which tells on which side a gap lies.

Each seed runs the cell's set-up, a window of ``--seconds`` (the frames
or the step that the check samples come from it) and the check, and
prints one JSON line of the compared numbers; a fit's line also holds
each leaf's gradient at each compared step and its change, program and
reference side by side (a scalar leaf's with its sign, a texture's norm).
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def _leaves(prog: dict, ref: dict, loop) -> dict:
    """Each leaf's readings, program and reference side by side: the
    gradient at each compared step and the change (a scalar leaf's with
    its sign, a texture's norm), and the window step's."""
    from gpubench import compare

    def norm(d):
        return {n: float(v.double().norm()) for n, v in d.items()}

    def signed(d):
        return {n: float(v) if v.numel() == 1
                else float(v.double().norm()) for n, v in d.items()}

    out = {"leaves": {
        "losses": [prog["losses"], ref["losses"]],
        "grad_gap": compare.leaf_gaps(prog["grad"], ref["grad"]),
        "change_gap": compare.leaf_gaps(prog["change"], ref["change"]),
        "step_grads": [[signed(g) for g in prog["grads"]],
                       [signed(g) for g in ref["grads"]]],
        "change": [signed(prog["change"]), signed(ref["change"])],
        "grad_norm": [norm(prog["grad"]), norm(ref["grad"])],
        "change_norm": [norm(prog["change"]), norm(ref["change"])]}}
    if "window" in ref:
        pw, rw = prog["window"], ref["window"]
        out["window"] = {
            "k": loop.window["k"], "loss": [pw["loss"], rw["loss"]],
            "grad": [signed(pw["grad"]), signed(rw["grad"])],
            "change": [signed(pw["change"]), signed(rw["change"])],
            "change_gap": compare.leaf_gaps(pw["change"], rw["change"])}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="sound")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from gpubench import compare, faults, harness, loops

    cell = harness.load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = (faults.planted(args.mode)
               if args.mode not in ("sound", "control", "witness")
               else contextlib.nullcontext())
        with ctx:
            loop = loops.make(cell, seed, args.device)
            loop.setup()
            k = loop.first
            end = time.perf_counter() + args.seconds
            while time.perf_counter() < end:
                loop.item(k)
                k += 1
        loop.release()
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
        if args.mode == "witness":
            # the float32 reference and the program, each against the
            # reference in float64: which of the two sides a gap is on
            r64 = loop.reference_steps(torch.float64)
            r32 = loop.reference_steps(torch.float32)
            pairs = [("program~f64", loop._program(), r64),
                     ("f32~f64", r32, r64),
                     ("program~f32", loop._program(), r32)]
        else:
            got = (loop.control(torch.bfloat16) if args.mode == "control"
                   else loop.numbers())
            pairs = [(args.mode, *loop.compared)] if getattr(
                loop, "compared", None) else [(args.mode, None, None)]
        for label, prog, ref in pairs:
            if prog is not None:
                got = compare.fit_numbers(prog, ref)
            line = {"workload": args.workload, "mode": label, "seed": seed,
                    "items": k, "seconds": time.perf_counter() - t0, **got}
            if prog is not None:
                line.update(_leaves(prog, ref, loop))
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
