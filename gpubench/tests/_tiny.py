"""Cells of ``BENCHMARK.json`` cut to a size a CPU test can hold: the
frame to ``SIZE`` square, the RK4 loop to ``RK4_STEPS`` steps and the
Dormand-Prince loop to ``DOPRI_TRIPS`` trips (the bfloat16 control never
meets the tolerances and would run every trip), the animation to
``FRAMES`` frames (a window closes on a whole cycle of them); the rest
(scene, traffic, limits) as committed."""

import copy
import json
from pathlib import Path

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]
SIZE = 24
RK4_STEPS = 80
DOPRI_TRIPS = 300
FRAMES = 4
SEED = 2**31 + 977


def cell(name: str, size: int = SIZE) -> dict:
    """The cell ``<config>.<mix>``: BENCHMARK.json's if it lists it, else
    put together from the configuration's and the mix's files, with no
    limits (the movie's frames and the ring's fit are no cells; PERF.md
    says why, and the tests hold them to the port's plain path all the
    same)."""
    if name in cells():
        c = copy.deepcopy(harness.load_cell(ROOT, name))
    else:
        config, mix = name.split(".")
        bench = ROOT / "gpubench"
        c = {"config": json.loads(
                 (bench / "configs" / f"{config}.json").read_text()),
             "traffic": json.loads(
                 (bench / "traffic" / f"{mix}.json").read_text()),
             "limits": {}, "per_layer": [], "end_to_end": []}
    sc = c["config"]["scene"]
    sc["width"] = sc["height"] = size
    sc["n_steps"] = (RK4_STEPS if sc.get("method", "rk4") == "rk4"
                     else DOPRI_TRIPS)
    c["config"]["animation"]["frames"] = FRAMES
    return c


def cells() -> list:
    """The workloads of BENCHMARK.json."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


# every configuration under every mix, a cell or not
ALL = [f"{c}.{m}" for c in ("orbit_anim_1024", "einstein_ring_512")
       for m in ("frames", "fit")]
