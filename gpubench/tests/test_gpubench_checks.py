"""The comparison that decides ``correct`` fails what it has to: the
control (the reference in bfloat16 in the program's place) and the faults
of faults.py planted under the timed path, each driven through a whole run
of the harness at a tiny size, with the look for a card skipped.  The
frames loop, which no cell of BENCHMARK.json drives now, shows its fault
in the compared numbers."""

import time

import pytest
import torch

import _tiny
from gpubench import faults, harness, loops

torch.set_num_threads(2)


def _fails(cell, numbers) -> bool:
    return any(numbers[k] > v for k, v in cell["limits"].items())


@pytest.mark.parametrize("workload", _tiny.cells())
def test_control_fails(workload):
    cell = _tiny.cell(workload, 16)
    loop = loops.make(cell, _tiny.SEED, "cpu")
    loop.setup()
    k = int(cell["traffic"].get("checked_steps", 0))
    for i in range(k, k + 2):
        loop.item(i)
    loop.release()
    assert _fails(cell, loop.control(torch.bfloat16))


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in _tiny.cells()
    for f in faults.FOR_LOOP[w.split(".")[-1]]])
def test_fault_fails(workload, fault):
    cell = _tiny.cell(workload, 16)
    with faults.planted(fault):
        res = harness.run(cell, _tiny.SEED, 0.5, False, time.perf_counter(),
                          device="cpu")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("workload", _tiny.cells())
def test_sound_run_is_correct(workload):
    cell = _tiny.cell(workload, 16)
    res = harness.run(cell, _tiny.SEED, 0.5, False, time.perf_counter(),
                      device="cpu")
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and list(res)[-1] == "checks"


@pytest.mark.parametrize("config", ["orbit_anim_1024", "einstein_ring_512"])
def test_an_altered_frame_shows(config):
    """A frame altered where it is produced reads a 1/64 block of pixels
    off, far above the limits PERF.md keeps for the frames cells."""
    loop = loops.make(_tiny.cell(f"{config}.frames", 16), _tiny.SEED, "cpu")
    with faults.planted("answer"):
        loop.setup()
        for i in range(3):
            loop.item(i)
    got = loop.numbers()
    assert got["px_off"] >= 1 / 64 and got["mean_abs"] > 1.0
