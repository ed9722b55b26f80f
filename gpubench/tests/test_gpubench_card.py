"""On a CUDA card: each cell at a small size through the whole harness,
kernels and all, comes out correct against the reference, and a traced
run reads every per-layer metric the cell reports.  Skips without a card
(decided in the ``card`` fixture).  Run on the card with

    python -m pytest -q gpubench/tests/test_gpubench_card.py
"""

import time

import pytest

import _tiny
from gpubench import harness


@pytest.mark.parametrize("workload", _tiny.cells())
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_card(card, workload, trace):
    cell = _tiny.cell(workload, 64)
    res = harness.run(cell, _tiny.SEED, 1.0, trace, time.perf_counter(),
                      device=card)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert res["device"]["busy_s"] > 0
        assert set(res["metrics"]) == {m["name"] for m in cell["per_layer"]}
        for name, m in res["metrics"].items():
            if name.endswith("_roofline"):
                assert 0 < m["value"] <= 105
    else:
        assert set(res["metrics"]) == {m["name"]
                                       for m in cell["end_to_end"]}
