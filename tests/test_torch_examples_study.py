"""The port's parameter_study program end to end on the CPU (``--device
cpu``), ``--quick`` as tests/test_io_cli.py::test_parameter_study_runs runs
the JAX script: its Bardeen, deflection and beaming checks pass inside the
script and its JSON table holds the three studies.

Its own file: the bisection is 104 one-ray launches of up to 6,000 plain
RK4 steps, most of them near the critical impact parameter, where the
rays orbit until the budget ends (a Kerr step of the plain loop is ~1,200
PyTorch operations), about 4 minutes on one CPU thread.
"""

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu_torch.examples import (  # noqa: E402
    parameter_study)


def test_parameter_study_main(tmp_path):
    rc = parameter_study.main(["--outdir", str(tmp_path), "--quick",
                               "--device", "cpu"])
    assert rc == 0
    with open(tmp_path / "parameter_study.json") as f:
        rep = json.load(f)
    assert {"shadow_edges", "deflection", "disk_asymmetry"} <= set(rep)
    assert max(max(r["rel_err"]) for r in rep["shadow_edges"]) < 0.01
