"""The port's kerr_faraday, fit_orbit and tutorial programs run end to end
on the CPU (``--device cpu``) at the sizes of the JAX scripts' smoke tests
in tests/test_io_cli.py, with their assertions: the Faraday signatures,
the fit's loss halved and its mass moved toward the truth (12 epochs need
not reach the 1% gate: exit code 1 is allowed), the tutorial's images.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu_torch.examples import (  # noqa: E402
    fit_orbit, kerr_faraday, tutorial)


def test_kerr_faraday_main(tmp_path, capsys):
    """Twin of test_kerr_faraday_example_smoke."""
    rc = kerr_faraday.main(["--size", "40", "--n-steps", "400", "--outdir",
                            str(tmp_path), "--device", "cpu"])
    assert rc == 0
    with open(tmp_path / "kerr_faraday.json") as f:
        rep = json.load(f)
    assert rep["excess_rms"][0] < 2e-3
    assert rep["spin_odd_fraction"] > 0.25
    assert os.path.exists(tmp_path / "kerr_faraday.npz")
    assert os.path.exists(tmp_path / "kerr_faraday.png")
    assert "KERR TRANSPORT SIGNATURES OK" in capsys.readouterr().out


def test_fit_orbit_main(tmp_path):
    """Twin of test_fit_orbit_example_smoke."""
    rc = fit_orbit.main(["--size", "32", "--frames", "2", "--samples", "2",
                         "--epochs", "12", "--n-steps", "100", "--outdir",
                         str(tmp_path), "--device", "cpu"])
    assert rc in (0, 1)
    with open(tmp_path / "fit_orbit_result.json") as f:
        rep = json.load(f)
    assert rep["loss_last"] < 0.5 * rep["loss_first"], rep
    m0, m1 = rep["init"]["mass"], rep["recovered"]["mass"]
    assert abs(m1 - 0.5) < abs(m0 - 0.5), rep
    assert rep["config"]["mesh"] == {"samples": 1, "rays": 1}
    assert len(rep["losses"]) == 24


def test_tutorial_main(tmp_path, capsys):
    """Twin of test_examples_tutorial_runs."""
    rc = tutorial.main(["--outdir", str(tmp_path), "--size", "64",
                        "--device", "cpu"])
    assert rc == 0
    assert "tutorial done" in capsys.readouterr().out
    for name in ("tutorial_disk.png", "tutorial_limited_mlp.png",
                 "tutorial_polfrac.png"):
        assert os.path.exists(tmp_path / name), name
