"""The benchmark's own rules: nothing it runs imports JAX or the JAX
package, the reference imports nothing of the program, and every cell and
metric of BENCHMARK.json resolves to its files by name."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gpubench"
JAX_NAMES = {"jax", "jaxlib", "flax", "blackhole_geodesic_calculator_tpu"}
PROGRAM = "blackhole_geodesic_calculator_tpu_torch"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path) -> set:
    """Top-level names of the modules a file imports (absolute imports)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub=""):
    return sorted((BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not _imports(path) & JAX_NAMES


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in _imports(path)
    assert "gpubench" not in _imports(path)


def test_reference_loads_alone():
    code = ("import sys; sys.path.insert(0, %r); "
            "import gpubench.reference.render, gpubench.reference.shading; "
            "bad = {m.split('.')[0] for m in sys.modules} & %r; "
            "bad |= {m for m in sys.modules if m.split('.')[0] == %r}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)"
            % (str(ROOT), JAX_NAMES, PROGRAM))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_file_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["gpubench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gpubench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert 1 <= len(m["layer"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()[
    "workloads"]])
def test_cell_resolves_to_its_files(workload):
    cell = harness.load_cell(ROOT, workload)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]))
    numbers = ({"px_off", "mean_abs"} if cell["traffic"]["loop"] == "frames"
               else {"loss_gap", "grad_gap", "change_gap",
                     "change_gap_median", "window_change_gap"})
    assert cell["limits"] and set(cell["limits"]) <= numbers
    assert all(v > 0 for v in cell["limits"].values())
    assert cell["config"]["name"] == cell["workload"]["config"]


def test_no_result_without_a_card(tmp_path):
    """Without a CUDA card the command prints no result and fails; in a
    directory of BENCHMARK.json and gpubench alone it fails too."""
    cmd = [sys.executable, "gpubench/run.py", "--workload",
           _bench()["workloads"][0]["name"], "--seed", str(2**31 + 5),
           "--seconds", "1", "--trace", "0"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and not out.stdout.strip()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and not out.stdout.strip()


def test_loops_and_readers_are_found_by_name():
    """A mix's loop is the module of its name under loops/; a metric split
    by cells is read by the reader of its stem; an unknown loop fails."""
    from gpubench import loops

    for mix in (BENCH / "traffic").glob("*.json"):
        kind = json.loads(mix.read_text())["loop"]
        assert (BENCH / "loops" / f"{kind}.py").exists()
    assert harness.metric_reader("idle_share.frames") is not None
    with pytest.raises(ValueError, match="no loop"):
        loops.make({"traffic": {"loop": "no_such_loop"}}, 1, "cpu")


@pytest.mark.parametrize("where,key", [("scene", "spin"),
                                       ("animation", "speed"),
                                       ("fit", "freeze")])
def test_a_key_the_benchmark_does_not_read_stops_the_run(where, key):
    """A configuration key that neither side would read (a Kerr spin, say)
    stops the run rather than render Schwarzschild on both sides."""
    from gpubench.scenes import Scenes

    config = json.loads((BENCH / "configs" /
                         "einstein_ring_512.json").read_text())
    config[where][key] = 0.5
    with pytest.raises(ValueError, match=repr(key)):
        Scenes(config, 1, "cpu")
    config = json.loads((BENCH / "configs" /
                         "einstein_ring_512.json").read_text())
    config["scene"]["mode"] = "fast"
    with pytest.raises(ValueError, match="scan or while"):
        Scenes(config, 1, "cpu")
