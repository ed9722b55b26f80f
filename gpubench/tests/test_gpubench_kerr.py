"""The Kerr cell, ``kerr_disk_1024.fit_kerr``: it resolves to its files,
its scenes read a spin and a beaming disk and nothing else new, its
reference imports nothing of the program or of JAX, its steps equal the
port's plain path at a tiny size, and its work counts are the Kerr
reference's own."""

import ast
import copy
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _tiny
from gpubench import harness, loops
from gpubench.reference import integrate as SI
from gpubench.reference_kerr import integrate as KI
from gpubench.scenes import Scenes
from gpubench.scenes_kerr import KerrScenes
from gpubench.work import _common, _kerr, rk4_bwd_kerr, rk4_ckpt_kerr

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gpubench"
CELL = "kerr_disk_1024.fit_kerr"
NAMES = {"jax", "jaxlib", "flax", "blackhole_geodesic_calculator_tpu",
         "blackhole_geodesic_calculator_tpu_torch", "gpubench"}


def _config():
    return json.loads((BENCH / "configs" / "kerr_disk_1024.json").read_text())


def test_the_cell_loads_by_name():
    cell = harness.load_cell(ROOT, CELL)
    assert cell["workload"]["chips"] == 1
    assert cell["traffic"]["loop"] == "fit_kerr"
    assert {m["name"] for m in cell["end_to_end"]} == {
        "steps_per_s", "peak_mem_gib", "setup_s"}
    names = {m["name"] for m in cell["per_layer"]}
    assert len(names) == 12 and "rk4_bwd_roofline" not in names
    assert {"rk4_bwd_kerr_roofline", "rk4_ckpt_kerr_roofline",
            "redshift_ms.fit"} <= names
    for m in cell["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    # the orbit cell reports none of the Kerr metrics
    orbit = {m["name"] for m in harness.load_cell(
        ROOT, "orbit_anim_1024.fit")["per_layer"]}
    assert not orbit & {"rk4_bwd_kerr_roofline", "rk4_ckpt_kerr_roofline",
                        "redshift_ms.fit"}


def test_kerr_scenes_read_the_spin_and_the_beaming():
    """The learned spin is s of a = M tanh(s): the truth a/M = 0.9, the
    start a = 0.45 - 0.15 at the start's mass 0.55 (a/M 0.545); every s
    keeps |a| < M; both sides get the same spin tensor, in the graph."""
    sc = KerrScenes(_config(), 1, "cpu")
    truth = sc.truth()
    assert list(truth) == ["mass", "spin", "orbit_phase", "roll", "sky"]
    assert float(torch.tanh(truth["spin"])) == pytest.approx(0.9)
    assert float(sc.raw(0, truth)["spin"]) == pytest.approx(0.45)
    start = sc.start()
    assert list(start) == list(truth)
    assert float(start["mass"]) == pytest.approx(0.55)
    raw = sc.raw(25, start)
    assert float(raw["spin"]) == pytest.approx(0.30, abs=1e-6)
    for s in (-30.0, -1.0, 3.0, 30.0):
        a = sc.raw(0, dict(start, spin=torch.tensor(s)))["spin"]
        assert abs(float(a)) <= float(start["mass"])
    leaf = start["spin"].clone().requires_grad_(True)
    raw = sc.raw(25, dict(start, spin=leaf))
    scene, cam = sc.port(raw)
    assert scene.bh.spin is raw["spin"] and float(scene.disk.beaming) == 4.0
    ref, _ = sc.reference(raw)
    assert ref["spin"] is raw["spin"] and ref["disk"]["beaming"] is not None
    assert ref["disk"]["texture"] is scene.disk.texture
    ref["spin"].backward()
    assert float(leaf.grad) > 0


@pytest.mark.parametrize("where,key,value", [
    ("scene", "camera_rotation_euler", [0.25, 0.0, 0.0]),
    ("scene", "method", "dopri"),
    ("scene", "spheres", [{"center": [7, 0, 0], "radius": 0.5,
                           "texture": "moon"}]),
    ("animation", "speed", 1.0),
    ("fit", "freeze", True)])
def test_kerr_scenes_refuse_what_they_do_not_read(where, key, value):
    config = _config()
    config[where][key] = value
    with pytest.raises(ValueError):
        KerrScenes(config, 1, "cpu")


def test_a_spin_still_stops_the_plain_scenes():
    """scenes.Scenes refuses the Kerr configuration's spin, as
    test_gpubench_contract.py holds it to: only the Kerr loop reads it."""
    with pytest.raises(ValueError, match="'spin'"):
        Scenes(_config(), 1, "cpu")


@pytest.mark.parametrize("path", sorted((BENCH / "reference_kerr").rglob(
    "*.py")), ids=lambda p: p.name)
def test_kerr_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
    assert not found & NAMES


def test_kerr_reference_loads_alone():
    code = ("import sys; sys.path.insert(0, %r); "
            "import gpubench.reference_kerr.render; "
            "bad = {m.split('.')[0] for m in sys.modules} & %r; "
            "bad |= {m for m in sys.modules if m.startswith("
            "'blackhole_geodesic_calculator_tpu')}; "
            "bad |= {m for m in sys.modules if m.startswith('gpubench.') "
            "and not m.startswith('gpubench.reference_kerr')}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)"
            % (str(ROOT), NAMES - {"gpubench"}))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_fit_kerr_steps_equal_the_reference():
    """The port's plain path and the Kerr reference, at 16^2 x 5 spp and 80
    steps, give the same steps: the same float32 operations."""
    loop = loops.make(_tiny.cell(CELL, 16), _tiny.SEED, "cpu")
    loop.setup()
    for k in range(loop.first, loop.first + 3):
        loop.item(k)
    got = loop.numbers()
    assert got["loss_gap"] < 1e-4 and got["grad_gap"] < 1e-4
    assert got["change_gap"] < 2e-3 and got["window_change_gap"] < 2e-3
    # the spin learned, and every other leaf
    assert all(float(c.abs().max()) > 0 for c in loop.change.values())
    assert "spin" in loop.change


@pytest.mark.parametrize("rule", ["none", "schwarzschild"])
def test_fit_kerr_needs_the_programs_kerr_mask(monkeypatch, rule):
    """A program whose Trainer gives weight to the rays on a Kerr hole's
    critical curve (no mask near it, or the Schwarzschild band around
    3 sqrt(3) M) fails the loop's set-up at once, before any step."""
    import blackhole_geodesic_calculator_tpu_torch as P

    masked = P.Trainer._critical_weights

    def weights(self, scene, cam, ys, xs):
        if rule == "none":
            return torch.ones(ys.shape)
        bh = dataclasses.replace(scene.bh, spin=None)
        return masked(self, dataclasses.replace(scene, bh=bh), cam, ys, xs)

    monkeypatch.setattr(P.Trainer, "_critical_weights", weights)
    loop = loops.make(_tiny.cell(CELL, 8), _tiny.SEED, "cpu")
    with pytest.raises(RuntimeError, match="Kerr critical curve"):
        loop.setup()
    assert not hasattr(loop, "losses")


def test_fit_kerr_loop_has_the_fit_loops_fields():
    """``fit_kerr.Loop`` sets ``base.Loop``'s and ``fit.Loop``'s fields
    itself (``base.Loop`` makes scenes that refuse a spin): the same
    fields, with Kerr scenes."""
    orbit = loops.make(_tiny.cell("orbit_anim_1024.fit", 8), _tiny.SEED,
                       "cpu")
    kerr = loops.make(_tiny.cell(CELL, 8), _tiny.SEED, "cpu")
    assert set(vars(kerr)) == set(vars(orbit))
    assert isinstance(kerr.scenes, KerrScenes)
    assert kerr.cfg == kerr.scenes.port_render_config()


def _launch(kerr, n=96, seed=0):
    g = torch.Generator().manual_seed(seed)
    d = torch.nn.functional.normalize(
        0.1 * torch.randn(n, 3, generator=g) + torch.tensor([0, 0, -1.0]),
        dim=-1)
    o = torch.tensor([0.0, 0.0, 25.0]).expand(n, 3).clone()
    cfg = dict(n_steps=100, dt=0.1, dt_boost=64.0, dt_boost_r_ref=1.7,
               dt_power=1.5)
    disk = (torch.tensor(1.6), torch.tensor(6.0))
    if kerr:
        env = KI.Env(mass=torch.tensor(0.5), spin=torch.tensor(0.45),
                     r_capture=KI.horizon(torch.tensor(0.5),
                                          torch.tensor(0.45)),
                     r_escape=torch.tensor(70.0),
                     lam_max=torch.tensor(100.0), disk=disk)
        return env, KI.Integrator(**cfg), KI.start(env, o, d)
    env = SI.Env(mass=torch.tensor(0.5), r_capture=torch.tensor(1.0),
                 r_escape=torch.tensor(70.0), lam_max=torch.tensor(100.0),
                 disk=disk)
    return env, SI.Integrator(**cfg), SI.start(env, o, d)


def test_kerr_work_counts_exceed_the_schwarzschild_ones():
    kerr = _kerr.replay([_launch(True)])
    schw = _common.replay([_launch(False)])
    assert kerr.rays == schw.rays == 96 and kerr.steps > 96
    assert kerr.step_ops > schw.step_ops > 0
    assert kerr.adj_ops > schw.adj_ops > 0
    again = _kerr.replay([_launch(True)])
    assert (again.step_ops, again.adj_ops, again.steps) == (
        kerr.step_ops, kerr.adj_ops, kerr.steps)
    for mod in (rk4_bwd_kerr, rk4_ckpt_kerr):
        ops, nbytes = mod.work(kerr)
        assert ops > 0 and nbytes > 0
    assert rk4_bwd_kerr.work(kerr)[0] == kerr.steps * (kerr.step_ops
                                                       + kerr.adj_ops)
    assert rk4_ckpt_kerr.work(kerr)[0] == kerr.steps * kerr.step_ops
    # a Schwarzschild launch has no Kerr replay
    assert _kerr.replay([_launch(False)]) is None


class _Rec:
    """A record's face to the Kerr rooflines: a kernel time and a loop."""

    def __init__(self, us, launches):
        self.us, self.loop = us, type("L", (), {
            "traced_rays": lambda self: iter(launches)})()

    def kernel_us(self, name):
        return self.us if name in ("rk4_bwd_kernel", "rk4_ckpt_kernel") \
            else 0.0


def test_kerr_rooflines_read_their_kernel_and_replay_once():
    rec = _Rec(1e3, [_launch(True)])
    bwd = _kerr.roofline(rec, rk4_bwd_kerr)
    ckpt = _kerr.roofline(rec, rk4_ckpt_kerr)
    assert 0 < bwd and 0 < ckpt
    rep = rec.kerr_replay
    ops, nbytes = rk4_bwd_kerr.work(rep)
    assert bwd == pytest.approx(100.0 * _common.bound_ms(ops, nbytes))
    assert _kerr.roofline(_Rec(0.0, [_launch(True)]), rk4_bwd_kerr) is None
    assert _kerr.roofline(_Rec(1e3, [_launch(False)]), rk4_bwd_kerr) is None
    assert copy.copy(rec).kerr_replay is rep
