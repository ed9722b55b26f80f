"""PyTorch port against the JAX package: the command-line interface
(``cli.py``: render, animate, precompute-camera, train-surrogate,
profile-train) and its packaging as ``bhgc-torch``.

Everything runs in process at 16-48 px with ``--device cpu``.  The port's
PNGs are held to the JAX CLI's on the same config by the golden rule of
tests/test_golden.py (mean drift < 2e-3, < 1% of pixels moved by > 0.1),
and each example's PNG to the host quantization of the port's own render
of ``build_scene(cfg)`` bit for bit; ``animate --resume`` comes back byte
for byte (the twin of
tests/test_golden_baseline.py::test_animation_resume_bit_identical).
"""

import glob
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu import cli as jcli  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import cli, native  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import io_  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.io_ import (  # noqa: E402
    SceneConfig, build_scene, load_config, read_image)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*.json")))


def run(*argv):
    return cli.main(["--device", "cpu", *argv])


def write_cfg(tmp_path, name="scene.json", **kw):
    p = str(tmp_path / name)
    with open(p, "w") as f:
        f.write(SceneConfig(**kw).to_json())
    return p


def golden_rule(img, ref, what):
    diff = np.abs(np.asarray(img, np.float32) - np.asarray(ref, np.float32))
    assert diff.mean() < 2e-3, f"{what}: mean drift {diff.mean():.2e}"
    assert (diff > 0.1).mean() < 0.01, (
        f"{what}: {100 * (diff > 0.1).mean():.2f}% of pixels moved > 0.1")


def quantize(img):
    return (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255.0
            + 0.5).astype(np.uint8)


def png(path):
    """The PNG's pixels, RGB(A), through the native decoder (or PIL)."""
    if native.available():
        return native.read_png(path)
    from PIL import Image

    return np.asarray(Image.open(path))


def test_cli_render_matches_jax(tmp_path):
    """Twin of test_cli_render_and_precompute's render: a tiny scene to
    PNG through both CLIs, held by the golden rule; the port's file is
    the host quantization of its own render_image bit for bit."""
    cp = write_cfg(tmp_path, width=16, height=16, n_steps=64,
                   max_integration_step=0.2, sky_image="background")
    out, jout = str(tmp_path / "out.png"), str(tmp_path / "jout.png")
    run("render", cp, "-o", out)
    jcli.main(["render", cp, "-o", jout])
    img = read_image(out)
    assert img.shape == (16, 16, 3)
    assert img[8, 8].max() < 0.05
    golden_rule(img, read_image(jout), "render 16x16")
    scene, cam, rcfg = build_scene(load_config(cp), device="cpu")
    import blackhole_geodesic_calculator_tpu_torch as P

    with torch.no_grad():
        ref = P.render_image(scene, cam, rcfg).numpy()
    np.testing.assert_array_equal(png(out), quantize(ref))


def test_cli_render_stokes(tmp_path):
    """Twin of test_cli_render_stokes: the Stokes npz (nonzero Q/U on the
    disk's pixels, |Q + iU| <= pol_frac I) and the quick-look PNG, each
    held to the JAX CLI's by the golden rule."""
    cp = write_cfg(tmp_path, width=24, height=20, n_steps=96,
                   max_integration_step=0.2, disk_on=True,
                   disk_pol_frac=0.5, camera_rotation_euler=(0.35, 0.0, 0.0))
    out, jout = str(tmp_path / "pol.png"), str(tmp_path / "jpol.png")
    run("render", cp, "-o", out, "--stokes")
    jcli.main(["render", cp, "-o", jout, "--stokes"])
    with np.load(str(tmp_path / "pol_stokes.npz")) as z, \
            np.load(str(tmp_path / "jpol_stokes.npz")) as jz:
        Q, U, I = z["Q"], z["U"], z["I"]
        assert sorted(z.files) == sorted(jz.files)
        for k in z.files:
            assert z[k].shape == jz[k].shape
            golden_rule(z[k], jz[k], f"stokes {k}")
    assert Q.shape == (20, 24) and np.isfinite(Q).all() and np.isfinite(U).all()
    assert np.abs(Q).max() + np.abs(U).max() > 0
    assert (np.hypot(Q, U) <= 0.5 * I + 1e-6).all()
    for name in ("pol.png", "pol_pfrac.png"):
        golden_rule(read_image(str(tmp_path / name)),
                    read_image(str(tmp_path / f"j{name}")), name)
    with pytest.raises(SystemExit, match="limited"):
        run("render", write_cfg(tmp_path, "lim.json", engine="limited"),
            "--stokes")


def test_cli_render_limited_engine(tmp_path):
    """Twin of test_cli_render_limited_engine: engine='limited' renders
    through the Gen-1 hybrid, the shadow at the centre, held to the JAX
    CLI's PNG."""
    cp = write_cfg(tmp_path, width=16, height=16, n_steps=128,
                   max_integration_step=0.2, engine="limited",
                   ratio_obj_to_blackhole=10.0,
                   camera_location=(0.0, 0.0, 40.0),
                   field_of_view_x=0.6, field_of_view_y=0.6,
                   sky_image="background")
    out, jout = str(tmp_path / "lim.png"), str(tmp_path / "jlim.png")
    run("render", cp, "-o", out)
    jcli.main(["render", cp, "-o", jout])
    img = read_image(out)
    assert img.shape == (16, 16, 3)
    assert img[8, 8].max() < 0.05
    golden_rule(img, read_image(jout), "limited 16x16")


def test_cli_render_limited_jax_surrogate_npz(tmp_path):
    """Twin of test_cli_render_limited_approx_surrogate_npz: a surrogate
    npz the JAX package wrote is the port CLI's learned approx backend,
    and both CLIs render the same frame through it."""
    import jax
    import jax.numpy as jnp

    from blackhole_geodesic_calculator_tpu.models.surrogate import (
        NeuralSurrogate, SurrogateConfig, init_params, save_surrogate)

    scfg = SurrogateConfig(width=32, depth=2, r_influence=10.0)
    sur = NeuralSurrogate(params=init_params(jax.random.PRNGKey(0), scfg),
                          mass=jnp.asarray(0.5), spin=jnp.asarray(0.0),
                          r_influence=jnp.asarray(10.0))
    spath = str(tmp_path / "sur.npz")
    save_surrogate(spath, sur)
    cp = write_cfg(tmp_path, width=12, height=12, engine="limited",
                   approx=True, ratio_obj_to_blackhole=10.0,
                   surrogate_path=spath, camera_location=(0.0, 0.0, 40.0),
                   field_of_view_x=0.6, field_of_view_y=0.6,
                   sky_image="background")
    out, jout = str(tmp_path / "apx.png"), str(tmp_path / "japx.png")
    run("render", cp, "-o", out)
    jcli.main(["render", cp, "-o", jout])
    img = read_image(out)
    assert img.shape == (12, 12, 3)
    golden_rule(img, read_image(jout), "approx 12x12")


ANIM = dict(width=48, height=48, sky_image="background", mass=0.5,
            camera_location=(0.0, 0.0, 15.0), field_of_view_x=0.7,
            field_of_view_y=0.7, n_steps=64, max_integration_step=0.2,
            dt_boost=16.0, dt_boost_r_ref=1.6, dt_power=1.5,
            integration_depth=60.0)


def test_animation_resume_bit_identical(tmp_path):
    """Twin of test_golden_baseline.py::test_animation_resume_bit_identical:
    killing an animation and re-running with --resume yields
    byte-identical frames (through the native FrameWriter where it
    builds); each frame is held to the JAX CLI's by the golden rule and
    equals render_image_u8 of its orbit camera."""
    cfg_path = tmp_path / "scene.json"
    cfg_path.write_text(json.dumps(ANIM))
    pat = str(tmp_path / "f_{frame:02d}.png")
    jpat = str(tmp_path / "j_{frame:02d}.png")

    run("animate", str(cfg_path), "--frames", "2", "--out-pattern", pat)
    frames = [open(pat.format(frame=f), "rb").read() for f in range(2)]
    assert len(frames[0]) > 100 and frames[0] != frames[1]
    jcli.main(["animate", str(cfg_path), "--frames", "2", "--out-pattern",
               jpat])

    os.remove(pat.format(frame=1))
    run("animate", str(cfg_path), "--frames", "2", "--out-pattern", pat,
        "--resume")
    from blackhole_geodesic_calculator_tpu_torch.render import (
        render_image_u8)

    scene, cam, rcfg = build_scene(load_config(str(cfg_path)), device="cpu")
    for f in range(2):
        assert open(pat.format(frame=f), "rb").read() == frames[f], (
            f"frame {f} not bit-identical after resume")
        golden_rule(read_image(pat.format(frame=f)),
                    read_image(jpat.format(frame=f)), f"frame {f}")
        u8 = render_image_u8(scene, cli.orbit_camera(
            cam, (0.0, 0.0, 0.0), 15.0, 2 * np.pi * f / 2), rcfg)
        np.testing.assert_array_equal(png(pat.format(frame=f)), u8.numpy())
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["scene.json", "f_00.png", "f_01.png", "j_00.png", "j_01.png"])


def test_cli_animate_writes_without_the_native_library(tmp_path,
                                                       monkeypatch):
    """Where the native library does not build, animate falls back to
    io_.write_png: the same frames."""
    cfg_path = tmp_path / "scene.json"
    cfg_path.write_text(json.dumps(dict(ANIM, width=16, height=16)))
    run("animate", str(cfg_path), "--frames", "2", "--out-pattern",
        str(tmp_path / "a_{frame}.png"), "--tonemap")
    monkeypatch.setattr(native, "available", lambda: False)
    run("animate", str(cfg_path), "--frames", "2", "--out-pattern",
        str(tmp_path / "b_{frame}.png"), "--tonemap")
    for f in range(2):
        np.testing.assert_array_equal(
            read_image(str(tmp_path / f"a_{f}.png")),
            read_image(str(tmp_path / f"b_{f}.png")))


def test_cli_precompute_camera(tmp_path):
    """Twin of test_cli_render_and_precompute's precompute: the npz of
    both CLIs, hits equal and the ray ends within 1e-3 (positions) and
    1e-4 rad (escape directions) away from b_c."""
    args = ["--res", "8", "--fov", "0.5", "--max-step", "0.3",
            "--curve-end", "60"]
    npz, jnpz = str(tmp_path / "cam.npz"), str(tmp_path / "jcam.npz")
    run("precompute-camera", "-o", npz, *args)
    jcli.main(["precompute-camera", "-o", jnpz, *args])
    with np.load(npz) as z, np.load(jnpz) as jz:
        assert z["ray_end"].shape == (8, 8, 6)
        np.testing.assert_array_equal(z["meta"], jz["meta"])
        np.testing.assert_array_equal(z["ray_blackhole_hit"],
                                      jz["ray_blackhole_hit"])
        esc = z["ray_blackhole_hit"] == 0
        np.testing.assert_allclose(z["ray_end"][esc][:, :3],
                                   jz["ray_end"][esc][:, :3], atol=1e-3)
        d = z["ray_end"][esc][:, 3:].astype(np.float64)
        jd = jz["ray_end"][esc][:, 3:].astype(np.float64)
        ang = np.arctan2(np.linalg.norm(np.cross(d, jd), axis=-1),
                         np.sum(d * jd, -1))
        assert ang.max() < 1e-4


def test_cli_train_surrogate_roundtrip(tmp_path, capsys, monkeypatch):
    """Twin of test_cli_train_surrogate_roundtrip: a few training steps
    against the integrator, the npz saved, and it loads -- in both
    packages -- as a render-ready surrogate.  The held-out evaluation
    runs on 1,024 rays here, not the command's 32,768."""
    from blackhole_geodesic_calculator_tpu.models.surrogate import (
        load_surrogate as jload)
    from blackhole_geodesic_calculator_tpu_torch.models import surrogate
    from blackhole_geodesic_calculator_tpu_torch.models.surrogate import (
        load_surrogate)

    evaluate = surrogate.evaluate_surrogate
    monkeypatch.setattr(surrogate, "evaluate_surrogate",
                        lambda key, sur, cfg, n: evaluate(key, sur, cfg,
                                                          n=1024))
    out = str(tmp_path / "sur.npz")
    run("train-surrogate", "-o", out, "--a", "0.45", "--ratio", "4",
        "--steps", "6", "--batch", "128", "--width", "32", "--depth", "2")
    assert "held-out vs integrator" in capsys.readouterr().out
    sur = load_surrogate(out, device="cpu")
    assert float(sur.spin) == pytest.approx(0.45)
    assert float(sur.r_exit) == pytest.approx(4.4)
    jsur = jload(out)
    for (w, b), (jw, jb) in zip(sur.params, jsur.params):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_cli_profile_train_one_rank(capsys, monkeypatch):
    """profile-train on one rank: the op table, and a collective share of
    0 with no overlap to measure (the twin of
    test_collective_report_no_collectives), both read from the trace by
    utils.profiling, the port's one profiler reader."""
    from blackhole_geodesic_calculator_tpu_torch.utils import profiling

    seen = []
    for name in ("trace", "op_table", "collective_report"):
        real = getattr(profiling, name)

        def spy(*a, _real=real, _name=name, **kw):
            seen.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(profiling, name, spy)
    rep = run("profile-train", "--size", "12", "--steps", "12",
              "--repeats", "1")
    text = capsys.readouterr().out
    assert seen == ["trace", "op_table", "collective_report"]
    assert "per-op device time (top 15)" in text
    assert "wall per step" in text and "0.00% share" in text
    table = text.split("(top 15):")[1].split("collectives:")[0]
    assert profiling.format_op_table([]) in table
    assert len([ln for ln in table.splitlines() if ln.strip()]) >= 5
    assert rep["collective_ms"] == 0 and rep["collective_share"] == 0
    assert math.isnan(rep["overlap_fraction"])


def test_cli_needs_a_card_unless_told(tmp_path):
    """Without --device cpu the CLI runs on the card: on a host without
    CUDA it raises, nothing falls back to the CPU."""
    cp = write_cfg(tmp_path, width=8, height=8, n_steps=8)
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["render", cp, "-o", str(tmp_path / "x.png")])
    assert cli.build_parser().parse_args(["render", cp]).device == "cuda"


def test_cli_module_runs_without_jax(tmp_path):
    """python -m ...cli renders in a fresh process that never imports
    jax or the JAX package."""
    cp = write_cfg(tmp_path, width=8, height=8, n_steps=32,
                   max_integration_step=0.3, sky_image="background")
    code = ("import sys, runpy\n"
            "sys.argv = ['cli', '--device', 'cpu', 'render', sys.argv[1],"
            " '-o', sys.argv[2]]\n"
            "runpy.run_module('blackhole_geodesic_calculator_tpu_torch.cli',"
            " run_name='__main__')\n"
            "assert 'jax' not in sys.modules\n"
            "assert not any(m.split('.')[0] == "
            "'blackhole_geodesic_calculator_tpu' for m in sys.modules)\n")
    out = str(tmp_path / "m.png")
    subprocess.run([sys.executable, "-c", code, cp, out], check=True,
                   cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                   timeout=300)
    assert read_image(out).shape == (8, 8, 3)


def test_packaging_metadata():
    """pyproject.toml names the port's console script beside bhgc-tpu,
    and its native sources as package data."""
    import importlib
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        meta = tomllib.load(f)
    mod, fn = meta["project"]["scripts"]["bhgc-torch"].split(":")
    assert getattr(importlib.import_module(mod), fn) is cli.main
    assert meta["project"]["scripts"]["bhgc-tpu"] == (
        "blackhole_geodesic_calculator_tpu.cli:main")
    data = meta["tool"]["setuptools"]["package-data"][
        "blackhole_geodesic_calculator_tpu_torch.native"]
    assert "src/*.cpp" in data and "src/*.h" in data and "Makefile" in data


def example_render(path, size):
    """The port's own image of an example at ``size``: render_stokes's
    rgb in the white frame for the Stokes example, render_limited for the
    hybrid, render_image for the rest; and the CLI's extra flags."""
    import blackhole_geodesic_calculator_tpu_torch as P
    from blackhole_geodesic_calculator_tpu_torch.io_.config import (
        build_limited)

    cfg = load_config(path)
    cfg.width, cfg.height = size
    scene, cam, rcfg = build_scene(cfg, device="cpu")
    with torch.no_grad():
        if cfg.disk_pol_frac:
            rgb = P.render_stokes(scene, cam, rcfg)[0].numpy()
            img = np.ones((rcfg.height, rcfg.width, 4), np.float32)
            img[..., :3] = rgb
            return img, ["--stokes"]
        if cfg.engine == "limited":
            lcfg, table = build_limited(cfg, device="cpu")
            return P.render_limited(scene, cam, rcfg, lcfg,
                                    table=table).numpy(), []
        return P.render_image(scene, cam, rcfg).numpy(), ["--tonemap"]


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[os.path.basename(p)[:-5] for p in EXAMPLES])
def test_cli_renders_every_example(tmp_path, path):
    """`render` of each shipped example (downscaled) writes the host
    quantization of the port's own render of build_scene(cfg), bit for
    bit (the --tonemap'd examples through io_.tonemap)."""
    size = (20, 16)
    ref, flags = example_render(path, size)
    out = str(tmp_path / "ex.png")
    run("render", path, "-o", out, "--width", str(size[0]), "--height",
        str(size[1]), *flags)
    if "--tonemap" in flags:
        ref = np.concatenate([io_.tonemap(ref[..., :3]), ref[..., 3:]], -1)
    got = png(out)
    assert got.shape == (size[1], size[0], 4)
    np.testing.assert_array_equal(got, quantize(ref))
    assert np.isfinite(ref).all() and ref[..., :3].max() > 0.05
