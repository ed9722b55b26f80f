"""PyTorch port against the JAX package: the forward render, end to end.

Scenes, cameras and configs are built with the JAX package and carried over
with ``convert.py``, so both packages render the same data.  Images are held
to the golden rule of tests/test_golden.py: mean |diff| < 2e-3 and fewer
than 1% of pixels off by more than 0.1.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu.camera import Camera as JCamera  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import IntegratorConfig as JIntegratorConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import RenderConfig as JRenderConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import render_image as jrender  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import BlackHole as JBlackHole  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Disk as JDisk  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Scene as JScene  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import convert  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.render.renderer import render_image  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")


def sky(h=32, w=64, check=8):
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * u / w) * np.sin(np.pi * v / h),
        v / h,
        ((u // check + v // check) % 2).astype(np.float32)], -1)


def golden_rule(img, ref, what):
    diff = np.abs(np.asarray(img, np.float32) - np.asarray(ref, np.float32))
    assert diff.mean() < 2e-3, f"{what}: mean drift {diff.mean():.2e}"
    assert (diff > 0.1).mean() < 0.01, (
        f"{what}: {100 * (diff > 0.1).mean():.2f}% of pixels moved > 0.1")


def port(scene, cam, cfg):
    return (convert.scene_from_reference(scene, device="cpu"),
            convert.camera_from_reference(cam, device="cpu"),
            convert.render_config_from_reference(cfg))


def test_golden_schwarzschild_sky():
    """The port's render at the golden config against the checked-in
    tests/golden/schwarzschild_sky.npz (tests/test_golden.py:40-52)."""
    scene = JScene(bh=JBlackHole.make(mass=0.5),
                   background=jnp.asarray(sky(), jnp.float32))
    cam = JCamera.make(position=(0.0, 0.0, 20.0), fov=(0.7, 0.7))
    cfg = JRenderConfig(width=64, height=64, samples=1,
                        integrator=JIntegratorConfig(n_steps=400, dt=0.08,
                                                     backend="scan"),
                        lam_max=120.0)
    tscene, tcam, tcfg = port(scene, cam, cfg)
    assert tcfg.integrator.backend == "torch"
    img = render_image(tscene, tcam, tcfg)
    assert img.shape == (64, 64, 4) and img.dtype == torch.float32
    assert torch.isfinite(img).all()
    with np.load(os.path.join(GOLDEN_DIR, "schwarzschild_sky.npz")) as z:
        ref = z["img"].astype(np.float32)
    golden_rule(img.numpy(), ref, "schwarzschild_sky")


def flagship(size=32, crop=None):
    """bench.py's flagship sky scene, camera and config at ``size``^2."""
    scene = JScene(bh=JBlackHole.make(mass=0.5),
                   background=jnp.asarray(sky(256, 512, 16), jnp.float32))
    cam = JCamera.make(position=(0.0, 0.0, 25.0), fov=(0.8, 0.8))
    cfg = JRenderConfig(
        width=size, height=size, samples=1,
        integrator=JIntegratorConfig(n_steps=100, dt=0.12, dt_boost=64.0,
                                     dt_boost_r_ref=1.7, dt_power=1.5,
                                     backend="scan"),
        lam_max=100.0, **(crop or {}))
    return scene, cam, cfg


@pytest.mark.parametrize("crop", [None, dict(mark_x_min=3, mark_x_max=20,
                                             mark_y_min=9, mark_y_max=29)],
                         ids=["full", "crop"])
def test_flagship_render_matches_jax(crop):
    scene, cam, cfg = flagship(32, crop)
    ref = np.asarray(jrender(scene, cam, cfg))
    img = render_image(*port(scene, cam, cfg)).numpy()
    assert np.isfinite(img).all()
    golden_rule(img, ref, "flagship 32x32")
    if crop:
        np.testing.assert_array_equal(img[:9], 1.0)   # outside the window


def test_convert_carries_trees_as_float32():
    """numpy float64 leaves arrive as float32 tensors; None stays None."""
    scene = JScene(bh=JBlackHole.make(mass=0.5),
                   background=sky().astype(np.float64))
    scene.bh.loc = np.zeros(3)                     # a float64 numpy leaf
    tscene = convert.scene_from_reference(scene, device="cpu")
    assert tscene.disk is None and tscene.spheres is None
    assert tscene.bh.spin is None
    for t in (tscene.background, tscene.bh.mass, tscene.bh.loc):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    disk = JDisk.make(r_in=2.0, r_out=6.0, texture=np.ones((4, 8, 3)))
    tdisk = convert.scene_from_reference(
        dataclasses.replace(scene, disk=disk), device="cpu").disk
    assert tdisk.beaming is None and tdisk.texture.shape == (4, 8, 3)
    cfg = convert.render_config_from_reference(JRenderConfig(
        integrator=JIntegratorConfig(backend="pallas", dt_power=1.5)))
    assert cfg.integrator.backend == "cuda"
    assert cfg.integrator.dt_power == 1.5 and cfg.lam_max == 50.0


def test_out_of_slice_renders_raise():
    """Multisampled renders run, for a Kerr hole too: an 8x8 frame at 2
    samples with the JAX package's draws holds the golden rule against
    the JAX render (Schwarzschild, then a = 0.45); the product path's own
    seeded draws give the same image twice and another than the pixel
    centres.  Draws of the wrong shape or on another device raise."""
    import jax

    scene, cam, cfg = flagship(8)
    cfg = dataclasses.replace(cfg, samples=2)
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), 2)
    draws = torch.as_tensor(np.stack([np.array(jax.random.uniform(k, (2, 8,
                                                                      8)))
                                      for k in keys]))
    spun = dataclasses.replace(scene, bh=JBlackHole.make(mass=0.5,
                                                         spin=0.45))
    for s in (scene, spun):
        tscene, tcam, tcfg = port(s, cam, cfg)
        img = render_image(tscene, tcam, tcfg, draws)
        assert img.shape == (8, 8, 4) and torch.isfinite(img).all()
        golden_rule(img.numpy(), np.asarray(jrender(s, cam, cfg)),
                    "8x8, 2 samples")
    seeded = render_image(tscene, tcam, tcfg)
    assert torch.equal(seeded, render_image(tscene, tcam, tcfg))
    centres = render_image(tscene, tcam, dataclasses.replace(tcfg, samples=1))
    assert not torch.equal(seeded, centres)
    with pytest.raises(ValueError, match="shape"):
        render_image(tscene, tcam, tcfg, draws[:1])
    with pytest.raises(ValueError, match="the camera on"):
        render_image(tscene, tcam, tcfg, draws.to("meta"))


def test_import_leaves_jax_out():
    """The port runs where JAX is not installed: importing it and running
    its CPU render path, for a Schwarzschild and a Kerr hole, with RK4 and
    with Dormand-Prince, multisampled, as uint8 frames written to PNG,
    progressively, its stats and debug dumps and massive particles, must
    not import jax."""
    code = (
        "import sys, torch\n"
        "import blackhole_geodesic_calculator_tpu_torch as P\n"
        "from blackhole_geodesic_calculator_tpu_torch import convert\n"
        "from blackhole_geodesic_calculator_tpu_torch.models import kerr\n"
        "from blackhole_geodesic_calculator_tpu_torch.ops import cuda_kernel\n"
        "for spin in (None, 0.45):\n"
        "    for method in ('rk4', 'dopri'):\n"
        "        s = P.Scene(bh=P.BlackHole.make(spin=spin, device='cpu'),\n"
        "                    background=torch.rand(8, 16, 3))\n"
        "        P.render_image(s, P.Camera.make((0, 0, 20), device='cpu'),\n"
        "                       P.RenderConfig(\n"
        "            width=4, height=4, integrator=P.IntegratorConfig(\n"
        "                n_steps=8, method=method)))\n"
        "from blackhole_geodesic_calculator_tpu_torch import io_, render\n"
        "import tempfile, os\n"
        "cam = P.Camera.make((0, 0, 20), device='cpu')\n"
        "cfg = P.RenderConfig(width=4, height=4, samples=2,\n"
        "                     integrator=P.IntegratorConfig(n_steps=8))\n"
        "u8 = render.render_image_u8(s, cam, cfg, tonemap=True)\n"
        "io_.write_png(os.path.join(tempfile.mkdtemp(), 'f.png'), u8)\n"
        "list(render.render_progressive(s, cam, cfg))\n"
        "render.render_stats(s, cam, cfg)\n"
        "render.format_debug_string(render.debug_rays(s, cam, cfg))\n"
        "env = render.scene_env(s, cfg, cam)\n"
        "P.launch(env, torch.tensor([[5.0, 0, 0]]), torch.tensor([[0, 0.3,\n"
        "         0.0]]), cfg.integrator, time_like=True)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m.startswith('blackhole_geodesic_calculator_tpu.')\n"
        "               or m == 'blackhole_geodesic_calculator_tpu'\n"
        "               for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)
