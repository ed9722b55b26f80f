"""PyTorch port against the JAX package: the Gen-1 hybrid renderer --
``render_limited`` (exact, approx through a ``SurrogateTable``,
multisampled, Kerr), ``SurrogateTable.build`` and ``trace``, and the
``convert`` functions of its config and table.

Twins of tests/test_limited.py (but ``test_render_stats``, which
tests/test_torch_multisample.py twins) hold the port to the reference's
own checks; each of their images is also held to the JAX package's
``render_limited`` by the golden rule of tests/test_golden.py (mean drift
< 2e-3, < 1% of pixels moved by > 0.1).  The table is held to JAX's array
by array: b to 1e-6, captured equal, the exit states of the escaping rays
away from the critical impact parameter to 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu.camera import Camera as JCamera  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import IntegratorConfig as JIntegratorConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import limited as JL  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import RenderConfig as JRenderConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import (  # noqa: E402
    BlackHole as JBlackHole, Disk as JDisk, Lights as JLights,
    Scene as JScene, Spheres as JSpheres)
import blackhole_geodesic_calculator_tpu_torch as P  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import convert  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.models.surrogate import init_params  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.render import limited as TL  # noqa: E402


def sky():
    h, w = 16, 32
    v = np.linspace(0.0, 1.0, h)[:, None]
    u = np.linspace(0.0, 1.0, w, endpoint=False)[None, :]
    return np.stack([np.broadcast_to(0.5 + 0.5 * np.sin(
        2 * np.pi * u) * np.sin(np.pi * v), (h, w)),
        np.broadcast_to(v, (h, w)), 0.5 * np.ones((h, w))], -1).astype(
            np.float32)


JCFG = JRenderConfig(width=32, height=32, samples=1,
                     integrator=JIntegratorConfig(n_steps=400, dt=0.1),
                     lam_max=200.0)
JLCFG = JL.LimitedConfig(r_influence=10.0)
JCAM = JCamera.make(position=(0.0, 0.0, 40.0), fov=(0.6, 0.6))


def port(scene, cam, cfg, lcfg):
    return (convert.scene_from_reference(scene, device="cpu"),
            convert.camera_from_reference(cam, device="cpu"),
            convert.render_config_from_reference(cfg),
            convert.limited_config_from_reference(lcfg))


def golden_rule(img, ref, what):
    diff = np.abs(np.asarray(img, np.float32) - np.asarray(ref, np.float32))
    assert diff.mean() < 2e-3, f"{what}: mean drift {diff.mean():.2e}"
    assert (diff > 0.1).mean() < 0.01, (
        f"{what}: {100 * (diff > 0.1).mean():.2f}% of pixels moved > 0.1")


def limited_pair(scene, cam=JCAM, cfg=JCFG, lcfg=JLCFG, what="frame",
                 **kw):
    """The port's render_limited of the JAX objects (carried over by
    convert) and the JAX package's, held to each other by the golden rule;
    returns the port's image as numpy."""
    ref = np.asarray(JL.render_limited(scene, cam, cfg, lcfg))
    img = P.render_limited(*port(scene, cam, cfg, lcfg), **kw)
    assert img.shape == (cfg.height, cfg.width, 4)
    golden_rule(img.numpy(), ref, what)
    return img.numpy()


def red_mask(img):
    return (img[..., 0] > 0.99) & (img[..., 1] < 0.01) & (img[..., 2] < 0.01)


# Twins of tests/test_limited.py, each image also held to JAX's.
def test_limited_basic_shadow_and_background():
    scene = JScene(bh=JBlackHole.make(mass=0.5), background=sky())
    img = limited_pair(scene, what="basic")
    assert np.isfinite(img).all()
    assert img[16, 16, :3].max() < 1e-3
    assert img[0, 0, :3].sum() > 0.05
    assert red_mask(img).sum() == 0


def test_limited_vs_whole_scene_truncation_error():
    """The hybrid's flat space outside the influence sphere drops the
    weak-field deflection there: bounded and small on border rays."""
    scene = JScene(bh=JBlackHole.make(mass=0.5), background=sky())
    img_l = limited_pair(scene, what="truncation")
    s, cam, _, _ = port(scene, JCAM, JCFG, JLCFG)
    img_w = P.render_image(s, cam, convert.render_config_from_reference(
        dataclasses.replace(JCFG, lam_max=300.0))).numpy()
    border = np.ones((32, 32), bool)
    border[6:26, 6:26] = False
    diff = np.abs(img_l[..., :3] - img_w[..., :3])[border]
    assert diff.max() < 0.2
    assert img_w[16, 16, :3].max() < 1e-3
    assert img_l[16, 16, :3].max() < 1e-3


def disk_scene():
    disk_tex = np.broadcast_to(np.asarray([1.0, 0.6, 0.2], np.float32),
                               (8, 32, 3))
    return JScene(bh=JBlackHole.make(mass=0.5), background=sky(),
                  disk=JDisk.make(r_in=2.0, r_out=6.0, texture=disk_tex))


DISK_CAM = JCamera.make(position=(0.0, 12.0, 38.0), euler=(-0.3, 0.0, 0.0),
                        fov=(0.6, 0.6))
STARVED = dataclasses.replace(JCFG, lam_max=3.0, integrator=JIntegratorConfig(
    n_steps=30, dt=0.1))


def test_limited_disk_and_debug_colors():
    scene = disk_scene()
    img = limited_pair(scene, DISK_CAM, what="disk")
    assert np.isfinite(img).all()
    orange = (img[..., 0] > 0.3) & (img[..., 2] < 0.25) & (img[..., 1] > 0.1)
    assert orange.sum() > 10
    # a starved affine budget: RED debug pixels, black without debug colours
    img2 = limited_pair(scene, DISK_CAM, STARVED, what="starved")
    red = red_mask(img2)
    assert red.sum() > 10
    img3 = limited_pair(scene, DISK_CAM, STARVED,
                        dataclasses.replace(JLCFG, debug_colors=False),
                        what="starved, no debug colours")
    assert ((img3[..., :3] == 0).all(-1) & red).sum() == red.sum()


def test_limited_moon_einstein_ring_and_lambert():
    moon_tex = np.broadcast_to(np.asarray([0.2, 1.0, 0.2], np.float32),
                               (1, 8, 8, 3))
    scene = JScene(
        bh=JBlackHole.make(mass=0.5), background=sky(),
        spheres=JSpheres.make(center=[[0.0, 0.0, -20.0]], radius=[1.5],
                              texture=moon_tex))
    img = limited_pair(scene, what="moon")
    green = (img[..., 1] > 0.8) & (img[..., 0] < 0.4)
    ys, xs = np.nonzero(green)
    assert len(ys) > 4
    assert np.sqrt((ys - 16) ** 2 + (xs - 16) ** 2).min() > 1.5

    scene2 = JScene(
        bh=JBlackHole.make(mass=0.5), background=None,
        spheres=JSpheres.make(center=[[5.0, 0.0, 20.0]], radius=[3.0],
                              texture=moon_tex, emission=[0.0],
                              albedo=[[1.0, 0.0, 0.0]]),
        lights=JLights.make(position=[[30.0, 0.0, 40.0]], intensity=10.0))
    img2 = limited_pair(scene2, what="lambert")
    assert (img2[..., 0] > 0.01).sum() > 3


def test_limited_test_output_background():
    scene = JScene(bh=JBlackHole.make(mass=0.5))
    img = limited_pair(scene, lcfg=dataclasses.replace(
        JLCFG, test_output=True), what="test_output")
    assert (img[..., 0] < 1e-6).all()
    assert img[..., 1:3].max() > 0.01


def test_limited_approx_surrogate_mode():
    """approx: the table's shadow and lensing against the exact render;
    the port's table built on the CPU, the frame against JAX's approx
    frame."""
    scene = JScene(bh=JBlackHole.make(mass=0.5), background=sky())
    alcfg = dataclasses.replace(JLCFG, approx=True)
    exact = limited_pair(scene, what="exact")
    approx = limited_pair(scene, lcfg=alcfg, what="approx")
    assert np.isfinite(approx).all()
    assert approx[16, 16, :3].max() < 1e-3
    sh_e = exact[..., :3].max(-1) < 1e-3
    sh_a = approx[..., :3].max(-1) < 1e-3
    assert (sh_e != sh_a).mean() < 0.02
    assert np.median(np.abs(exact[..., :3] - approx[..., :3])) < 0.02


def test_limited_kerr_capture_radius_matches_whole_scene():
    """The hybrid captures at the Kerr outer horizon r_+, so its shadow
    pixel count matches the whole-scene Kerr render's within 4."""
    cam = JCamera.make(position=(0.0, -40.0, 0.0),
                       euler=(np.pi / 2, 0.0, 0.0), fov=(0.25, 0.25))
    cfg = JRenderConfig(width=48, height=48, samples=1,
                        integrator=JIntegratorConfig(n_steps=600, dt=0.05),
                        lam_max=300.0)
    scene = JScene(bh=JBlackHole.make(mass=0.5, spin=0.45),
                   background=sky())
    img_l = limited_pair(scene, cam, cfg, what="Kerr")
    s, tcam, tcfg, _ = port(scene, cam, cfg, JLCFG)
    img_w = P.render_image(s, tcam, tcfg).numpy()
    black_l = int((img_l[..., :3].max(-1) < 1e-3).sum())
    black_w = int((img_w[..., :3].max(-1) < 1e-3).sum())
    assert black_w > 100
    assert abs(black_l - black_w) <= 4, (black_l, black_w)


# Parity of the pieces.
def jax_draws(cfg):
    """The JAX sample scan's jitter draws, (samples, 2, Hc, Wc) float32."""
    x0, x1, y0, y1 = cfg.crop()
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.samples)
    return torch.as_tensor(np.stack([
        np.asarray(jax.random.uniform(k, (2, y1 - y0, x1 - x0)))
        for k in keys]))


def test_multisampled_limited_matches_jax():
    """Three jittered samples of the disk frame on JAX's draws against the
    JAX package's multisampled hybrid, cropped."""
    cfg = dataclasses.replace(JCFG, samples=3, mark_x_min=4, mark_x_max=27,
                              mark_y_min=6, mark_y_max=25)
    img = limited_pair(disk_scene(), DISK_CAM, cfg, what="3 samples",
                       draws=jax_draws(cfg))
    one = P.render_limited(*port(disk_scene(), DISK_CAM,
                                 dataclasses.replace(cfg, samples=1),
                                 JLCFG)).numpy()
    assert np.abs(img - one).mean() > 1e-3          # the samples moved it
    assert (img[:6] == 1.0).all() and (img[:, 28:] == 1.0).all()


def jax_table(mass=0.5, r_influence=10.0):
    return JL.SurrogateTable.build(mass=mass, r_influence=r_influence,
                                   exit_tolerance=0.1)


def test_surrogate_table_build_matches_jax():
    """The port's table (the plain loop on the CPU) against JAX's, array
    by array."""
    jt = jax_table()
    tt = TL.SurrogateTable.build(mass=0.5, r_influence=10.0,
                                 exit_tolerance=0.1, device="cpu")
    assert tt.b.shape == (512,) and tt.captured.dtype == torch.bool
    np.testing.assert_allclose(tt.b.numpy(), np.asarray(jt.b), atol=1e-6)
    np.testing.assert_array_equal(tt.captured.numpy(),
                                  np.asarray(jt.captured))
    b_c = 3.0 * np.sqrt(3.0) * 0.5
    calm = ~tt.captured.numpy() & (np.abs(tt.b.numpy() - b_c) > 0.25)
    assert calm.sum() > 300
    for name in ("end_loc", "end_dir"):
        np.testing.assert_allclose(getattr(tt, name).numpy()[calm],
                                   np.asarray(getattr(jt, name))[calm],
                                   atol=1e-3, err_msg=name)


def test_surrogate_trace_matches_jax():
    """trace on JAX's own table carried over by convert: exit points,
    directions and captures against JAX's trace, radial rays included."""
    jt = jax_table()
    tt = convert.surrogate_table_from_reference(jt, device="cpu")
    rng = np.random.default_rng(4)
    d = rng.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    entry = (-d * 9.999 + rng.normal(size=(256, 3)) * 3.0).astype(np.float32)
    entry[:4] = -d[:4] * 9.999                       # b = 0
    d = d.astype(np.float32)
    want = jt.trace(jnp.asarray(entry), jnp.asarray(d))
    got = tt.trace(torch.as_tensor(entry), torch.as_tensor(d))
    for g, w, name in zip(got, want, ("exit_loc", "exit_dir", "captured")):
        if name == "captured":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                       err_msg=name)


def test_ray_spheres_ties_and_misses_match_jax():
    """_ray_spheres against JAX's: two equal spheres tie (the first index
    wins), starts inside a sphere, misses (-1, inf)."""
    centers = np.asarray([[0.0, 0.0, -5.0], [0.0, 0.0, -5.0],
                          [3.0, 0.0, 0.0]], np.float32)
    radii = np.asarray([1.0, 1.0, 0.5], np.float32)
    o = np.asarray([[0.0, 0.0, 0.0], [3.0, 0.0, 0.2], [0.0, 5.0, 0.0],
                    [0.0, 0.0, -5.0]], np.float32)
    d = np.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0],
                    [1.0, 0.0, 0.0]], np.float32)
    tb, k = TL._ray_spheres(torch.as_tensor(o), torch.as_tensor(d),
                            torch.as_tensor(centers), torch.as_tensor(radii))
    jtb, jk = JL._ray_spheres(jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(centers), jnp.asarray(radii))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jtb), atol=1e-6)
    assert k.tolist() == [0, 2, -1, 0]


def test_approx_needs_a_table_for_a_spinning_hole():
    """approx for a Kerr hole raises ValueError without a table, and takes
    a learned NeuralSurrogate as its table: the Kerr approx frame is
    finite."""
    scene, cam, cfg, lcfg = port(
        JScene(bh=JBlackHole.make(mass=0.5, spin=0.45), background=sky()),
        JCAM, JCFG, dataclasses.replace(JLCFG, approx=True))
    with pytest.raises(ValueError, match="learned surrogate"):
        P.render_limited(scene, cam, cfg, lcfg)
    gen = torch.Generator("cpu")
    gen.manual_seed(0)
    scfg = P.SurrogateConfig(width=32, depth=2, r_influence=lcfg.r_influence)
    sur = P.NeuralSurrogate(init_params(gen, scfg), mass=0.5, spin=0.45,
                            r_influence=scfg.r_influence)
    img = P.render_limited(scene, cam, cfg, lcfg, table=sur)
    assert img.shape == (cfg.height, cfg.width, 4)
    assert bool(torch.isfinite(img).all())


def test_convert_limited_config_and_table():
    """The config field for field; the table float32 with captured kept
    bool (convert's array leaves are float32 otherwise)."""
    lcfg = dataclasses.replace(JLCFG, exit_tolerance=0.2, test_output=True,
                               debug_colors=False, approx=True)
    assert dataclasses.asdict(convert.limited_config_from_reference(
        lcfg)) == dataclasses.asdict(lcfg)
    jt = JL.SurrogateTable(
        b=np.linspace(0.0, 9.0, 5, dtype=np.float32),
        end_loc=np.ones((5, 3), np.float32), end_dir=np.ones((5, 3)),
        captured=np.asarray([True, True, False, False, False]))
    tt = convert.surrogate_table_from_reference(jt, device="cpu")
    assert tt.captured.dtype == torch.bool
    assert tt.captured.tolist() == [True, True, False, False, False]
    for name in ("b", "end_loc", "end_dir"):
        v = getattr(tt, name)
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), getattr(jt, name))
