"""PyTorch port against the JAX package: the multisampled render and its
outputs -- jittered camera rays, ``render_image`` with samples > 1 and its
gradient, ``render_progressive``, ``render_image_u8``, ``io_.write_png``,
``render_stats`` and ``debug_rays``.

torch's generator cannot reproduce JAX's counter-based draws, so the
port's renders take the JAX package's draws as numpy (``jax_draws``):
``jax.random.uniform(k, (2, Hc, Wc))`` for each key of
``jax.random.split(PRNGKey(cfg.seed), cfg.samples)``, the draws of the JAX
sample scan (renderer.py:159-173).  Images are held to the golden rule of
tests/test_golden.py, gradients to 1e-3 of their largest component as the
1-sample frame's (tests/test_torch_grad.py).
"""

import dataclasses
import os
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu.camera import Camera as JCamera  # noqa: E402
from blackhole_geodesic_calculator_tpu.camera import pinhole as jcam  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import IntegratorConfig as JIntegratorConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import RenderConfig as JRenderConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import debug_rays as jdebug  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import format_debug_string as jformat  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import render_image as jrender  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import render_stats as jstats  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import BlackHole as JBlackHole  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Scene as JScene  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import convert, io_  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import render as R  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.camera import pinhole as tcam  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import geodesic as tgeo  # noqa: E402

RTOL = 1e-5
FLAGSHIP = dict(n_steps=100, dt=0.12, dt_boost=64.0, dt_boost_r_ref=1.7,
                dt_power=1.5)


def sky(h=256, w=512, check=16):
    """bench.py's procedural equirect sky."""
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * u / w) * np.sin(np.pi * v / h),
        v / h, ((u // check + v // check) % 2)], -1).astype(np.float32)


def golden_rule(img, ref, what):
    diff = np.abs(np.asarray(img, np.float32) - np.asarray(ref, np.float32))
    assert diff.mean() < 2e-3, f"{what}: mean drift {diff.mean():.2e}"
    assert (diff > 0.1).mean() < 0.01, (
        f"{what}: {100 * (diff > 0.1).mean():.2f}% of pixels moved > 0.1")


def flagship(size, samples, spin=None, crop=None):
    """bench.py's flagship sky scene, camera and config at ``size``^2 with
    ``samples`` samples per pixel, in the JAX package's classes."""
    scene = JScene(bh=JBlackHole.make(mass=0.5, spin=spin),
                   background=jnp.asarray(sky()))
    cam = JCamera.make(position=(0.0, 0.0, 25.0), euler=(0.1, -0.05, 0.0),
                       fov=(0.8, 0.8))
    cfg = JRenderConfig(width=size, height=size, samples=samples,
                        integrator=JIntegratorConfig(**FLAGSHIP,
                                                     backend="scan"),
                        lam_max=100.0, **(crop or {}))
    return scene, cam, cfg


def port(scene, cam, cfg):
    return (convert.scene_from_reference(scene, device="cpu"),
            convert.camera_from_reference(cam, device="cpu"),
            convert.render_config_from_reference(cfg))


def jax_draws(cfg):
    """The JAX sample scan's jitter draws, (samples, 2, Hc, Wc) float32."""
    x0, x1, y0, y1 = cfg.crop()
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.samples)
    return torch.as_tensor(np.stack([
        np.asarray(jax.random.uniform(k, (2, y1 - y0, x1 - x0)))
        for k in keys]))


@pytest.mark.parametrize("width,height,euler", [
    (16, 16, (0.0, 0.0, 0.0)), (24, 12, (0.3, -0.2, 0.7))])
def test_jittered_rays_match_jax(width, height, euler):
    """generate_rays with one sample's JAX draws against the JAX package's
    jittered rays from that key."""
    pos, fov = (3.0, -2.0, 20.0), (0.8, 0.6)
    key = jax.random.split(jax.random.PRNGKey(7), 3)[1]
    jys, jxs = jcam.pixel_grid(width, height, 2, width - 1, 1, height)
    _, dj = jcam.generate_rays(jcam.Camera.make(pos, euler, fov), width,
                               height, jys, jxs, key)
    u = torch.as_tensor(np.asarray(jax.random.uniform(key, (2,) + jxs.shape)))
    ys, xs = tcam.pixel_grid(width, height, 2, width - 1, 1, height)
    _, d = tcam.generate_rays(tcam.Camera.make(pos, euler, fov, device="cpu"),
                              width, height, ys, xs, u)
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=1e-6)
    _, d0 = tcam.generate_rays(tcam.Camera.make(pos, euler, fov, device="cpu"),
                               width, height, ys, xs)
    assert float((d - d0).abs().max()) > 1e-4      # the jitter moved them


def test_sample_draws_are_seeded():
    """The product path's draws: one seed gives the same draws run after
    run, another seed others; uniform in [0, 1) of the crop's shape."""
    _, _, jcfg = flagship(12, 3, crop=dict(mark_x_min=2, mark_x_max=9,
                                           mark_y_min=4, mark_y_max=10))
    cfg = convert.render_config_from_reference(jcfg)
    a, b = R.sample_draws(cfg, "cpu"), R.sample_draws(cfg, "cpu")
    assert a.shape == (3, 2, 7, 8) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    c = R.sample_draws(dataclasses.replace(cfg, seed=cfg.seed + 1), "cpu")
    assert not torch.equal(a, c)
    assert R.sample_draws(cfg, "cpu", a) is a


def test_render_image_multisample_matches_jax():
    """A 24x24 flagship frame at 4 samples with JAX's draws against the
    JAX package's multisampled render_image."""
    scene, cam, cfg = flagship(24, 4)
    ref = np.asarray(jrender(scene, cam, cfg))
    img = R.render_image(*port(scene, cam, cfg), jax_draws(cfg))
    assert img.shape == (24, 24, 4) and torch.isfinite(img).all()
    golden_rule(img.numpy(), ref, "flagship 24x24, 4 samples")
    one = np.asarray(jrender(scene, cam, dataclasses.replace(cfg, samples=1)))
    assert np.abs(ref - one).mean() > 1e-3      # the samples moved it


def orbit_cam(phi):
    """BASELINE config 4's orbit camera (bench.py bench_animation):
    position (25 sin phi, 0, 25 cos phi), euler (0, phi, 0), fov 0.8."""
    return JCamera.make(position=(25.0 * np.sin(phi), 0.0, 25.0 * np.cos(phi)),
                        euler=(0.0, phi, 0.0), fov=(0.8, 0.8))


def sky_close(a, b, rtol, what):
    """The sky gradient ``a`` against ``b``, each to ``rtol`` of b's largest
    texel: elementwise away from the two texel rows at each pole, and
    there each row's sum over the columns.  A ray that ends near a pole
    reads u = atan2(y, x) of a tiny (x, y): a few float32 ulp move its
    bilinear split between two neighbouring columns, not its row's
    total (the 1-sample frame's pole rays, tests/test_torch_grad.py)."""
    scale = np.abs(b).max()
    assert np.isfinite(a).all() and scale > 0
    inner = np.abs(a[2:-2] - b[2:-2]).max() / scale
    rows = lambda g: np.concatenate([g[:2], g[-2:]]).sum(axis=1)  # noqa
    pole = np.abs(rows(a) - rows(b)).max() / scale
    assert inner <= rtol and pole <= rtol, (
        f"{what}: {inner:.3e} away from the poles, pole rows {pole:.3e}")


def near_b_c(cam, cfg, draws):
    """(H, W) mask of the pixels any of whose sample rays has an impact
    parameter |x cross p| / E in [4.9, 5.5] M, about b_c = 3 sqrt(3) M
    (chip_smoke.py's near_b_c): there one pixel's derivative is ~1e3 times
    the frame's typical one, and two float32 paths part on it by ~1e-3."""
    ys, xs = tcam.pixel_grid(cfg.width, cfg.height)
    near = torch.zeros(ys.shape, dtype=torch.bool)
    for u in draws:
        o, d = tcam.generate_rays(cam, cfg.width, cfg.height, ys, xs, u)
        p, E = tgeo.null_init(o, d, 0.5)
        b = torch.linalg.cross(o, p, dim=-1).norm(dim=-1) / E
        near |= (b >= 4.9 * 0.5) & (b <= 5.5 * 0.5)
    return near


@pytest.mark.parametrize("frame", [0, 1])
def test_render_image_multisample_gradients_match_jax(frame):
    """The gradient of mean(img[..., :3]^2) of a 16x16, 2-sample frame of
    config 4's orbit (frames 0 and 1 of 10) with respect to the mass, the
    camera position and the sky, against jax.grad of the JAX render: over
    the pixels away from b_c (near_b_c) each to 1e-3 of its largest
    component (the sky by sky_close), as tests/test_torch_grad.py holds the
    1-sample frame; over the whole frame, where a jittered ray can land on
    b_c, to chip_smoke.py's 3e-2 for the flagship frame.  Autograd adds
    every sample's part: one sample's sky gradient alone is far off."""
    scene0, _, cfg = flagship(16, 2)
    cam0 = orbit_cam(2 * np.pi * frame / 10)
    scene, cam, tcfg = port(scene0, cam0, cfg)
    draws = jax_draws(cfg)
    calm = (~near_b_c(cam, tcfg, draws)).float()

    def jloss(m, pos, tex, mask):
        scene = JScene(bh=JBlackHole.make(mass=m), background=tex)
        cam = dataclasses.replace(cam0, position=pos)
        return jnp.mean(jrender(scene, cam, cfg)[..., :3] ** 2
                        * mask[..., None])

    leaves = (scene.bh.mass, cam.position, scene.background)
    for t in leaves:
        t.requires_grad_(True)

    def port_grads(mask, draws=draws, cfg=tcfg):
        for t in leaves:
            t.grad = None
        img = R.render_image(scene, cam, cfg, draws)
        (img[..., :3].pow(2) * mask[..., None]).mean().backward()
        return [t.grad.numpy() for t in leaves]

    for mask, rtol in ((calm, 1e-3), (torch.ones_like(calm), 3e-2)):
        jg = [np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.float32(0.5), cam0.position, scene0.background,
            jnp.asarray(mask.numpy()))]
        got = port_grads(mask)
        for what, a, b in zip(("mass", "camera position"), got, jg):
            assert np.isfinite(a).all() and np.abs(b).max() > 0
            err = np.abs(a - b).max() / np.abs(b).max()
            assert err <= rtol, f"{what}: {err:.3e} (limit {rtol:g})"
        sky_close(got[2], jg[2], rtol, "sky")
    assert float(calm.mean()) > 0.9
    # the sky gradient is the sum over both samples' texture lookups
    one = port_grads(calm, None, dataclasses.replace(tcfg, samples=1))
    assert np.abs(one[2] - got[2]).max() > 0.05 * np.abs(got[2]).max()


@pytest.mark.parametrize("samples,crop", [
    (4, None),
    (1, dict(mark_x_min=1, mark_x_max=17, mark_y_min=2, mark_y_max=12))],
    ids=["samples-4", "bands"])
def test_render_progressive_ends_on_render_image(samples, crop):
    """render_progressive's last yield equals render_image within 1e-5:
    sample by sample with the same draws, or band by band (5 bands over
    11 rows: the last one shifted up to end on the crop edge), each band's
    rows equal to the whole frame's."""
    scene, cam, cfg = port(*flagship(18, samples, crop=crop))
    draws = R.sample_draws(cfg, "cpu") if samples > 1 else None
    full = R.render_image(scene, cam, cfg, draws)
    frames = list(R.render_progressive(scene, cam, cfg, draws, row_bands=5))
    assert [i for i, _ in frames] == list(range(len(frames)))
    assert len(frames) == (samples if samples > 1 else 4)
    assert all(f.shape == full.shape for _, f in frames)
    assert float((frames[-1][1] - full).abs().max()) <= 1e-5
    if samples == 1:
        assert torch.equal(frames[-1][1], full)
        # the first band: its rows rendered, the rest still white
        first = frames[0][1]
        assert torch.equal(first[2:5], full[2:5])
        assert torch.equal(first[5:], torch.ones_like(first[5:]))
    else:
        assert not torch.equal(frames[0][1], frames[1][1])


def u8_scene():
    """tests/test_native.py's render_image_u8 scene: a sky with values
    above 1 for the clip and the tonemap."""
    h, w = 16, 32
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    tex = np.stack([2.0 * ((u // 4 + v // 4) % 2), v / h, 0.4 + 0 * u], -1)
    scene = JScene(bh=JBlackHole.make(mass=0.5),
                   background=jnp.asarray(tex, jnp.float32))
    cam = JCamera.make(position=(0.0, 0.0, 15.0), fov=(0.7, 0.7))
    cfg = JRenderConfig(width=24, height=16, samples=2,
                        integrator=JIntegratorConfig(n_steps=60, dt=0.2,
                                                     dt_boost=16.0,
                                                     dt_boost_r_ref=1.6,
                                                     backend="scan"),
                        lam_max=50.0)
    return port(scene, cam, cfg)


def test_render_image_u8_matches_host_quantize():
    """render_image_u8 equals the host quantization of render_image (the
    clip, scale and round of io_.write_png), exactly without the tonemap
    and within one level with it (tests/test_native.py:352-390)."""
    scene, cam, cfg = u8_scene()
    ref = R.render_image(scene, cam, cfg).numpy()
    u8 = R.render_image_u8(scene, cam, cfg)
    assert u8.dtype == torch.uint8 and u8.shape == (16, 24, 4)
    host = (np.clip(ref, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    assert np.array_equal(u8.numpy(), host)
    assert (ref[..., :3] > 1.0).any()
    u8t = R.render_image_u8(scene, cam, cfg, tonemap=True, exposure=1.5)
    rgb = ref[..., :3] * 1.5
    tm = np.concatenate([rgb / (1.0 + rgb), ref[..., 3:]], -1)
    host_t = (np.clip(tm, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    assert np.abs(u8t.numpy().astype(int) - host_t.astype(int)).max() <= 1


def read_png_filter0(path):
    """Decode an 8-bit RGB(A) PNG whose rows all use filter 0 (the port's
    zlib encoder) with zlib alone."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert depth == 8
            shape = (h, w, {2: 3, 6: 4}[color])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        shape[0], 1 + shape[1] * shape[2])
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(shape)


@pytest.mark.parametrize("channels", [3, 4])
def test_write_png_zlib_round_trip(tmp_path, monkeypatch, channels):
    """write_png needs no PIL: the file decodes byte for byte to the
    frame (a uint8 tensor), and no temporary file is left; read_image
    without PIL names the package."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    rng = np.random.default_rng(5)
    img = torch.as_tensor(rng.integers(0, 256, (9, 13, channels),
                                       dtype=np.uint8))
    path = str(tmp_path / "frame.png")
    assert io_.write_png(path, img) == path
    assert os.listdir(tmp_path) == ["frame.png"]
    assert np.array_equal(read_png_filter0(path), img.numpy())
    # a float frame is clipped and rounded as render_image_u8 quantizes
    f = rng.uniform(-0.2, 1.3, (9, 13, channels)).astype(np.float32)
    io_.write_png(path, f)
    assert np.array_equal(read_png_filter0(path),
                          (np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8))
    with pytest.raises(ImportError, match="pillow"):
        io_.read_image(path)


def test_write_png_with_pil_reads_back(tmp_path):
    """With PIL importable write_png still writes the zlib encoder's
    file, and read_image (through PIL) reads it back."""
    pytest.importorskip("PIL")
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    path = io_.write_png(str(tmp_path / "pil.png"), img)
    assert np.array_equal(read_png_filter0(path), img)
    np.testing.assert_array_equal(io_.read_image(path),
                                  img.astype(np.float32) / 255.0)
    np.testing.assert_allclose(io_.tonemap(np.float32([[1.0, 3.0]]), 2.0),
                               [[2 / 3, 6 / 7]], rtol=1e-6)


def stats_scene():
    """tests/test_limited.py's 32x32 frame (:22-35, :153)."""
    h, w = 16, 32
    v = jnp.linspace(0.0, 1.0, h)[:, None]
    u = jnp.linspace(0.0, 1.0, w, endpoint=False)[None, :]
    tex = jnp.stack([jnp.broadcast_to(0.5 + 0.5 * jnp.sin(
        2 * jnp.pi * u) * jnp.sin(jnp.pi * v), (h, w)),
        jnp.broadcast_to(v, (h, w)), 0.5 * jnp.ones((h, w))], -1)
    scene = JScene(bh=JBlackHole.make(mass=0.5), background=tex)
    cam = JCamera.make(position=(0.0, 0.0, 40.0), fov=(0.6, 0.6))
    cfg = JRenderConfig(width=32, height=32, samples=1,
                        integrator=JIntegratorConfig(n_steps=400, dt=0.1,
                                                     backend="scan"),
                        lam_max=200.0)
    return scene, cam, cfg


def test_render_stats_matches_jax():
    """render_stats on tests/test_limited.py's frame: the same counts per
    status, the affine statistics within 1e-3, the same settings."""
    scene, cam, cfg = stats_scene()
    ref = jstats(scene, cam, cfg)
    got = R.render_stats(*port(scene, cam, cfg))
    assert got["rays_total"] == ref["rays_total"] == 32 * 32
    assert got["status"] == ref["status"]
    assert got["status"]["captured"] > 0 and got["status"]["escaped"] > 0
    assert got["rogue_fraction"] == ref["rogue_fraction"]
    assert got["lam_mean"] == pytest.approx(ref["lam_mean"], abs=1e-3)
    assert got["lam_max"] == pytest.approx(ref["lam_max"], abs=1e-3)
    want = dict(ref["settings"], backend="torch")
    assert got["settings"].keys() == want.keys()
    for k, v in want.items():
        if v is None or isinstance(v, (str, bool)):
            assert got["settings"][k] == v, k
        else:
            np.testing.assert_allclose(np.asarray(got["settings"][k], float),
                                       np.asarray(v, float), rtol=1e-6,
                                       err_msg=k)


def debug_scene():
    """tests/test_compat.py's debug_rays frame (:230-260)."""
    v, u = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    tex = jnp.asarray(np.stack([u / 16.0, v / 8.0, 0 * u + 1.0], -1),
                      jnp.float32)
    scene = JScene(bh=JBlackHole.make(mass=0.5), background=tex)
    cam = JCamera.make(position=(0.0, 0.0, 15.0), fov=(0.7, 0.7))
    cfg = JRenderConfig(width=32, height=32,
                        integrator=JIntegratorConfig(n_steps=64, dt=0.2,
                                                     backend="scan"),
                        lam_max=60.0, mark_x_min=14, mark_x_max=17,
                        mark_y_min=15, mark_y_max=16)
    return scene, cam, cfg


@pytest.mark.parametrize("crop", [True, False], ids=["marked", "whole"])
def test_debug_rays_match_jax(crop):
    """debug_rays on tests/test_compat.py's frame (its marked 4x2 pixels,
    and the whole 32x32): the same pixels, statuses and hit ids, origins
    and directions to 1e-5, end directions to 1e-4 (the final directions'
    tolerance of tests/test_torch_integrate.py), end points and lam to
    1e-3; and
    format_debug_string's layout, letter for letter where the numbers
    agree."""
    scene, cam, cfg = debug_scene()
    if not crop:
        cfg = dataclasses.replace(cfg, mark_x_min=-1, mark_x_max=-1,
                                  mark_y_min=-1, mark_y_max=-1)
    ref = jdebug(scene, cam, cfg)
    got = R.debug_rays(*port(scene, cam, cfg))
    assert got.keys() == ref.keys()
    for k in ("ys", "xs", "status", "hit_obj"):
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("origin", "direction"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["end_dir"], ref["end_dir"], atol=1e-4)
    for k in ("end_loc", "lam"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-3, err_msg=k)
    n = len(ref["ys"])
    assert n == (8 if crop else 32 * 32)
    text = R.format_debug_string(got, max_rays=8)
    # the JAX record's numbers in the port's layout: the same text
    assert R.format_debug_string(ref, max_rays=8) == jformat(ref, max_rays=8)
    assert text.count("\n") == 7 and "end_loc=" in text
    for a, b in zip(text.splitlines(), jformat(ref, 8).splitlines()):
        assert a.split(" loc=")[0] == b.split(" loc=")[0]
        assert a.rsplit(" ", 1)[1] == b.rsplit(" ", 1)[1]
