"""PyTorch port against the JAX package: the native runtime library
(``native/``: the float64 oracle, PNG/PFM IO, the async ``FrameWriter``)
and the image IO routed through it.

The port keeps a byte-for-byte copy of the JAX package's C++ sources and
Makefile and builds it into ``build/native/`` at the root of the checkout;
the two libraries, built separately from the same sources with the same
flags, must give the same bits.  The port's plain float32 ``null_init``
and right-hand sides are held to the float64 oracle by
tests/test_native.py's tolerances (:40-74).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu import native as jnative  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import states as jstates  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import io_, native  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import geodesic as g  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import states  # noqa: E402

pytestmark = pytest.mark.skipif(
    not (native.available() and jnative.available()),
    reason="native toolchain unavailable")

REPO = Path(__file__).resolve().parents[1]
JDIR = REPO / "blackhole_geodesic_calculator_tpu" / "native"
PDIR = REPO / "blackhole_geodesic_calculator_tpu_torch" / "native"
STATUS_NAMES = ("ACTIVE", "CAPTURED", "ESCAPED", "BUDGET", "DISK", "OBJECT",
                "INSIDE_HORIZON", "ERROR")


@pytest.mark.parametrize("name", ["src/bgc.h", "src/geodesic.cpp",
                                  "src/image.cpp", "src/writer.cpp",
                                  "Makefile"])
def test_sources_are_the_jax_packages(name):
    assert (PDIR / name).read_bytes() == (JDIR / name).read_bytes()


def test_library_builds_under_build_native():
    """The library is built from the port's sources into build/native/
    at the root of the checkout (listed by .gitignore's build/), not into
    the package."""
    assert native._LIB_PATH == REPO / "build" / "native" / "libbgcnative.so"
    assert native._LIB_PATH.exists()
    assert not (PDIR / "build").exists()
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert native.load_error() is None


@pytest.mark.parametrize("name", STATUS_NAMES)
def test_status_codes_match_states(name):
    assert getattr(native, name) == getattr(states, name)
    assert getattr(native, name) == getattr(jnative, name)
    assert getattr(states, name) == getattr(jstates, name)


def rays(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)) * 4.0
    x[:, 2] += 12.0
    d = rng.normal(size=(n, 3))
    d[:, 2] -= 2.0
    return x, d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("spin", [None, 0.45])
def test_rhs_batch_and_null_init_bitwise(spin):
    x, d = rays(64, 1)
    p = np.random.default_rng(2).normal(size=(64, 3))
    for a, b in zip(native.rhs_batch(x, p, 1.1, 0.5, spin),
                    jnative.rhs_batch(x, p, 1.1, 0.5, spin)):
        np.testing.assert_array_equal(a, b)
    for i in range(8):
        pa, ea = native.null_init(x[i], d[i], 0.5, spin)
        pb, eb = jnative.null_init(x[i], d[i], 0.5, spin)
        np.testing.assert_array_equal(pa, pb)
        assert ea == eb


def test_integrate_batch_bitwise():
    """Photons past a hole with a disk and two spheres: every output of
    the port's library equals the JAX package's bit for bit."""
    x, d = rays(96, 3)
    kw = dict(mass=0.5, r_capture=1.0, r_escape=60.0, lam_max=150.0,
              disk=(2.0, 6.0), spheres=[[3.0, 1.0, -2.0, 0.8],
                                        [-2.0, -3.0, 1.0, 0.6]],
              rtol=1e-8, atol=1e-10, n_threads=2)
    a = native.integrate_batch(x, d, **kw)
    b = jnative.integrate_batch(x, d, **kw)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(set(a["status"].tolist())) >= 3


def test_trajectory_batch_bitwise():
    x0 = np.asarray([[0.0, 5.0, 30.0], [0.0, 2.0, 30.0], [3.0, -4.0, 30.0]])
    d0 = np.tile([0.0, 0.0, -1.0], (3, 1))
    kw = dict(mass=0.5, spin=0.3, r_capture=1.0, r_escape=70.0,
              lam_max=120.0, max_step=0.2, max_points=2000)
    a = native.trajectory_batch(x0, d0, **kw)
    b = jnative.trajectory_batch(x0, d0, **kw)
    n = a["n_points"]
    for k in a:
        if k.startswith("traj_"):   # each ray's valid prefix
            for i in range(3):
                np.testing.assert_array_equal(a[k][i, :n[i]],
                                              b[k][i, :n[i]], err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    tx, tp, tl, st, _ = native.trajectory(x0[0], d0[0], **kw)
    assert st == a["status"][0] and len(tx) == a["n_points"][0]
    np.testing.assert_array_equal(tx, a["traj_x"][0, :len(tx)])


@pytest.mark.parametrize("spin", [None, 0.3, 0.9, -0.5])
def test_plain_rhs_vs_oracle(spin):
    """The port's float32 right-hand side (schwarzschild_rhs, or kerr_rhs
    with a spin) against the float64 oracle's, by test_native.py's
    tolerance."""
    rng = np.random.default_rng(42)
    for _ in range(10):
        x = rng.normal(size=3) * 4.0
        x[2] += 0.5
        p = rng.normal(size=3)
        E = 1.0 + 0.1 * rng.random()
        dxn, dpn = native.rhs(x, p, E, 0.5, spin)
        args = (torch.tensor(x, dtype=torch.float32),
                torch.tensor(p, dtype=torch.float32),
                torch.tensor(E, dtype=torch.float32), torch.tensor(0.5))
        dxt, dpt = (g.schwarzschild_rhs(*args) if spin is None
                    else g.kerr_rhs(*args, torch.tensor(spin)))
        np.testing.assert_allclose(dxn, dxt.numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(dpn, dpt.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("spin", [None, 0.7])
def test_plain_null_init_vs_oracle(spin):
    rng = np.random.default_rng(42)
    x = np.asarray([3.0, 1.5, -2.0])
    xt = torch.tensor(x, dtype=torch.float32)
    a = None if spin is None else torch.tensor(spin)
    for _ in range(5):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        pn, En = native.null_init(x, d, 0.5, spin)
        pt, Et = g.null_init(xt, torch.tensor(d, dtype=torch.float32),
                             torch.tensor(0.5), a)
        np.testing.assert_allclose(pn, pt.numpy(), atol=2e-6)
        assert abs(En - float(Et)) < 2e-6
        # the oracle's state is null under the port's Hamiltonian
        assert abs(float(g.hamiltonian(
            xt, torch.tensor(pn, dtype=torch.float32),
            torch.tensor(En, dtype=torch.float32), torch.tensor(0.5),
            a))) < 1e-5


@pytest.mark.parametrize("channels", [3, 4])
def test_png_roundtrip(tmp_path, channels):
    rng = np.random.default_rng(42)
    img = (rng.random((37, 53, channels)) * 255).astype(np.uint8)
    p = str(tmp_path / "t.png")
    native.write_png(p, img)
    assert np.array_equal(native.read_png(p), img)
    assert np.array_equal(jnative.read_png(p), img)
    q = str(tmp_path / "j.png")
    jnative.write_png(q, img)
    assert Path(p).read_bytes() == Path(q).read_bytes()


def test_pfm_roundtrip(tmp_path):
    img = np.random.default_rng(42).random((21, 17, 3)).astype(np.float32)
    p = str(tmp_path / "t.pfm")
    native.write_pfm(p, img)
    assert np.array_equal(img, native.read_pfm(p))
    assert np.array_equal(img, jnative.read_pfm(p))
    # io_.read_image reads a PFM through the native decoder, clipped
    np.testing.assert_array_equal(io_.read_image(p), np.clip(img, 0, 1))


def test_frame_writer_float_frames(tmp_path):
    frames = [np.full((16, 24, 3), i / 8.0, np.float32) for i in range(8)]
    with native.FrameWriter(threads=3) as fw:
        for i, fr in enumerate(frames):
            fw.submit(str(tmp_path / f"f{i}.png"), fr)
    for i in range(8):
        back = native.read_png(str(tmp_path / f"f{i}.png"))
        expect = np.uint8(np.float32(i / 8.0) * 255 + 0.5)
        assert (back == expect).all()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"f{i}.png" for i in range(8)]


def test_frame_writer_u8_frames(tmp_path):
    """uint8 frames (quantized on the device by render_image_u8) are
    encoded as-is, the same bytes as native.write_png's; srgb on a uint8
    frame is refused."""
    img = np.random.default_rng(3).integers(0, 256, (12, 16, 4),
                                            dtype=np.uint8)
    with native.FrameWriter(threads=2) as fw:
        fw.submit(str(tmp_path / "u8.png"), img)
        with pytest.raises(ValueError):
            fw.submit(str(tmp_path / "x.png"), img, srgb=True)
        with pytest.raises(ValueError):
            fw.submit(str(tmp_path / "y.png"), img[..., 0])
    assert np.array_equal(native.read_png(str(tmp_path / "u8.png")), img)
    native.write_png(str(tmp_path / "direct.png"), img)
    assert (tmp_path / "u8.png").read_bytes() == (
        tmp_path / "direct.png").read_bytes()


def test_read_image_routes_through_native(tmp_path, monkeypatch):
    """io_.write_png keeps its pure-zlib encoder where the library builds
    (a tensor or an array); without PIL, io_.read_image decodes that file
    and the native encoder's through the native decoder."""
    from blackhole_geodesic_calculator_tpu_torch.io_.image import _png_bytes

    assert native.available()
    rng = np.random.default_rng(5)
    img = rng.random((19, 29, 3)).astype(np.float32)
    u8 = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    p = str(tmp_path / "r.png")
    io_.write_png(p, torch.as_tensor(img))
    assert Path(p).read_bytes() == _png_bytes(u8)
    q = str(tmp_path / "n.png")
    native.write_png(q, img)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    for path in (p, q):
        back = io_.read_image(path)
        assert back.shape == (19, 29, 3)
        np.testing.assert_array_equal(back, u8.astype(np.float32) / 255.0)


def test_failed_build_reports_unavailable(tmp_path, monkeypatch):
    """A library that cannot be built leaves available() False and the
    compiler's message in load_error(); io_.write_png still writes, and
    io_.read_image without PIL names the package."""
    from blackhole_geodesic_calculator_tpu_torch.io_.image import _png_bytes

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setattr(native, "_stale", lambda: True)

    def fail():
        raise RuntimeError("make failed (2):\nzlib.h: No such file")

    monkeypatch.setattr(native, "_build", fail)
    assert not native.available()
    assert "zlib.h" in str(native.load_error())
    img = np.random.default_rng(7).integers(0, 256, (5, 6, 3), np.uint8)
    p = io_.write_png(str(tmp_path / "z.png"), img)
    assert Path(p).read_bytes() == _png_bytes(img)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(ImportError, match="pillow"):
        io_.read_image(p)
