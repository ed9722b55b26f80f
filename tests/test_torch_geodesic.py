"""PyTorch port against the JAX package: geodesic right-hand sides, camera
rays and the equirect sky lookup.

The same numpy inputs, made from a seed, go through both packages on the
CPU in float32.  Tolerance: rtol 1e-5 -- the two differ only in rsqrt and
summation order, a few ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu.camera import pinhole as jcam  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import geodesic as jgeo  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import texture as jtex  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.camera import pinhole as tcam  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import geodesic as tgeo  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.scene import texture as ttex  # noqa: E402

MASS = 0.5
RTOL = 1e-5


def random_states(n=4096, seed=0):
    """Positions from r ~ 1e-7 (under the r^2 floor) to r ~ 60, momenta of
    unit scale, energies in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = 10.0 ** rng.uniform(-1.0, 1.8, n)
    r[:n // 16] = 10.0 ** rng.uniform(-7.0, -4.0, n // 16)  # near the floor
    x = (u * r[:, None]).astype(np.float32)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    E = rng.uniform(0.5, 1.5, n).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return x, p, E, d


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def close(a, b, rtol=RTOL):
    """rtol against each element, with an absolute floor of rtol times the
    row's largest entry (rows are 3-vectors or scalars) and of 1e-6: an
    output that cancels terms of unit size keeps their rounding, ~1e-7."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(b).max(axis=-1, keepdims=True) if b.ndim > 1 else 0.0
    assert np.isfinite(a).all() and np.isfinite(b).all()
    np.testing.assert_array_less(np.abs(a - b),
                                 rtol * (np.abs(b) + scale) + 1e-6)


@pytest.mark.parametrize("fn", ["schwarzschild_rhs", "xdot", "hamiltonian",
                                "null_init"])
def test_geodesic_matches_jax(fn):
    x, p, E, d = random_states()
    if fn == "schwarzschild_rhs":
        ref = jgeo.schwarzschild_rhs(jnp.asarray(x), jnp.asarray(p),
                                     jnp.asarray(E), MASS)
        got = tgeo.schwarzschild_rhs(t(x), t(p), t(E), MASS)
    elif fn == "xdot":
        ref = (jgeo.xdot(jnp.asarray(x), jnp.asarray(p), jnp.asarray(E),
                         MASS),)
        got = (tgeo.xdot(t(x), t(p), t(E), MASS),)
    elif fn == "hamiltonian":
        ref = (jgeo.hamiltonian(jnp.asarray(x), jnp.asarray(p),
                                jnp.asarray(E), MASS),)
        got = (tgeo.hamiltonian(t(x), t(p), t(E), MASS),)
    else:
        # away from the horizon shell: w divides by 1 - q, which is
        # arbitrarily close to 0 near r = 2M = 1
        r = np.linalg.norm(x, axis=-1)
        keep = (r > 1.2) | (r < 0.8)
        x, d = x[keep], d[keep]
        ref = jgeo.null_init(jnp.asarray(x), jnp.asarray(d), MASS)
        got = tgeo.null_init(t(x), t(d), MASS)
    for r, g in zip(ref, got):
        assert g.dtype == torch.float32
        if fn == "hamiltonian":
            # a difference of squares: rtol against the size of its terms
            x64, p64 = x.astype(np.float64), p.astype(np.float64)
            rr = np.maximum(np.linalg.norm(x64, axis=-1), 1e-6)
            w = E + np.sum(x64 * p64, -1) / rr
            terms = E * E + np.sum(p64 * p64, -1) + 2 * MASS / rr * w * w
            np.testing.assert_array_less(
                np.abs(g.numpy() - np.asarray(r)), RTOL * terms + 1e-6)
        else:
            close(g.numpy(), r)


def test_null_init_inside_horizon_is_finite():
    x = np.array([[0.1, 0.2, -0.3], [0.0, 0.0, 0.5], [0.0, 0.0, 1e-8]],
                 np.float32)
    d = np.array([[0.0, 0.0, -1.0]] * 3, np.float32)
    p, E = tgeo.null_init(t(x), t(d), MASS)
    pj, Ej = jgeo.null_init(jnp.asarray(x), jnp.asarray(d), MASS)
    np.testing.assert_array_equal(E.numpy(), np.asarray(Ej))
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=RTOL)
    assert torch.isfinite(p).all() and torch.isfinite(E).all()


def test_kerr_xdot_matches_jax():
    """The Kerr form of xdot (tests/test_torch_kerr.py holds the rest to
    the JAX package): with a = 0.45 it agrees with JAX's."""
    x, p, E, d = random_states(8)
    x = x * 4.0 + 3.0     # outside the horizon
    ref = jgeo.xdot(jnp.asarray(x), jnp.asarray(p), jnp.asarray(E), MASS,
                    0.45)
    close(tgeo.xdot(t(x), t(p), t(E), MASS, a=torch.tensor(0.45)), ref)


@pytest.mark.parametrize("width,height,euler", [
    (48, 32, (0.35, -0.2, 0.6)),
    (33, 33, (0.0, 0.0, 0.0)),
])
def test_generate_rays_matches_jax(width, height, euler):
    pos, fov = (3.0, -2.0, 20.0), (0.8, 0.6)
    ys, xs = tcam.pixel_grid(width, height, 2, width - 1, 1, height)
    jys, jxs = jcam.pixel_grid(width, height, 2, width - 1, 1, height)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    o, d = tcam.generate_rays(tcam.Camera.make(pos, euler, fov,
                                               device="cpu"), width,
                              height, ys, xs)
    oj, dj = jcam.generate_rays(jcam.Camera.make(pos, euler, fov), width,
                                height, jys, jxs)
    assert d.dtype == torch.float32 and o.shape == d.shape
    np.testing.assert_array_equal(o.numpy(), np.asarray(oj))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(
        tcam.euler_matrix(t(euler)).numpy(),
        np.asarray(jcam.euler_matrix(jnp.asarray(euler, jnp.float32))),
        rtol=RTOL, atol=1e-7)


def test_generate_rays_jitter_raises():
    """Jittered rays run: one sample's draws (u, v) move each direction by
    (u - 0.5) / W and (v - 0.5) * aspect / H as the JAX package's jitter
    does (draws of exactly 0.5 give the pixel centres; JAX's own draws in
    tests/test_torch_multisample.py); draws of the wrong shape, or on
    another device than the camera, raise."""
    width, height, euler = 12, 8, (0.2, -0.1, 0.4)
    cam = tcam.Camera.make((1.0, 2.0, 20.0), euler, (0.9, 0.6), device="cpu")
    ys, xs = tcam.pixel_grid(width, height)
    u = torch.rand((2,) + tuple(xs.shape), generator=torch.Generator()
                   .manual_seed(0))
    _, d = tcam.generate_rays(cam, width, height, ys, xs, u)
    _, d_mid = tcam.generate_rays(cam, width, height, ys, xs,
                                  torch.full_like(u, 0.5))
    _, d0 = tcam.generate_rays(cam, width, height, ys, xs)
    assert torch.equal(d_mid, d0)
    # the JAX package's jittered direction, from the same draws
    jys, jxs = jcam.pixel_grid(width, height)
    aspect = height / width
    xr = 0.9 * (np.asarray(jxs) - width // 2) / width + (u[0].numpy() - 0.5) \
        / width
    yr = 0.6 * (np.asarray(jys) - height // 2) / height * aspect \
        + (u[1].numpy() - 0.5) * aspect / height
    dc = np.stack([xr, yr, -np.ones_like(xr)], -1)
    rot = np.asarray(jcam.euler_matrix(jnp.asarray(euler, jnp.float32)))
    ref = dc @ rot.T
    ref /= np.linalg.norm(ref, axis=-1, keepdims=True)
    np.testing.assert_allclose(d.numpy(), ref, rtol=RTOL, atol=1e-6)
    with pytest.raises(ValueError, match="shape"):
        tcam.generate_rays(cam, width, height, ys, xs, u[:1])
    with pytest.raises(ValueError, match="the camera on"):
        tcam.generate_rays(cam, width, height, ys, xs, u.to("meta"))


def test_sample_equirect_matches_jax():
    rng = np.random.default_rng(3)
    tex = rng.uniform(size=(16, 32, 3)).astype(np.float32)
    d = rng.normal(size=(2000, 3))
    special = np.array([
        [0, 0, 1], [0, 0, -1],                  # poles
        [-1, 0, 0], [-1, 1e-7, 0], [-1, -1e-7, 0],   # the seam, both sides
        [-1, 0.0, 0.3], [-1, -0.0, -0.3],
        [1, 0, 0], [0, 1, 0], [0, -1, 0],       # exactly axial
        [1e-8, 1e-8, 1], [0.6, 0.0, 0.8],
    ], np.float64)
    d = np.concatenate([d, special])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    got = ttex.sample_equirect(t(tex), t(d))
    ref = np.asarray(jtex.sample_equirect(jnp.asarray(tex), jnp.asarray(d)))
    assert got.shape == (len(d), 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=2e-6)


def test_sample_bpy_wraps_like_floor_mod():
    """Columns left of 0 wrap to the right edge (floor-mod, not fmod)."""
    tex = np.arange(4 * 8 * 1, dtype=np.float32).reshape(4, 8, 1)
    x = np.array([-1.3, -1.0, -0.999, 0.999, 1.0, 1.7], np.float32)
    y = np.array([0.9, -1.2, 0.0, 1.5, 0.25, -0.5], np.float32)
    got = ttex.sample_bpy(t(tex), t(x), t(y))
    ref = jtex.sample_bpy(jnp.asarray(tex), jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=1e-5)
