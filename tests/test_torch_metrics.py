"""PyTorch port against the JAX package: the metric family -- ``Metric``
(g, g_inv, Christoffel symbols by forward-mode AD, the geodesic right-hand
side, the norm, the null k^t), the flat metric, both Schwarzschild charts
and Kerr-Schild Kerr -- and ``convert.metric_from_reference``.

The JAX metric takes one point and is vmapped here; the port's is batched.
Parity: every quantity within 1e-5 of the largest entry of JAX's.  The
twins of tests/test_metrics.py hold the port to the same identities with
the same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu import models as J  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import convert  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import models as T  # noqa: E402

M = 0.5
A = 0.45
RTOL = 1e-5
X4 = np.asarray([0.0, 3.1, -2.2, 1.7], np.float32)
METRICS = {
    "flat": (lambda m: m.flat_metric(), ()),
    "schwarzschild": (lambda m: m.schwarzschild_cartesian_metric(M), (M,)),
    "schwarzschild_ks": (lambda m: m.schwarzschild_ks_metric(M), (M,)),
    "kerr_ks": (lambda m: m.kerr_ks_metric(M, A), (M, A)),
}


def points(n=64, seed=0):
    """n points (t, x) with 2.5 < |x| < 12 (outside both charts' horizons)
    and tangent vectors k4, float32."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x3 = d * rng.uniform(2.5, 12.0, (n, 1))
    x4 = np.concatenate([rng.uniform(-5, 5, (n, 1)), x3], -1)
    k4 = rng.normal(size=(n, 4))
    return x4.astype(np.float32), k4.astype(np.float32)


def close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= RTOL, f"{what}: {err:.2e} of the largest entry"


@pytest.mark.parametrize("name", list(METRICS))
def test_metric_matches_jax(name):
    make, _ = METRICS[name]
    jm, tm = make(J), make(T)
    x4, k4 = points()
    tx, tk = torch.as_tensor(x4), torch.as_tensor(k4)
    jx, jk = jnp.asarray(x4), jnp.asarray(k4)
    close(tm.g(tx), jax.vmap(jm.g)(jx), "g")
    close(tm.g_inv(tx), jax.vmap(jm.g_inv)(jx), "g_inv")
    close(tm.christoffel(tx), jax.vmap(jm.christoffel)(jx), "christoffel")
    kt, dk = tm.geodesic_rhs(tx, tk)
    jkt, jdk = jax.vmap(jm.geodesic_rhs)(jx, jk)
    close(kt, jkt, "geodesic_rhs dx")
    close(dk, jdk, "geodesic_rhs dk")
    close(tm.norm_sq(tx, tk), jax.vmap(jm.norm_sq)(jx, jk), "norm_sq")
    k3 = tk[:, 1:]
    close(tm.null_k_t(tx, k3), jax.vmap(jm.null_k_t)(jx, jk[:, 1:]),
          "null_k_t")
    # the null k^t makes (k^t, k3) null
    k_null = torch.cat([tm.null_k_t(tx, k3)[:, None], k3], -1)
    assert float(tm.norm_sq(tx, k_null).abs().max()) < 1e-4
    # one point without a batch axis gives the batched entry
    close(tm.christoffel(tx[3]), tm.christoffel(tx)[3].numpy(),
          "christoffel of one point")


@pytest.mark.parametrize("name", ["schwarzschild_ks", "kerr_ks"])
def test_christoffel_gradient_matches_jax(name):
    """Autograd reaches the mass (and the spin) through the Christoffel
    symbols as jax.grad does."""
    x4, k4 = points(16, seed=1)
    w = np.random.default_rng(2).normal(size=(16, 4, 4, 4)).astype(
        np.float32)

    def jloss(*params):
        m = getattr(J, f"{name}_metric")(*params)
        return jnp.sum(jax.vmap(m.christoffel)(jnp.asarray(x4)) * w)

    params = (M,) if name == "schwarzschild_ks" else (M, A)
    want = jax.grad(jloss, argnums=tuple(range(len(params))))(*params)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    tm = getattr(T, f"{name}_metric")(*tp)
    torch.sum(tm.christoffel(torch.as_tensor(x4)) * torch.as_tensor(w)
              ).backward()
    for p, g in zip(tp, want):
        np.testing.assert_allclose(float(p.grad), float(g), rtol=1e-4)


def port_metrics():
    return [(name, make(T)) for name, (make, _) in METRICS.items()]


# Twins of tests/test_metrics.py.
@pytest.mark.parametrize("name,metric", port_metrics())
def test_metric_symmetric_and_inverse(name, metric):
    x4 = torch.as_tensor(X4)
    g = metric.g(x4)
    np.testing.assert_allclose(g, g.T, atol=1e-6)
    np.testing.assert_allclose(_matmul(g, metric.g_inv(x4)), np.eye(4),
                               atol=1e-5)


def _matmul(a, b):
    return torch.sum(a[:, :, None] * b[None, :, :], dim=1)


@pytest.mark.parametrize("name,metric", port_metrics())
def test_christoffel_symmetry_and_compatibility(name, metric):
    """Gamma^s_mn = Gamma^s_nm and d_r g_mn = Gamma^s_mr g_sn + Gamma^s_nr
    g_ms."""
    x4 = torch.as_tensor(X4)
    gamma = metric.christoffel(x4)
    np.testing.assert_allclose(gamma, gamma.transpose(1, 2), atol=1e-5)
    dg = torch.func.jacfwd(metric.g)(x4).to(torch.float32)
    g = metric.g(x4)
    recon = (torch.einsum("smr,sn->mnr", gamma, g)
             + torch.einsum("snr,ms->mnr", gamma, g))
    np.testing.assert_allclose(dg, recon, atol=2e-5)


def test_flat_christoffels_vanish():
    gamma = T.flat_metric().christoffel(torch.as_tensor(X4))
    np.testing.assert_allclose(gamma, np.zeros((4, 4, 4)), atol=1e-7)


def test_schwarzschild_on_axis_components():
    """On the +x axis the Cartesian chart is the spherical line element:
    g_tt = -f, g_xx = 1/f, g_yy = g_zz = 1."""
    r = 4.0
    f = 1.0 - 2.0 * M / r
    g = T.schwarzschild_cartesian_metric(M).g(torch.tensor([0.0, r, 0, 0]))
    np.testing.assert_allclose(float(g[0, 0]), -f, rtol=1e-6)
    np.testing.assert_allclose(float(g[1, 1]), 1.0 / f, rtol=1e-6)
    np.testing.assert_allclose(float(g[2, 2]), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(g[3, 3]), 1.0, rtol=1e-6)
    np.testing.assert_allclose(g[0, 1:], np.zeros(3), atol=1e-7)


def test_kerr_reduces_to_schwarzschild_at_zero_spin():
    x4 = torch.as_tensor(X4)
    np.testing.assert_allclose(T.kerr_ks_metric(M, 0.0).g(x4),
                               T.schwarzschild_ks_metric(M).g(x4), atol=1e-6)


def test_ks_radius():
    x3 = torch.as_tensor(X4[1:])
    np.testing.assert_allclose(float(T.ks_radius(x3, 0.0)),
                               float(torch.linalg.norm(x3)), rtol=1e-6)
    np.testing.assert_allclose(
        float(T.ks_radius(torch.tensor([0.0, 0.0, 2.5]), 0.7)), 2.5,
        rtol=1e-6)


def test_horizon_radius():
    np.testing.assert_allclose(float(T.horizon_radius(M, 0.0)), 2 * M,
                               rtol=1e-6)
    np.testing.assert_allclose(float(T.horizon_radius(1.0, 1.0)), 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("name", list(METRICS))
def test_metric_from_reference(name):
    """The JAX metric rebuilt by its name, its params float32 tensors on
    the device asked for; a generic metric has no twin."""
    make, params = METRICS[name]
    tm = convert.metric_from_reference(make(J), device="cpu")
    assert tm.name == name
    assert all(p.dtype == torch.float32 and p.device.type == "cpu"
               for p in tm.params)
    np.testing.assert_allclose([float(p) for p in tm.params], params)
    x4, _ = points(8)
    close(tm.christoffel(torch.as_tensor(x4)),
          jax.vmap(make(J).christoffel)(jnp.asarray(x4)), "christoffel")
    import dataclasses

    with pytest.raises(TypeError, match="no PyTorch twin"):
        convert.metric_from_reference(
            dataclasses.replace(make(J), name="generic"), device="cpu")
