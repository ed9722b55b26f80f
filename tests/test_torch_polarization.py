"""PyTorch port against the JAX package: polarization -- the closed-form
Schwarzschild transport, ``ks_directional_christoffel``, the 12-ODE
parallel transport of any metric, ``render_stokes`` and
``polarization_map`` (Schwarzschild through the integrator, Kerr through
the transport ODE).

Parity with the JAX functions on the same float32 inputs: the closed forms
to 1e-6, the directional Christoffel contraction to 1e-5 of its largest
entry, the transport ODE's f_obs and d_out to 1e-3 (float32 RK4 paths of
two frameworks part by a few ulp a step near the photon sphere), maps to
1e-3 rad with equal NaN patterns, the Stokes frame by the golden rule of
tests/test_golden.py and Q/U to 1e-3.  The twins of
tests/test_polarization.py (all but the sharded map) hold the port to the
reference's own checks and tolerances.
"""

import dataclasses
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu import models as JM  # noqa: E402
from blackhole_geodesic_calculator_tpu.camera import Camera as JCamera  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import IntegratorConfig as JIntegratorConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import polarization as JP  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import RenderConfig as JRenderConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import polarization_map as jpmap  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import render_stokes as jstokes  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import BlackHole as JBlackHole  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Disk as JDisk  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Scene as JScene  # noqa: E402
import blackhole_geodesic_calculator_tpu_torch as P  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import convert  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import models as TM  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.camera.pinhole import (  # noqa: E402
    euler_matrix, generate_rays, pixel_grid)
from blackhole_geodesic_calculator_tpu_torch.ops import polarization as TP  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import states  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops.integrate import (  # noqa: E402
    final_direction, launch)
from blackhole_geodesic_calculator_tpu_torch.render import renderer as TR  # noqa: E402

M = 0.5
TOL_CLOSED = 1e-6
TOL_ODE = 1e-3


def t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _launch():
    """A photon-sphere-adjacent fan with mixed in/out-of-plane pol."""
    b = np.asarray([3.2, 4.0, 6.0, 9.0])
    n = len(b)
    x3 = np.stack([b, np.zeros(n), np.full(n, 25.0)], -1).astype(np.float32)
    d3 = np.tile([0.0, 0.0, -1.0], (n, 1)).astype(np.float32)
    f3 = np.tile([0.6, 0.8, 0.0], (n, 1)).astype(np.float32)
    f3 = f3 - np.sum(f3 * d3, -1, keepdims=True) * d3
    f3 = f3 / np.linalg.norm(f3, axis=-1, keepdims=True)
    return t(x3), t(d3), t(f3)


def random_rays(n=48, seed=0):
    """Positions, unit directions, unit polarizations orthogonal to them
    and unit escape directions, float32; four of the rays radial."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10, 10, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4] = -x[:4] / np.linalg.norm(x[:4], axis=-1, keepdims=True)
    d[1] = -d[1]
    f = rng.normal(size=(n, 3))
    f -= np.sum(f * d, -1, keepdims=True) * d
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    d1 = d + 0.3 * rng.normal(size=(n, 3))
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    return [a.astype(np.float32) for a in (x, d, f, d1)]


def test_closed_forms_match_jax():
    x, d, f, d1 = random_rays()
    n_t = TP.plane_normal(t(x), t(d))
    assert bool((torch.linalg.norm(n_t[:4] - torch.linalg.cross(
        t(x[:4]), t(d[:4])), dim=-1) > 0.5).all())   # the radial normal
    for got, want in (
            (n_t, JP.plane_normal(jnp.asarray(x), jnp.asarray(d))),
            (TP.transport_polarization(t(x), t(d), t(f), t(d1)),
             JP.transport_polarization(*map(jnp.asarray, (x, d, f, d1)))),
            (TP.polarization_rotation(t(x), t(d), t(d1)),
             JP.polarization_rotation(*map(jnp.asarray, (x, d, d1)))),
            (TP._unit(t(x)), JP._unit(jnp.asarray(x)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL_CLOSED)
    m, jm = TM.kerr_ks_metric(M, 0.45), JM.kerr_ks_metric(M, 0.45)
    x4 = np.concatenate([np.zeros((len(x), 1), np.float32), x], -1)
    k4 = np.concatenate([np.ones((len(x), 1), np.float32), d], -1)
    got = TP._ft_from_orthogonality(m.g(t(x4)), t(k4), t(f))
    want = [JP._ft_from_orthogonality(jm.g(jnp.asarray(a)), jnp.asarray(b),
                                      jnp.asarray(c))
            for a, b, c in zip(x4, k4, f)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=TOL_CLOSED)


@pytest.mark.parametrize("mass,a", [(0.5, 0.45), (0.5, 0.0), (0.5, -0.3)])
def test_ks_directional_christoffel_matches_jax(mass, a):
    rng = np.random.default_rng(3)
    x4 = np.c_[np.zeros(32), rng.uniform(-10, 10, (32, 3))].astype(
        np.float32)
    k4 = rng.normal(size=(32, 4)).astype(np.float32)
    v4 = rng.normal(size=(32, 4)).astype(np.float32)
    got = TP.ks_directional_christoffel(mass, a)(t(x4), t(k4), t(v4))
    con = JP.ks_directional_christoffel(mass, a)
    want = np.stack([np.asarray(con(*map(jnp.asarray, r)))
                     for r in zip(x4, k4, v4)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("spin", [None, 0.45])
def test_transport_ode_matches_jax(spin):
    """The transport ODE on the _launch fan against the JAX package's,
    Schwarzschild and Kerr-Schild Kerr."""
    x3, d3, f3 = _launch()
    kw = dict(n_steps=300, dt=0.1, r_stop=70.0)
    tm = TM.schwarzschild_ks_metric(M) if spin is None else TM.kerr_ks_metric(
        M, spin)
    jm = JM.schwarzschild_ks_metric(M) if spin is None else JM.kerr_ks_metric(
        M, spin)
    f_t, d_t, x_t, diag_t = TP.transport_polarization_ode(tm, x3, d3, f3,
                                                          **kw)
    f_j, d_j, x_j, diag_j = JP.transport_polarization_ode(
        jm, *(jnp.asarray(a.numpy()) for a in (x3, d3, f3)), **kw)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=TOL_ODE)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=TOL_ODE)
    np.testing.assert_array_equal(diag_t["unfinished"].numpy(),
                                  np.asarray(diag_j["unfinished"]))
    assert float(diag_t["fk_drift"].max()) < 1e-4
    assert float(diag_t["norm_drift"].max()) < 1e-3


# Twins of tests/test_polarization.py.
def test_ode_matches_schwarzschild_closed_form():
    x3, d3, f3 = _launch()
    metric = TM.schwarzschild_ks_metric(M)
    f_ode, d_out, _, diag = TP.transport_polarization_ode(
        metric, x3, d3, f3, n_steps=900, dt=0.05, r_stop=70.0)
    assert not diag["unfinished"].any()
    assert float(diag["fk_drift"].max()) < 1e-4
    assert float(diag["norm_drift"].max()) < 1e-3
    f_cf = TP.transport_polarization(x3, d3, f3, d_out)
    dots = np.abs(np.sum(f_ode.numpy() * f_cf.numpy(), -1))
    assert dots.min() > 1.0 - 2e-3, dots


def test_flat_metric_identity():
    x3, d3, f3 = _launch()
    metric = TM.schwarzschild_ks_metric(1e-12)
    f_ode, d_out, _, _ = TP.transport_polarization_ode(
        metric, x3, d3, f3, n_steps=300, dt=0.2, r_stop=70.0)
    np.testing.assert_allclose(d_out.numpy(), d3.numpy(), atol=1e-5)
    np.testing.assert_allclose(f_ode.numpy(), f3.numpy(), atol=1e-4)


def test_kerr_faraday_rotation():
    """An off-equatorial Kerr ray's polarization turns out of the orbital
    plane (gravitational Faraday rotation); a -> 0 removes it."""
    x3 = t([[3.0, 0.5, 25.0]])
    d3 = t([[0.0, 0.0, -1.0]])
    f3 = t([[0.6, 0.8, 0.0]])

    def out_of_plane_drift(spin):
        metric = (TM.kerr_ks_metric(M, spin) if spin else
                  TM.schwarzschild_ks_metric(M))
        f_ode, _, _, diag = TP.transport_polarization_ode(
            metric, x3, d3, f3, n_steps=1200, dt=0.04, r_stop=70.0)
        assert float(diag["fk_drift"].max()) < 1e-4
        n = TP.plane_normal(x3, d3)
        return abs(float(torch.sum(f_ode * n, -1)[0])
                   - float(torch.sum(f3 * n, -1)[0]))

    drift_schw = out_of_plane_drift(0.0)
    drift_kerr = out_of_plane_drift(0.45)
    assert drift_schw < 2e-3, drift_schw
    assert drift_kerr > 10 * max(drift_schw, 1e-4), (drift_kerr, drift_schw)


def map_scene_cam():
    return (P.Scene(bh=P.BlackHole.make(mass=0.5, device="cpu")),
            P.Camera.make(position=(0.0, 0.0, 20.0), fov=(0.7, 0.7),
                          device="cpu"))


def test_polarization_kerr_size_guard(monkeypatch):
    """A large Kerr map warns; a Schwarzschild map never does."""
    monkeypatch.setattr(TR, "_KERR_POLARIZATION_WARN_PIXELS", 32)
    _, cam = map_scene_cam()
    kerr = P.Scene(bh=P.BlackHole.make(mass=0.5, spin=0.3, device="cpu"))
    cfg = P.RenderConfig(width=8, height=8, integrator=P.IntegratorConfig(
        n_steps=60, dt=0.2), lam_max=60.0, r_escape=70.0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        P.polarization_map(kerr, cam, cfg)
    assert any("polarization_map_sharded" in str(x.message) for x in w)
    schw = P.Scene(bh=P.BlackHole.make(mass=0.5, device="cpu"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        P.polarization_map(schw, cam, cfg)
    assert not any("polarization" in str(x.message) for x in w)


GOLDEN_CFG = dict(width=48, height=32, lam_max=80.0)
GOLDEN_INT = dict(n_steps=300, dt=0.1, dt_boost=16.0, dt_boost_r_ref=1.6,
                  dt_power=1.5)


def test_polarization_map_golden():
    """The port's Schwarzschild map against the checked-in golden by the
    reference's rule (NaN pattern equal, mean |d| < 2e-3, < 1% of pixels
    moved by > 0.05), and against the JAX package's map."""
    scene, cam = map_scene_cam()
    cfg = P.RenderConfig(**GOLDEN_CFG,
                         integrator=P.IntegratorConfig(**GOLDEN_INT))
    m = P.polarization_map(scene, cam, cfg).numpy()
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "polarization_schw_48x32.npz")
    with np.load(path) as z:
        ref = z["m"].astype(np.float32)
    cur = m.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(cur))
    diff = np.abs(np.nan_to_num(cur) - np.nan_to_num(ref))
    assert diff.mean() < 2e-3, diff.mean()
    assert (diff > 0.05).mean() < 0.01

    jscene = JScene(bh=JBlackHole.make(mass=0.5))
    jcam = JCamera.make(position=(0.0, 0.0, 20.0), fov=(0.7, 0.7))
    jm = np.asarray(jpmap(jscene, jcam, JRenderConfig(
        **GOLDEN_CFG, integrator=JIntegratorConfig(**GOLDEN_INT,
                                                   backend="scan"))))
    np.testing.assert_array_equal(np.isnan(jm), np.isnan(m))
    np.testing.assert_allclose(np.nan_to_num(m), np.nan_to_num(jm),
                               atol=1e-3)


def test_kerr_polarization_map_matches_jax():
    """The Kerr map (the transport ODE from every pixel) against the JAX
    package's, NaN pattern equal, angles to 1e-3 rad; a crop window maps
    the same pixels."""
    cfg_kw = dict(width=8, height=8, lam_max=80.0, r_escape=70.0)
    int_kw = dict(n_steps=300, dt=0.1, dt_boost=16.0, dt_boost_r_ref=1.6)
    kerr = P.Scene(bh=P.BlackHole.make(mass=0.5, spin=0.3, device="cpu"))
    _, cam = map_scene_cam()
    cfg = P.RenderConfig(**cfg_kw, integrator=P.IntegratorConfig(**int_kw))
    m = P.polarization_map(kerr, cam, cfg).numpy()
    jm = np.asarray(jpmap(
        JScene(bh=JBlackHole.make(mass=0.5, spin=0.3)),
        JCamera.make(position=(0.0, 0.0, 20.0), fov=(0.7, 0.7)),
        JRenderConfig(**cfg_kw, integrator=JIntegratorConfig(
            **int_kw, backend="scan"))))
    assert np.isfinite(m).sum() > 20
    np.testing.assert_array_equal(np.isnan(jm), np.isnan(m))
    np.testing.assert_allclose(np.nan_to_num(m), np.nan_to_num(jm),
                               atol=TOL_ODE)
    crop = P.polarization_map(kerr, cam, dataclasses.replace(
        cfg, mark_x_min=2, mark_x_max=5, mark_y_min=1, mark_y_max=3))
    np.testing.assert_allclose(crop.numpy(), m[1:4, 2:6], atol=1e-6)


def disk_tex():
    return np.broadcast_to(np.asarray([1.0, 0.6, 0.2], np.float32),
                           (8, 32, 3)).copy()


def stokes_scene(pol_frac=0.5):
    return P.Scene(bh=P.BlackHole.make(mass=0.5, device="cpu"),
                   disk=P.Disk.make(r_in=2.0, r_out=6.0, texture=disk_tex(),
                                    pol_frac=pol_frac, device="cpu"))


STOKES_INT = dict(n_steps=250, dt=0.12, dt_boost=16.0, dt_boost_r_ref=1.6,
                  dt_power=1.5)


def stokes_cfg(w=40, h=32):
    return P.RenderConfig(width=w, height=h, lam_max=80.0,
                          integrator=P.IntegratorConfig(**STOKES_INT))


def test_render_stokes_matches_jax():
    """The 40x32 Stokes frame against the JAX package's: rgb by the golden
    rule, Q and U to 1e-3 on the pixels whose status agrees."""
    pos, euler = (0.0, 10.0, 17.0), (-0.53, 0.0, 0.0)
    rgb, Q, U = P.render_stokes(stokes_scene(0.5), P.Camera.make(
        pos, euler, (0.8, 0.8), device="cpu"), stokes_cfg())
    jscene = JScene(bh=JBlackHole.make(mass=0.5), disk=JDisk.make(
        r_in=2.0, r_out=6.0, texture=jnp.asarray(disk_tex()), pol_frac=0.5))
    jrgb, jQ, jU = (np.asarray(a) for a in jstokes(
        jscene, JCamera.make(pos, euler, (0.8, 0.8)), JRenderConfig(
            width=40, height=32, lam_max=80.0, integrator=JIntegratorConfig(
                **STOKES_INT, backend="scan"))))
    assert rgb.shape == (32, 40, 3) and Q.shape == U.shape == (32, 40)
    diff = np.abs(rgb.numpy() - jrgb)
    assert diff.mean() < 2e-3 and (diff > 0.1).mean() < 0.01
    assert (np.hypot(jQ, jU) > 1e-4).sum() > 50
    np.testing.assert_allclose(Q.numpy(), jQ, atol=1e-3)
    np.testing.assert_allclose(U.numpy(), jU, atol=1e-3)


def test_stokes_bounds_and_masks():
    """Q, U only on disk pixels, the polarized intensity bounded by
    pol_frac * luminance; a disk without pol_frac is unpolarized.  The
    rgb is render_image's, bit for bit: the same traced rays, shaded
    alike."""
    scene = stokes_scene(0.5)
    cam = P.Camera.make(position=(0.0, 10.0, 17.0), euler=(-0.53, 0.0, 0.0),
                        fov=(0.8, 0.8), device="cpu")
    cfg = stokes_cfg()
    stokes = P.render_stokes(scene, cam, cfg)
    assert torch.equal(stokes[0], P.render_image(scene, cam, cfg)[..., :3])
    rgb, Q, U = (a.numpy() for a in stokes)
    assert np.isfinite(rgb).all() and np.isfinite(Q).all()
    ip = np.sqrt(Q * Q + U * U)
    lum = rgb.mean(-1)
    assert (ip > 1e-6).any(), "no polarized disk pixels rendered"
    assert (ip <= 0.5 * lum + 1e-5).all()
    scene0 = dataclasses.replace(
        scene, disk=dataclasses.replace(scene.disk, pol_frac=None))
    rgb0, Q0, U0 = (a.numpy() for a in P.render_stokes(scene0, cam, cfg))
    assert np.array_equal(rgb0, rgb)
    assert not Q0.any() and not U0.any()


def test_stokes_roll_covariance():
    """Rolling the camera about its view axis by psi rotates the EVPA by
    -psi: (Q + iU) -> e^{-2 i psi} (Q + iU)."""
    scene = stokes_scene(0.4)
    cam = P.Camera.make(position=(0.0, 12.0, 15.0), euler=(-0.675, 0.0, 0.0),
                        fov=(0.8, 0.8), device="cpu")
    cfg = stokes_cfg(36, 36)
    _, Q1, U1 = (a.numpy() for a in P.render_stokes(scene, cam, cfg))
    psi = 0.37
    r0 = euler_matrix(cam.euler).numpy()
    rz = np.asarray([[np.cos(psi), -np.sin(psi), 0.0],
                     [np.sin(psi), np.cos(psi), 0.0],
                     [0.0, 0.0, 1.0]], np.float32)
    r1 = r0 @ rz
    sy = -r1[2, 0]
    cy = np.sqrt(max(0.0, 1.0 - sy * sy))
    euler2 = [np.arctan2(r1[2, 1], r1[2, 2]), np.arctan2(-r1[2, 0], cy),
              np.arctan2(r1[1, 0], r1[0, 0])]
    cam2 = dataclasses.replace(cam, euler=t(euler2))
    np.testing.assert_allclose(euler_matrix(cam2.euler).numpy(), r1,
                               atol=1e-5)
    _, Q2, U2 = (a.numpy() for a in P.render_stokes(scene, cam2, cfg))
    c = np.s_[10:26, 10:26]
    p1 = np.sqrt(Q1 * Q1 + U1 * U1)[c]
    p2 = np.sqrt(Q2 * Q2 + U2 * U2)[c]
    m = (p1 > 1e-4) & (p2 > 1e-4)
    assert m.sum() > 20
    a1 = np.angle((Q1[c] + 1j * U1[c])[m].sum())
    a2 = np.angle((Q2[c] + 1j * U2[c])[m].sum())
    d = (a2 - a1 + 2.0 * psi + np.pi) % (2.0 * np.pi) - np.pi
    assert abs(d) < 0.12, f"EVPA rotated by {(a2 - a1) / 2:.3f}, want {-psi}"


def test_stokes_angle_matches_ode_transport():
    """The closed-form transported EVPA of the most polarized disk ray
    against the transport ODE from the disk back to the camera, in the
    transport-invariant basis (the bound is the emission frame's O(M/r)
    offset, as in the reference's test), and the camera EVPA against the
    invariant decomposition at the camera ray."""
    scene = stokes_scene(1.0)
    cam = P.Camera.make(position=(0.0, 10.0, 17.0), euler=(-0.53, 0.0, 0.0),
                        fov=(0.8, 0.8), device="cpu")
    cfg = stokes_cfg(24, 20)
    _, Q, U = (a.numpy() for a in P.render_stokes(scene, cam, cfg))
    ip = np.sqrt(Q * Q + U * U)
    iy, ix = np.unravel_index(np.argmax(ip), ip.shape)
    chi_cf = 0.5 * np.arctan2(U[iy, ix], Q[iy, ix])

    env = TR.scene_env(scene, cfg, cam)
    ys, xs = pixel_grid(cfg.width, cfg.height)
    o, d = generate_rays(cam, cfg.width, cfg.height, ys, xs)
    o1, d1 = o[iy, ix][None], d[iy, ix][None]
    s = launch(env, o1, d1, cfg.integrator)
    assert int(s.status[0]) == states.DISK
    k_d = final_direction(env, s).numpy()[0]
    x_d = s.x.numpy()[0]
    f_raw = np.asarray([0.0, 0.0, 1.0]) - k_d * k_d[2]
    f_emit = (f_raw / np.linalg.norm(f_raw)).astype(np.float32)
    f_out, d_out, _, _ = TP.transport_polarization_ode(
        TM.schwarzschild_ks_metric(0.5), t(x_d[None]), t(-k_d[None]),
        t(f_emit[None]), n_steps=4000, dt=0.01,
        r_stop=float(np.linalg.norm(o1[0].numpy())), dt_boost=8.0,
        r_ref=1.6)
    f_out, d_out = f_out.numpy()[0], d_out.numpy()[0]

    def inv_angle(f, k, n):
        n = n / np.linalg.norm(n)
        e = np.cross(k, n)
        e = e / np.linalg.norm(e)
        return np.arctan2(f @ n, f @ e)

    n_pl = np.cross(x_d, -k_d)
    psi_emit = inv_angle(f_emit, -k_d, n_pl)
    psi_ode = inv_angle(f_out, d_out, n_pl)
    dd = (psi_ode - psi_emit + np.pi / 2) % np.pi - np.pi / 2
    r_em = np.linalg.norm(x_d)
    assert abs(dd) < 1.5 * 0.5 / r_em + 0.01, (psi_emit, psi_ode, r_em)

    rot = euler_matrix(cam.euler).numpy()
    n_cf = np.cross(o1[0].numpy(), d1[0].numpy())
    n_cf = n_cf / np.linalg.norm(n_cf)
    e_c = np.cross(d1[0].numpy(), n_cf)
    e_c /= np.linalg.norm(e_c)
    n_u = n_pl / np.linalg.norm(n_pl)
    e_u = np.cross(-k_d, n_pl)
    a = f_emit @ n_u
    b = f_emit @ (e_u / np.linalg.norm(e_u))
    f_cam = a * n_u + b * e_c
    chi_self = np.arctan2(f_cam @ rot[:, 1], f_cam @ rot[:, 0])
    dd = (chi_self - chi_cf + np.pi / 2) % np.pi - np.pi / 2
    assert abs(dd) < 0.03, (chi_cf, chi_self)


def test_ks_directional_christoffel_matches_ad():
    """The analytic contraction equals the AD Christoffel contraction of
    the port's own Metric, for Gamma.k.k and Gamma.k.f, across spins."""
    rng = np.random.default_rng(3)
    for mass, a in ((0.5, 0.45), (0.5, 0.0), (1.0, 0.9), (0.5, -0.3)):
        m = TM.kerr_ks_metric(mass, a)
        con = TP.ks_directional_christoffel(mass, a)
        x4 = t(np.c_[np.zeros(10), rng.uniform(-10, 10, (10, 3))])
        k4 = t(rng.normal(size=(10, 4)))
        f4 = t(rng.normal(size=(10, 4)))
        gam = m.christoffel(x4)
        for v4 in (k4, f4):
            want = torch.einsum("bsmn,bm,bn->bs", gam, k4, v4).numpy()
            got = con(x4, k4, v4).numpy()
            np.testing.assert_allclose(
                got, want, rtol=2e-5,
                atol=2e-5 * max(np.abs(want).max(), 1e-3))


def test_transport_fast_path_matches_generic():
    """A Kerr-Schild metric's analytic contraction and the generic AD
    Christoffel path give the same observables to float32 noise."""
    m = TM.kerr_ks_metric(0.5, 0.45)
    rng = np.random.default_rng(5)
    n = 32
    x3 = np.c_[rng.uniform(4, 9, n), rng.uniform(4, 9, n),
               rng.uniform(-2, 2, n)]
    d3 = rng.normal(size=(n, 3))
    d3 /= np.linalg.norm(d3, axis=-1, keepdims=True)
    f3 = rng.normal(size=(n, 3))
    f3 -= np.sum(f3 * d3, -1, keepdims=True) * d3
    f3 /= np.linalg.norm(f3, axis=-1, keepdims=True)
    kw = dict(n_steps=200, dt=0.1)
    fast = TP.transport_polarization_ode(m, t(x3), t(d3), t(f3), **kw)
    generic = TP.transport_polarization_ode(
        dataclasses.replace(m, name="generic_kerr"), t(x3), t(d3), t(f3),
        **kw)
    np.testing.assert_allclose(fast[0].numpy(), generic[0].numpy(),
                               atol=5e-5)
    np.testing.assert_allclose(fast[1].numpy(), generic[1].numpy(),
                               atol=5e-5)


def test_stokes_from_reference_scene():
    """A JAX Stokes scene carried over by convert keeps its pol_frac."""
    jscene = JScene(bh=JBlackHole.make(mass=0.5), disk=JDisk.make(
        r_in=2.0, r_out=6.0, texture=jnp.asarray(disk_tex()), pol_frac=0.7))
    scene = convert.scene_from_reference(jscene, device="cpu")
    assert float(scene.disk.pol_frac) == pytest.approx(0.7)
    assert scene.disk.pol_frac.device.type == "cpu"
