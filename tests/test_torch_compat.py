"""PyTorch port against the JAX package: the curvedpy-compatible API
(``compat.py``).

Twins of tests/test_compat.py's 11 tests, of
tests/test_timelike.py::test_compat_time_like_api and of
tests/test_surrogate.py::TestCompatProtocol.  Each makes the reference's
own checks and holds the port's result to the JAX compat's on the same
inputs: ``Conversions`` equal; statuses equal; positions within 1e-3;
directions within 1e-4 rad away from the critical impact parameter b_c;
camera npz files written by either package load in the other.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu import compat as J  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import compat as T  # noqa: E402

CPU = dict(device="cpu")
B_C = 3.0 * np.sqrt(3.0) * 0.5   # Schwarzschild b_c at M = 0.5
TOL_X = 1e-3
TOL_DIR = 1e-4


def angle(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1),
                      np.sum(a * b, -1))


def impact(x0, d0):
    x0 = np.asarray(x0, np.float64).reshape(-1, 3)
    d0 = np.asarray(d0, np.float64).reshape(-1, 3)
    d0 = d0 / np.linalg.norm(d0, axis=-1, keepdims=True)
    return np.linalg.norm(np.cross(x0, d0), axis=-1)


def test_conversions_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 3)) * 10
    k = rng.normal(size=(32, 3))
    c, jc = T.Conversions(), J.Conversions()
    sph, ksph = c.convert_xyz_to_sph(x, k)
    jsph, jksph = jc.convert_xyz_to_sph(x, k)
    np.testing.assert_array_equal(sph, jsph)
    np.testing.assert_array_equal(ksph, jksph)
    x2, k2 = c.convert_sph_to_xyz(sph, ksph)
    np.testing.assert_array_equal(x2, jc.convert_sph_to_xyz(sph, ksph)[0])
    np.testing.assert_allclose(x2, x, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(k2, k, rtol=1e-8, atol=1e-10)


def same_trajectory(t, j, x=None):
    """(k, x, result) of the port and of JAX: flags and statuses equal,
    end point and path within TOL_X, end direction within TOL_DIR."""
    (k, xt, res), (jk, jx, jres) = t, j
    assert xt.shape == jx.shape and k.shape == jk.shape
    for key in ("start_inside_hole", "hit_blackhole", "status"):
        np.testing.assert_array_equal(res[key], jres[key], err_msg=key)
    assert set(res) == set(jres)
    np.testing.assert_allclose(res["end_loc"], jres["end_loc"], atol=TOL_X)
    np.testing.assert_allclose(xt, jx, atol=TOL_X)
    esc = ~np.asarray(res["hit_blackhole"])
    assert (angle(res["end_dir"], jres["end_dir"])[esc] < TOL_DIR).all()


def test_calc_trajectory_reference_contract():
    """The call pattern of RelativisticRenderEngine.spacetime_ray_cast
    (:293-308): single ray, unpack (k, x, result), read flags + end state;
    each call against the JAX compat's."""
    gi = T.GeodesicIntegratorSchwarzschild(mass=0.5, time_like=False, **CPU)
    jg = J.GeodesicIntegratorSchwarzschild(mass=0.5, time_like=False)
    kw = dict(k0_xyz=[0.0, 0.0, -1.0], x0_xyz=[8.0, 0.0, 25.0],
              max_step=0.1, curve_end=80.0, nr_points_curve=10000)
    k, x, res = out = gi.calc_trajectory(**kw)
    same_trajectory(out, jg.calc_trajectory(**kw))
    assert x.shape[0] == 3 and k.shape[0] == 3  # (3, T) per ray
    assert not res["start_inside_hole"]
    assert not res["hit_blackhole"]
    assert res["end_loc"].shape == (3,)
    np.testing.assert_allclose(np.linalg.norm(res["end_dir"]), 1.0, atol=1e-5)
    assert res["end_dir"][0] < -1e-3

    # radial infall -> capture; camera inside the horizon
    for args in (([-1.0, 0.0, 0.0], [10.0, 0.0, 0.0], 0.05, 50.0),
                 ([1.0, 0.0, 0.0], [0.3, 0.0, 0.0], 0.05, 10.0)):
        out = gi.calc_trajectory(*args)
        same_trajectory(out, jg.calc_trajectory(*args))
    assert gi.calc_trajectory(*args)[2]["start_inside_hole"]
    # a batch, with nr_points_curve thinning the stored points
    x0 = [[6.0, 0.0, 25.0], [0.0, 9.0, 25.0], [1.0, 0.0, 25.0]]
    d0 = [[0.0, 0.0, -1.0]] * 3
    out = gi.calc_trajectory(d0, x0, 0.1, 60.0, 200)
    same_trajectory(out, jg.calc_trajectory(d0, x0, 0.1, 60.0, 200))
    assert out[1].shape == (3, 3, 200)


def test_sphere_of_influence_ray_trace():
    """Gen-1 call pattern (LimitedRelativisticRenderEngine.py:273-278)."""
    sw = T.SchwarzschildGeodesic(metric="schwarzschild", **CPU)
    jsw = J.SchwarzschildGeodesic(metric="schwarzschild")
    R = 20.0
    loc = [-np.sqrt(R**2 - 25.0), 5.0, 0.0]
    kw = dict(direction=[1.0, 0.0, 0.0], loc_hit=loc, exit_tolerance=0.1,
              ratio_obj_to_blackhole=R, curve_end=sw.approximateCurveEnd(R),
              max_step=0.1)
    x, y, z, end_loc, end_dir, mes = sw.ray_trace(**kw)
    jx, jy, jz, jend_loc, jend_dir, jmes = jsw.ray_trace(**kw)
    assert mes["exited"] and not mes["hit_blackhole"]
    assert np.linalg.norm(end_loc) >= R * 0.99
    assert end_dir[1] < -0.01
    np.testing.assert_allclose(np.linalg.norm(end_dir), 1.0, atol=1e-4)
    assert set(mes) == set(jmes) and mes["status"] == jmes["status"]
    np.testing.assert_allclose(np.stack([x, y, z]), np.stack([jx, jy, jz]),
                               atol=TOL_X)
    np.testing.assert_allclose(end_loc, jend_loc, atol=TOL_X)
    assert angle(end_dir, jend_dir) < TOL_DIR

    # small impact parameter -> capture
    args = ([1.0, 0.0, 0.0], [-np.sqrt(R**2 - 1.0), 1.0, 0.0], 0.1, R,
            sw.approximateCurveEnd(R), 0.05)
    mes2, jmes2 = sw.ray_trace(*args)[-1], jsw.ray_trace(*args)[-1]
    assert mes2["hit_blackhole"] and jmes2["hit_blackhole"]
    assert mes2["status"] == jmes2["status"]


def test_flat_metric_straight_lines():
    """metric='flat' gives straight rays (README.md:233)."""
    sw = T.SchwarzschildGeodesic(metric="flat", **CPU)
    R = 20.0
    loc = [-np.sqrt(R**2 - 25.0), 5.0, 0.0]
    *_, end_loc, end_dir, mes = sw.ray_trace(
        [1.0, 0.0, 0.0], loc, 0.1, R, 60.0, 0.1)
    *_, jend_loc, jend_dir, _ = J.SchwarzschildGeodesic(
        metric="flat").ray_trace([1.0, 0.0, 0.0], loc, 0.1, R, 60.0, 0.1)
    np.testing.assert_allclose(end_dir, [1.0, 0.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(end_loc[1], 5.0, atol=1e-3)
    np.testing.assert_allclose(end_loc, jend_loc, atol=TOL_X)
    assert angle(end_dir, jend_dir) < TOL_DIR


def test_approx_surrogate_matches_ode():
    """ApproxSchwarzschildGeodesic agrees with the real solver away from
    the capture boundary, and its table with the JAX package's: captures
    equal, exit directions within TOL_DIR away from b_c."""
    R = 20.0
    a = T.ApproxSchwarzschildGeodesic(ratio_obj_to_blackhole=R,
                                      exit_tolerance=0.1, n_table=256, **CPU)
    ja = J.ApproxSchwarzschildGeodesic(ratio_obj_to_blackhole=R,
                                       exit_tolerance=0.1, n_table=256)
    np.testing.assert_array_equal(a._b, ja._b)
    np.testing.assert_array_equal(a._captured, ja._captured)
    far = np.abs(a._b - B_C) > 0.1
    assert (angle(a._end_dir, ja._end_dir)[far & ~a._captured]
            < TOL_DIR).all()
    np.testing.assert_allclose(a._end_loc[far], ja._end_loc[far], atol=TOL_X)
    sw = T.SchwarzschildGeodesic(**CPU)
    for b in [4.0, 7.0, 12.0]:
        loc = np.asarray([-np.sqrt(R**2 - b**2), b, 0.0])
        d = np.asarray([1.0, 0.0, 0.0])
        el_a, ed_a, mes_a = a.generatedRayTracer(loc, d)
        *_, el_r, ed_r, mes_r = sw.ray_trace(d, loc, 0.1, R,
                                             sw.approximateCurveEnd(R), 0.05)
        assert bool(mes_a["hit_blackhole"]) == bool(mes_r["hit_blackhole"])
        assert np.dot(ed_a, ed_r) > 0.999
        jel, jed, _ = ja.generatedRayTracer(loc, d)
        assert angle(ed_a, jed) < TOL_DIR
    loc = np.asarray([-R + 0.01, 0.5, 0.0])
    _, _, mes = a.generatedRayTracer(loc, np.asarray([1.0, 0.0, 0.0]))
    assert mes["hit_blackhole"]


def same_camera(cam, jcam, b_band=0.1, max_flips=0):
    """The port's ray field against JAX's: hits equal (but ``max_flips``
    rays by b_c), exit points within TOL_X and directions within TOL_DIR
    on the escaping rays away from b_c."""
    flips = int((cam.ray_blackhole_hit != jcam.ray_blackhole_hit).sum())
    assert flips <= max_flips, f"{flips} rays changed capture"
    env, o, d, _ = cam.setup()
    b = impact(o.reshape(-1, 3).numpy(), d.reshape(-1, 3).numpy()).reshape(
        cam.resolution)
    keep = (np.abs(b / B_C - 1.0) > b_band) & (cam.ray_blackhole_hit == 0) \
        & (jcam.ray_blackhole_hit == 0)
    assert keep.sum() > 0
    np.testing.assert_allclose(cam.ray_end[keep][:, :3],
                               jcam.ray_end[keep][:, :3], atol=TOL_X)
    assert angle(cam.ray_end[keep][:, 3:], jcam.ray_end[keep][:, 3:]).max() \
        < TOL_DIR


def test_relativistic_camera_run_save_load(tmp_path):
    """Gen-3 call pattern (RelativisticRenderEngineCamEdition.py:206-229):
    run, read ray_blackhole_hit / ray_end, persist, reload -- each
    package's file in the other."""
    kw = dict(resolution=(24, 24), field_of_view=(0.5, 0.5), a=0.0,
              camera_location=(0.0, 0.0, 20.0), max_step=0.2,
              curve_end=80.0)
    cam = T.RelativisticCamera(**kw, **CPU).run(verbose=False)
    jcam = J.RelativisticCamera(**kw).run(verbose=False)
    assert cam.ray_blackhole_hit.shape == (24, 24)
    assert cam.ray_blackhole_hit.dtype == jcam.ray_blackhole_hit.dtype
    assert cam.ray_end.shape == (24, 24, 6)
    assert cam.ray_blackhole_hit[12, 12] == 1
    assert cam.ray_blackhole_hit[0, 0] == 0
    dirs = cam.ray_end[..., 3:6]
    norms = np.linalg.norm(dirs[cam.ray_blackhole_hit == 0], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)
    same_camera(cam, jcam)

    p, jp = str(tmp_path / "cam.npz"), str(tmp_path / "jcam.npz")
    cam.save(p)
    jcam.save(jp)
    for path, src in ((p, cam), (jp, jcam)):
        for cls in (T.RelativisticCamera, J.RelativisticCamera):
            cam2 = cls().load(path)
            np.testing.assert_array_equal(cam2.ray_blackhole_hit,
                                          src.ray_blackhole_hit)
            np.testing.assert_array_equal(cam2.ray_end, src.ray_end)
            assert cam2.resolution == (24, 24) and cam2.a == 0.0
            assert cam2.field_of_view == (0.5, 0.5)
            assert cam2.max_step == 0.2 and cam2.curve_end == 80.0


def test_relativistic_camera_kerr():
    """Kerr spin (RelativisticRenderEngineCamEdition.py:216-221): spin
    changes the capture set and runs NaN-free; the Kerr field against
    JAX's away from the photon-orbit band (b in [1, 4] at a/M = 0.9)."""
    kw = dict(resolution=(16, 16), field_of_view=(0.6, 0.6),
              camera_location=(20.0, 0.0, 0.0),
              camera_rotation_euler=(0.0, np.pi / 2, 0.0), max_step=0.2,
              curve_end=80.0)
    cam0 = T.RelativisticCamera(a=0.0, **kw, **CPU).run()
    cam9 = T.RelativisticCamera(a=0.45, **kw, **CPU).run()
    jcam9 = J.RelativisticCamera(a=0.45, **kw).run()
    assert np.isfinite(cam9.ray_end).all()
    assert cam0.ray_blackhole_hit.sum() > 0
    assert (cam0.ray_blackhole_hit != cam9.ray_blackhole_hit).any()
    env, o, d, _ = cam9.setup()
    b = impact(o.reshape(-1, 3).numpy(), d.reshape(-1, 3).numpy()).reshape(
        16, 16)
    far = (b < 1.0) | (b > 4.0)
    np.testing.assert_array_equal(cam9.ray_blackhole_hit[far],
                                  jcam9.ray_blackhole_hit[far])
    esc = far & (cam9.ray_blackhole_hit == 0)
    assert esc.any()
    assert angle(cam9.ray_end[esc][:, 3:], jcam9.ray_end[esc][:, 3:]).max() \
        < TOL_DIR


def test_metric_objects_on_compat_classes():
    """curvedpy's SW.g / SW.gam_y equivalents (README.md:174-186): the
    port's numeric metric and Christoffels against JAX's at the same
    point."""
    import jax.numpy as jnp

    x4 = [0.0, 5.0, 1.0, -2.0]
    xt, xj = torch.tensor(x4), jnp.asarray(x4)
    pairs = [
        (T.GeodesicIntegratorSchwarzschild(mass=0.5, **CPU),
         J.GeodesicIntegratorSchwarzschild(mass=0.5)),
        (T.SchwarzschildGeodesic(metric="flat", **CPU),
         J.SchwarzschildGeodesic(metric="flat")),
        (T.GeodesicIntegratorSchwarzschild(mass=0.5, spin=0.6, **CPU),
         J.GeodesicIntegratorSchwarzschild(mass=0.5, spin=0.6)),
    ]
    for t, j in pairs:
        g, gam = t.g(xt).numpy(), t.gam_y(xt).numpy()
        assert g.shape == (4, 4) and gam.shape == (4, 4, 4)
        np.testing.assert_allclose(g, g.T, atol=1e-6)
        np.testing.assert_allclose(gam, np.swapaxes(gam, 1, 2), atol=1e-5)
        np.testing.assert_allclose(g, np.asarray(j.g(xj)), atol=1e-6)
        np.testing.assert_allclose(gam, np.asarray(j.gam_y(xj)), atol=1e-5)
    flat = pairs[1][0]
    np.testing.assert_allclose(flat.g(xt).numpy(), np.diag([-1.0, 1, 1, 1]),
                               atol=1e-6)
    assert np.abs(flat.gam_y(xt).numpy()).max() < 1e-6


def test_relativistic_camera_render(tmp_path):
    """Gen-3 shading pass (RelativisticRenderEngineCamEdition.py:224-229,
    424-443): black shadow, equirect background, red for a missing
    texture, the test_output gradient; on one ray field (the port's, saved
    and loaded by JAX) both packages shade the same image."""
    kw = dict(resolution=(24, 24), field_of_view=(0.8, 0.8), mass=0.5,
              camera_location=(0.0, 0.0, 15.0), max_step=0.2,
              curve_end=80.0)
    cam = T.RelativisticCamera(**kw, **CPU).run()
    assert cam.ray_blackhole_hit.sum() > 4
    p = cam.save(str(tmp_path / "cam.npz"))
    jcam = J.RelativisticCamera().load(p)

    v, u = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    sky = np.stack([u / 16.0, v / 8.0, np.ones_like(u, float)], -1)
    img = cam.render(background=sky)
    assert img.shape == (24, 24, 4)
    hit = cam.ray_blackhole_hit.astype(bool)
    assert np.abs(img[hit][:, :3]).max() == 0.0
    assert (img[~hit][:, :3].max(-1) > 0.0).all()
    np.testing.assert_allclose(img, jcam.render(background=sky), atol=1e-6)

    red = cam.render(background=None)
    np.testing.assert_array_equal(red, jcam.render(background=None))
    expect = np.broadcast_to(np.asarray([1.0, 0.0, 0.0], np.float32),
                             red[~hit][:, :3].shape)
    np.testing.assert_allclose(red[~hit][:, :3], expect, atol=0)
    dbg = cam.render(test_output=True)
    assert np.isfinite(dbg).all() and dbg[..., :3].max() <= 1.0
    np.testing.assert_allclose(dbg, jcam.render(test_output=True),
                               atol=1e-7)


def test_texture_registry():
    """Twin of test_compat.py::test_texture_registry through the exports
    the compat layer's callers use."""
    from blackhole_geodesic_calculator_tpu.scene import load_all as jload
    from blackhole_geodesic_calculator_tpu_torch.scene import (
        TEXTURES, load_all, load_texture)

    assert {"background", "moon", "test", "disk_clouds"} <= set(TEXTURES)
    tex = load_texture("background", size=(64, 128))
    assert load_texture("background", size=(64, 128)) is tex
    allt, jallt = load_all(), jload()
    assert set(allt) == set(jallt) == set(TEXTURES)
    for name in allt:
        np.testing.assert_array_equal(allt[name], jallt[name])
    with pytest.raises(KeyError):
        load_texture("nope")


def test_debug_rays_crop():
    """Twin of test_compat.py::test_debug_rays_crop: the marked pixels'
    records against the JAX package's."""
    import jax.numpy as jnp

    import blackhole_geodesic_calculator_tpu_torch as P
    from blackhole_geodesic_calculator_tpu.camera import Camera as JCamera
    from blackhole_geodesic_calculator_tpu.ops import IntegratorConfig as JIC
    from blackhole_geodesic_calculator_tpu.render import (
        RenderConfig as JRC, debug_rays as jdebug)
    from blackhole_geodesic_calculator_tpu.scene import (
        BlackHole as JBH, Scene as JScene)
    from blackhole_geodesic_calculator_tpu_torch.ops import states
    from blackhole_geodesic_calculator_tpu_torch.render import (
        debug_rays, format_debug_string)

    v, u = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    sky = np.stack([u / 16.0, v / 8.0, 0 * u + 1.0], -1).astype(np.float32)
    marks = dict(mark_x_min=14, mark_x_max=17, mark_y_min=15, mark_y_max=16)
    rec = debug_rays(
        P.Scene(bh=P.BlackHole.make(mass=0.5, **CPU),
                background=torch.as_tensor(sky)),
        P.Camera.make(position=(0.0, 0.0, 15.0), fov=(0.7, 0.7), **CPU),
        P.RenderConfig(width=32, height=32, lam_max=60.0,
                       integrator=P.IntegratorConfig(n_steps=64, dt=0.2),
                       **marks))
    jrec = jdebug(JScene(bh=JBH.make(mass=0.5), background=jnp.asarray(sky)),
                  JCamera.make(position=(0.0, 0.0, 15.0), fov=(0.7, 0.7)),
                  JRC(width=32, height=32, lam_max=60.0,
                      integrator=JIC(n_steps=64, dt=0.2), **marks))
    assert len(rec["ys"]) == 4 * 2
    assert rec["xs"].min() == 14 and rec["xs"].max() == 17
    assert (rec["status"] == states.CAPTURED).any()
    np.testing.assert_array_equal(rec["status"], jrec["status"])
    np.testing.assert_allclose(rec["end_loc"], jrec["end_loc"], atol=TOL_X)
    s = format_debug_string(rec)
    assert "end_loc=" in s and s.count("\n") == 7


def test_compat_time_like_api():
    """Twin of test_timelike.py::test_compat_time_like_api: a massive
    circular orbit at r = 8 M against the JAX compat's."""
    M = 0.5
    gi = T.GeodesicIntegratorSchwarzschild(mass=M, time_like=True, **CPU)
    jg = J.GeodesicIntegratorSchwarzschild(mass=M, time_like=True)
    r0 = 8.0 * M
    omega = np.sqrt(M / r0**3)
    ut = 1.0 / np.sqrt(1.0 - 3.0 * M / r0)
    args = ([0.0, r0 * omega * ut, 0.0], [r0, 0.0, 0.0])
    kw = dict(max_step=0.05, curve_end=40.0, r_escape=50.0)
    k, xtraj, res = out = gi.calc_trajectory(*args, **kw)
    same_trajectory(out, jg.calc_trajectory(*args, **kw))
    assert not res["start_inside_hole"]
    assert not res["hit_blackhole"]
    r = np.linalg.norm(xtraj, axis=0)
    assert abs(r.max() - r0) < 2e-2 and abs(r.min() - r0) < 2e-2

    with pytest.raises(ValueError, match="null"):
        T.GeodesicIntegratorSchwarzschild(mass=M, time_like=True,
                                          backend="native", **CPU)


def test_compat_native_backend():
    """calc_trajectory(backend='native') serves the reference contract;
    the f64 oracle and the port's float32 loop agree on the capture of a
    short fan (tests/test_native.py::test_compat_native_backend's bar),
    and 'jax' names the torch backend."""
    from blackhole_geodesic_calculator_tpu_torch import native

    if not native.available():
        pytest.skip("native toolchain unavailable")
    gn = T.GeodesicIntegratorSchwarzschild(mass=0.5, backend="native", **CPU)
    gt = T.GeodesicIntegratorSchwarzschild(mass=0.5, backend="jax", **CPU)
    assert gt.backend == "torch"
    k, x, res = gn.calc_trajectory([0.0, 0.0, -1.0], [2.0, 0.0, 30.0],
                                   max_step=0.1, curve_end=300.0)
    assert res["hit_blackhole"]
    assert x.shape[0] == 3 and x.shape[1] > 10
    jk, jx, jres = J.GeodesicIntegratorSchwarzschild(
        mass=0.5, backend="native").calc_trajectory(
            [0.0, 0.0, -1.0], [2.0, 0.0, 30.0], max_step=0.1,
            curve_end=300.0)
    np.testing.assert_array_equal(x, jx)
    b = np.asarray([1.0, 2.0, 2.4, 2.8, 3.5, 6.0])
    x0 = np.stack([b, np.zeros_like(b), np.full_like(b, 30.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (len(b), 1))
    _, xs, rn = gn.calc_trajectory(d0, x0, max_step=0.1, curve_end=300.0)
    _, _, rt = gt.calc_trajectory(d0, x0, max_step=0.05, curve_end=300.0)
    assert isinstance(xs, list) and len(xs) == len(b)
    np.testing.assert_array_equal(rn["hit_blackhole"], rt["hit_blackhole"])
    np.testing.assert_array_equal(rn["hit_blackhole"], b < B_C)
    with pytest.raises(ValueError, match="backend"):
        T.GeodesicIntegratorSchwarzschild(backend="scan", **CPU)


class TestCompatProtocol:
    def test_approx_kerr_generated_ray_tracer(self, tmp_path):
        """compat.ApproxKerrGeodesic mirrors the reference surrogate call
        ``aSW.generatedRayTracer(loc_hit, direction)``
        (LimitedRelativisticRenderEngine.py:269) for a spinning hole, with
        npz persistence standing in for the reference's reload semantics
        (:96-101); trained from a torch.Generator its draws are not JAX's,
        so it is held to the JAX test's bars -- and a model the JAX
        package saved traces the same through both."""
        path = tmp_path / "kerr_sur.npz"
        ak = T.ApproxKerrGeodesic(
            ratio_obj_to_blackhole=10.0, mass=0.5, a=0.45,
            train_steps=4, batch=128, width=32, depth=2,
            save_path=path, **CPU)
        end_loc, end_dir, mes = ak.generatedRayTracer(
            [-10.0, 1.0, 0.5], [1.0, 0.0, 0.0])
        assert end_loc.shape == (3,) and end_dir.shape == (3,)
        assert set(mes) == {"hit_blackhole", "start_inside_hole"}
        ak2 = T.ApproxKerrGeodesic(ratio_obj_to_blackhole=10.0, mass=0.5,
                                   a=0.45, load_path=path, **CPU)
        el2, ed2, _ = ak2.generatedRayTracer(
            np.asarray([[-10.0, 1.0, 0.5]]), np.asarray([[1.0, 0.0, 0.0]]))
        np.testing.assert_allclose(el2[0], end_loc, atol=1e-6)
        np.testing.assert_allclose(ed2[0], end_dir, atol=1e-6)
        with pytest.raises(ValueError, match="ratio_obj_to_blackhole"):
            T.ApproxKerrGeodesic(ratio_obj_to_blackhole=12.0, mass=0.5,
                                 a=0.45, load_path=path, **CPU)

        import jax

        from blackhole_geodesic_calculator_tpu.models import surrogate as JS

        jpath = str(tmp_path / "jax_sur.npz")
        cfg = JS.SurrogateConfig(width=32, depth=2, r_influence=10.0)
        JS.save_surrogate(jpath, JS.NeuralSurrogate(
            params=JS.init_params(jax.random.PRNGKey(1), cfg),
            mass=np.float32(0.5), spin=np.float32(0.45),
            r_influence=np.float32(10.0), r_exit=np.float32(11.0)))
        loc = np.asarray([[-10.0, 1.0, 0.5], [-9.0, -3.0, 2.0]])
        d = np.asarray([[1.0, 0.0, 0.0], [0.9, 0.3, -0.1]])
        tl, td, tm = T.ApproxKerrGeodesic(
            ratio_obj_to_blackhole=10.0, mass=0.5, a=0.45,
            load_path=jpath, **CPU).generatedRayTracer(loc, d)
        jl, jd, jm = J.ApproxKerrGeodesic(
            ratio_obj_to_blackhole=10.0, mass=0.5, a=0.45,
            load_path=jpath).generatedRayTracer(loc, d)
        np.testing.assert_allclose(tl, jl, atol=1e-4)
        np.testing.assert_allclose(td, jd, atol=1e-5)
        np.testing.assert_array_equal(tm["hit_blackhole"],
                                      jm["hit_blackhole"])
