"""PyTorch port against the JAX package: disk and sphere events, forward
and gradient, and the disk and sphere shaders.

The event path renders BASELINE config 3 (a z = 0 disk and textured moons,
bench.py:126-141).  Inputs are made from numpy seeds and fed to both
packages.  Covered, module by module:

* ops/integrate.py -- ``_disk_event``, ``_sphere_events`` (misses, grazes,
  ties, both crossing directions) and one ``_fixed_step`` with a disk and
  two spheres; twins of tests/test_pallas.py's forward parity tests;
* ops/adjoint.py -- the hand-written transpose of the event tail, against
  ``jax.vjp`` of the TPU kernel's ``_soa_step``, its ``_step_adjoint`` and
  ``torch.autograd`` of the port's ``_fixed_step``;
* gradients of the integrator and of whole renders against ``jax.grad``;
* scene/texture.py ``sphere_uv_bpy`` and scene/shading.py, forward and
  gradient; the goldens ``einstein_ring`` and ``disk_and_moons``.

Tolerances are the port's: statuses and hit ids equal, x and lam within
1e-3, p within 1e-4; single VJPs to 1e-5 of the largest value (readings
<= 6e-7); integrator and render gradients to 1e-3 of the largest value
unless a case says why not; images to the golden rule.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu.camera import Camera as JCamera  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import IntegratorConfig as JIntegratorConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import pallas_kernel as jpk  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import states as jstates  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops.geodesic import null_init as jnull  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import RenderConfig as JRenderConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import render_image as jrender  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import BlackHole as JBlackHole  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Disk as JDisk  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Lights as JLights  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Scene as JScene  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Spheres as JSpheres  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import shading as jshading  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import texture as jtexture  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import convert  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import adjoint, cuda_kernel  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import integrate as tint  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import states as tstates  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops.geodesic import null_init as tnull  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.render.renderer import render_image  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.scene import shading as tshading  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.scene import texture as ttexture  # noqa: E402

# the JAX package's ops/__init__ exports a function named ``integrate``
jint = importlib.import_module("blackhole_geodesic_calculator_tpu.ops.integrate")

POWERS = [1.5, 1.0, 2.0, 1.3]
TOL_X, TOL_P = 1e-3, 1e-4
CFG64 = dict(n_steps=64, dt=0.1)          # tests/test_pallas.py's CFG
# [mass, dt, dt_boost, r_ref, r_capture, r_escape, lam_max, r_in, r_out, a]
SCAL = np.array([0.5, 0.12, 64.0, 1.7, 1.0, 70.0, 100.0, 2.0, 6.0, 0.0],
                np.float32)
SPH = np.array([[4.0, 0.0, 0.3, 1.0], [-3.0, 3.0, 0.0, 1.2],
                [0.0, -5.0, 0.5, 0.8]], np.float32)


def T(a):
    return torch.as_tensor(np.array(a))


def close(a, b, rtol, what):
    """|a - b| <= rtol * max|b|, elementwise; both finite."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert np.isfinite(a).all() and np.isfinite(b).all(), what
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= rtol, f"{what}: {err:.3e} > {rtol:g}"


def envs(centers, radii, disk=True, mass=0.5, r_escape=60.0, lam_max=50.0,
         r_capture=None):
    """The same environment in both packages (tests/test_pallas.py's
    make_env by default)."""
    r_capture = 2.0 * mass if r_capture is None else r_capture
    kw = dict(r_capture=r_capture, r_escape=r_escape, lam_max=lam_max)
    jenv = jint.GeodesicEnv(
        mass=jnp.float32(mass), **{k: jnp.float32(v) for k, v in kw.items()},
        disk=jint.DiskGeom(r_in=jnp.float32(2.0), r_out=jnp.float32(6.0))
        if disk else None,
        spheres=None if centers is None else jint.SphereGeom(
            center=jnp.asarray(centers, jnp.float32),
            radius=jnp.asarray(radii, jnp.float32)))
    tenv = tint.GeodesicEnv(
        mass=torch.tensor(mass), **{k: torch.tensor(v) for k, v in kw.items()},
        disk=tint.DiskGeom(r_in=torch.tensor(2.0), r_out=torch.tensor(6.0))
        if disk else None,
        spheres=None if centers is None else tint.SphereGeom(
            center=T(np.asarray(centers, np.float32)),
            radius=T(np.asarray(radii, np.float32))))
    return jenv, tenv


def rays(n=1500, seed=0):
    """tests/test_pallas.py's rays: from z = 25 towards the hole."""
    rng = np.random.default_rng(seed)
    x0 = np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                   np.full(n, 25.0)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  np.full(n, -1.0)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x0, d.astype(np.float32)


def assert_states_agree(js, ts, min_events=1):
    st = np.asarray(js.status)
    np.testing.assert_array_equal(ts.status.numpy(), st)
    np.testing.assert_array_equal(ts.hit_obj.numpy(), np.asarray(js.hit_obj))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=TOL_X)
    np.testing.assert_allclose(ts.lam.numpy(), np.asarray(js.lam), rtol=0,
                               atol=TOL_X)
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), rtol=0,
                               atol=TOL_P)
    assert (st == jstates.DISK).sum() >= min_events
    assert (st == jstates.OBJECT).sum() >= min_events


# =============================================================================
# Segment events.
# =============================================================================
def segments(n=3000, seed=0):
    """Segments near the disk plane: crossings in both directions, ends
    exactly on z = 0, and ones that stay on one side."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.5, 8.0, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    x0 = np.stack([r * np.cos(ph), r * np.sin(ph),
                   rng.uniform(-1.0, 1.0, n)], -1)
    x1 = x0 + rng.normal(scale=1.0, size=(n, 3))
    x0[:100, 2] = 0.0                       # starts on the plane
    x1[100:200, 2] = 0.0                    # ends on the plane
    return x0.astype(np.float32), x1.astype(np.float32)


def test_disk_event_matches_jax():
    jenv, tenv = envs(None, None)
    x0, x1 = segments()
    w = np.random.default_rng(1).normal(size=x0.shape).astype(np.float32)

    def jf(a, b):
        t, pt = jint._disk_event(jenv, a, b)
        return t, jnp.sum(jnp.where(jnp.isfinite(t)[:, None], w * pt, 0.0))

    (jt, jl), vjp = jax.vjp(jf, jnp.asarray(x0), jnp.asarray(x1))
    jg0, jg1 = vjp((jnp.zeros_like(jt), jnp.float32(1.0)))
    a, b = T(x0).requires_grad_(True), T(x1).requires_grad_(True)
    t, pt = tint._disk_event(tenv, a, b)
    hit = torch.isfinite(t)
    torch.where(hit[:, None], T(w) * pt, 0.0).sum().backward()
    jt = np.asarray(jt)
    np.testing.assert_array_equal(hit.numpy(), np.isfinite(jt))
    assert 300 < hit.sum() < 2900
    down = (x0[:, 2] >= 0) & (x1[:, 2] < 0)
    assert (hit.numpy() & down).any() and (hit.numpy() & ~down).any()
    close(t.detach()[hit], jt[np.isfinite(jt)], 1e-6, "t")
    np.testing.assert_array_equal(pt.detach()[hit][:, 2].numpy(), 0.0)
    close(a.grad, jg0, 1e-5, "d x0")
    close(b.grad, jg1, 1e-5, "d x1")


def sphere_segments(case, n=2000, seed=2):
    """Segments against the spheres of SPH: random (hits and misses),
    grazing (closest approach within 1e-3 of the radius, both sides) and
    ties (a sphere listed twice)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, len(SPH), n)
    c, rad = SPH[k, :3], SPH[k, 3]
    if case == "graze":
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        v = np.cross(u, rng.normal(size=(n, 3)))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        dist = rad * (1.0 + rng.uniform(-1e-3, 1e-3, n))
        mid = c + dist[:, None] * u
        x0 = mid - 1.5 * rad[:, None] * v
        x1 = mid + 1.5 * rad[:, None] * v
    else:
        x0 = c + rng.normal(scale=2.0, size=(n, 3))
        x1 = x0 + (c - x0) * rng.uniform(0.2, 1.5, (n, 1)) + rng.normal(
            scale=0.5, size=(n, 3))
    sph = np.concatenate([SPH, SPH[:1]]) if case == "tie" else SPH
    return x0.astype(np.float32), x1.astype(np.float32), sph


@pytest.mark.parametrize("case", ["random", "graze", "tie"])
def test_sphere_events_match_jax(case):
    x0, x1, sph = sphere_segments(case)
    jenv, tenv = envs(sph[:, :3], sph[:, 3], disk=False)
    w = np.random.default_rng(3).normal(size=x0.shape).astype(np.float32)

    def jf(a, b, c, r):
        env = dataclasses.replace(jenv, spheres=jint.SphereGeom(center=c,
                                                                radius=r))
        t, pt, obj = jint._sphere_events(env, a, b)
        return jnp.sum(jnp.where(jnp.isfinite(t)[:, None], w * pt, 0.0)), (
            t, obj)

    jl, vjp, (jt, jobj) = jax.vjp(jf, jnp.asarray(x0), jnp.asarray(x1),
                                  jnp.asarray(sph[:, :3]),
                                  jnp.asarray(sph[:, 3]), has_aux=True)
    jg = vjp(jnp.float32(1.0))
    leaves = [T(v).requires_grad_(True)
              for v in (x0, x1, sph[:, :3].copy(), sph[:, 3].copy())]
    env = dataclasses.replace(tenv, spheres=tint.SphereGeom(
        center=leaves[2], radius=leaves[3]))
    t, pt, obj = tint._sphere_events(env, leaves[0], leaves[1])
    hit = torch.isfinite(t)
    torch.where(hit[:, None], T(w) * pt, 0.0).sum().backward()
    np.testing.assert_array_equal(obj.numpy(), np.asarray(jobj))
    assert 0 < int(hit.sum()) < len(t)
    if case == "tie":   # the duplicate of sphere 0 never wins
        assert (obj.numpy() == 0).any() and not (obj.numpy() == 3).any()
    close(t.detach()[hit], np.asarray(jt)[hit.numpy()], 1e-5, "t")
    grads = [leaves[i].grad.numpy() for i in range(4)]
    jg = [np.asarray(v).copy() for v in jg]
    if case == "tie":
        # jnp.min splits the gradient of a tie between the tied spheres;
        # the port's torch.min, like the TPU kernel's strict "t < ts"
        # selection, gives it all to the lowest index: the twins' sum
        # agrees
        for v in jg[2:]:
            v[0] += v[3]
            v[3] = 0.0
    for i, what in enumerate(("x0", "x1", "center", "radius")):
        close(grads[i], jg[i], 1e-5, f"d {what}")


def step_state(n=4000, seed=0):
    """Rays near the disk plane and the spheres of SPH, with random
    directions: one step ends a fair share of them on the disk or a
    sphere.  A tenth are frozen (ESCAPED)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.8, 8.0, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    x = np.stack([r * np.cos(ph), r * np.sin(ph), rng.uniform(-0.6, 0.6, n)],
                 -1).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p, E = jnull(jnp.asarray(x), jnp.asarray(d, jnp.float32),
                 jnp.float32(0.5))
    status = np.where(rng.random(n) < 0.1, jstates.ESCAPED,
                      jstates.ACTIVE).astype(np.int32)
    g = rng.normal(size=(6, n)).astype(np.float32)
    return x.T.copy(), np.asarray(p).T.copy(), np.asarray(E), status, g


def test_fixed_step_matches_jax():
    """One step of the plain loop with a disk and two spheres against the
    JAX package's _fixed_step, including where the event rays freeze."""
    x, p, E, status, _ = step_state()
    jenv, tenv = envs(SPH[:2, :3], SPH[:2, 3], r_escape=70.0,
                      lam_max=100.0)
    cfg = dict(n_steps=1, dt=0.12, dt_boost=64.0, dt_boost_r_ref=1.7,
               dt_power=1.5)
    js0 = jstates.init_state(jnp.asarray(x.T), jnp.asarray(p.T),
                             jnp.asarray(E))
    js0.status = jnp.asarray(status)
    js = jint._fixed_step(jenv, jint.IntegratorConfig(**cfg), js0)
    ts0 = tstates.init_state(T(x.T), T(p.T), T(E))
    ts0.status = T(status)
    ts = tint._fixed_step(tenv, tint.IntegratorConfig(**cfg), ts0)
    assert_states_agree(js, ts, min_events=20)
    disk = ts.status == tstates.DISK
    assert (ts.x[disk][:, 2] == 0).all()
    assert (ts.hit_obj[ts.status == tstates.OBJECT] >= 0).all()


# =============================================================================
# The plain integrator against the JAX package.
# =============================================================================
def port_state(tenv, x0, d0):
    p0, E0 = tnull(x0, d0, tenv.mass)
    s0 = tstates.init_state(x0, p0, E0)
    s0.status = s0.status.masked_fill(tenv.radius(x0) <= tenv.r_capture,
                                      tstates.INSIDE_HORIZON)
    return s0


@pytest.mark.parametrize("reference", ["scan", "pallas"])
def test_forward_parity(reference):
    """Twin of tests/test_pallas.py::test_forward_parity: the disk and a
    sphere of radius 3 at (2, 0, 10), 1500 rays, 64 steps of 0.1, against
    the JAX scan path and the TPU kernel K1 in interpret mode (whose sphere
    guard fires)."""
    jenv, tenv = envs([[2.0, 0.0, 10.0]], [3.0])
    x0, d0 = rays()
    cfg = jint.IntegratorConfig(**CFG64)
    if reference == "scan":
        js = jint.launch(jenv, jnp.asarray(x0), jnp.asarray(d0), cfg)
    else:
        p0, E0 = jnull(jnp.asarray(x0), jnp.asarray(d0), jenv.mass)
        js = jpk.integrate_pallas(jenv, jstates.init_state(
            jnp.asarray(x0), p0, E0), cfg, interpret=True)
    ts = tint.launch(tenv, T(x0), T(d0), tint.IntegratorConfig(**CFG64))
    assert_states_agree(js, ts, min_events=40)


def test_forward_parity_guard_stress():
    """Twin of the Schwarzschild half of
    tests/test_pallas.py::test_forward_parity_guard_stress: spheres where
    the TPU kernel's conservative guard is tightest (at the photon sphere
    and far out, where the r^1.5 schedule makes steps long), against K1 in
    interpret mode."""
    jenv, tenv = envs([[0.0, 2.6, 0.0], [0.0, 0.0, 30.0]], [0.7, 2.0],
                      disk=False, r_escape=60.0, lam_max=60.0,
                      r_capture=1.0)
    x0, d0 = rays(1200, seed=7)
    cfg = dict(CFG64, dt_boost=64.0, dt_power=1.5, dt_boost_r_ref=1.7)
    p0, E0 = jnull(jnp.asarray(x0), jnp.asarray(d0), jenv.mass)
    js = jpk.integrate_pallas(jenv, jstates.init_state(jnp.asarray(x0), p0,
                                                       E0),
                              jint.IntegratorConfig(**cfg), interpret=True)
    ts = cuda_kernel.integrate_plain(tenv, port_state(tenv, T(x0), T(d0)),
                                     tint.IntegratorConfig(**cfg))
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_array_equal(ts.hit_obj.numpy(), np.asarray(js.hit_obj))
    assert int((ts.status == tstates.OBJECT).sum()) >= 2


# =============================================================================
# ops/adjoint.py: the transpose of the event tail.
# =============================================================================
@pytest.mark.parametrize("power", POWERS)
def test_step_adjoint_with_events_matches_jax(power):
    """adjoint.step_adjoint with the disk and three spheres against the TPU
    kernel's _step_adjoint (which takes jax.vjp of _events_merge) and
    against jax.vjp of _soa_step(...)[:6] itself."""
    x, p, E, status, g = step_state()
    n = len(E)
    xp = tuple(jnp.asarray(v) for v in (*x, *p, E))
    zeros, obj = jnp.zeros(n), jnp.full(n, -1, jnp.int32)
    kw = dict(has_disk=True, n_sph=len(SPH), power=power)
    st1 = np.asarray(jpk._soa_step(xp, zeros, jnp.asarray(status), obj,
                                   jnp.asarray(SCAL), jnp.asarray(SPH),
                                   **kw)[2])
    assert (st1 == jstates.DISK).sum() > 50
    assert (st1 == jstates.OBJECT).sum() > 20
    jg6, jgE, jgscal, jgsph = jpk._step_adjoint(
        xp, zeros, jnp.asarray(status), obj, jnp.asarray(SCAL),
        jnp.asarray(SPH), tuple(map(jnp.asarray, g)), kerr=False,
        enabled=jnp.bool_(True), **kw)

    def step6(x6, E_, scal, sph):
        out = jpk._soa_step((*x6, E_), zeros, jnp.asarray(status), obj,
                            scal, sph, **kw)
        return out[0][:6]

    _, vjp = jax.vjp(step6, xp[:6], xp[6], jnp.asarray(SCAL),
                     jnp.asarray(SPH))
    vg6, vgE, vgscal, vgsph = vjp(tuple(map(jnp.asarray, g)))
    g6, gE, gscal, gsph = adjoint.step_adjoint(
        tuple(map(T, x)), tuple(map(T, p)), T(E), T(status), T(SCAL),
        tuple(map(T, g)), power, sph=T(SPH), has_disk=True)
    for ref6, refE, refscal, refsph, what in (
            (jg6, jgE, jgscal, jgsph, "_step_adjoint"),
            (vg6, vgE, vgscal, vgsph, "jax.vjp of _soa_step")):
        for i in range(6):
            close(g6[i], ref6[i], 1e-5, f"{what}: d(x, p)[{i}]")
        close(gE, refE, 1e-5, f"{what}: dE")
        close(gscal[:4], np.asarray(refscal)[:4], 1e-5, f"{what}: dscal")
        close(gsph, refsph, 1e-5, f"{what}: dsph")
    np.testing.assert_array_equal(gscal[4:].numpy(), 0.0)


@pytest.mark.parametrize("power", POWERS)
def test_step_adjoint_with_events_matches_autograd(power):
    """adjoint.step_adjoint with events against torch.autograd of the
    port's _fixed_step: cotangents of x, p, E, the mass and the sphere
    centres and radii."""
    x, p, E, status, g = step_state(seed=5)
    mass = torch.tensor(0.5, requires_grad=True)
    center = T(SPH[:, :3].copy()).requires_grad_(True)
    radius = T(SPH[:, 3].copy()).requires_grad_(True)
    env = tint.GeodesicEnv(
        mass=mass, r_capture=torch.tensor(1.0), r_escape=torch.tensor(70.0),
        lam_max=torch.tensor(100.0),
        disk=tint.DiskGeom(r_in=torch.tensor(2.0), r_out=torch.tensor(6.0)),
        spheres=tint.SphereGeom(center=center, radius=radius))
    cfg = tint.IntegratorConfig(n_steps=1, dt=0.12, dt_boost=64.0,
                                dt_boost_r_ref=1.7, dt_power=power)
    xl, pl, El = (T(x.T.copy()).requires_grad_(True),
                  T(p.T.copy()).requires_grad_(True), T(E).requires_grad_(True))
    s = tstates.init_state(xl, pl, El)
    s.status = T(status)
    s1 = tint._fixed_step(env, cfg, s)
    gt = T(g)
    ((s1.x * gt[:3].T).sum() + (s1.p * gt[3:].T).sum()).backward()
    assert int((s1.status == tstates.OBJECT).sum()) > 20
    scal = cuda_kernel._scalars(env, cfg, torch.device("cpu")).detach()
    sph = cuda_kernel._sphere_table(env, torch.device("cpu")).detach()
    g6, gE, gscal, gsph = adjoint.step_adjoint(
        tuple(map(T, x)), tuple(map(T, p)), T(E), T(status), scal,
        tuple(map(T, g)), power, sph=sph, has_disk=True)
    close(torch.stack(g6[:3], -1), xl.grad, 1e-5, "dx")
    close(torch.stack(g6[3:], -1), pl.grad, 1e-5, "dp")
    close(gE, El.grad, 1e-5, "dE")
    close(gscal[0], mass.grad, 1e-5, "dmass")
    close(gsph[:, :3], center.grad, 1e-5, "dcenter")
    close(gsph[:, 3], radius.grad, 1e-5, "dradius")


# =============================================================================
# Integrator gradients.
# =============================================================================
def test_adjoint_matches_scan_autodiff():
    """Twin of tests/test_pallas.py::test_adjoint_matches_scan_autodiff:
    the mass, the sphere's cz, x0 and d0 against jax.grad of the JAX
    integrate_fixed, for the loss of test_pallas.py:82-92."""
    x0, d0 = rays(1024, seed=1)
    wx = np.random.default_rng(2).normal(size=(1024, 3)).astype(np.float32)

    def jloss(mass, cz, x0_, d0_):
        env = jint.GeodesicEnv(
            mass=mass, r_capture=2.0 * mass, r_escape=jnp.float32(60.0),
            lam_max=jnp.float32(50.0),
            disk=jint.DiskGeom(r_in=jnp.float32(2.0), r_out=jnp.float32(6.0)),
            spheres=jint.SphereGeom(
                center=jnp.stack([jnp.float32(2.0), jnp.float32(0.0),
                                  cz])[None], radius=jnp.asarray([3.0])))
        p0, E0 = jnull(x0_, d0_, env.mass)
        s = jint.integrate_fixed(env, jstates.init_state(x0_, p0, E0),
                                 jint.IntegratorConfig(**CFG64))
        ok = ((s.status != jstates.CAPTURED)
              & (s.status != jstates.ERROR))[..., None]
        return jnp.sum(jnp.where(ok, wx * s.x, 0.0))

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.float32(0.5), jnp.float32(10.0), jnp.asarray(x0),
        jnp.asarray(d0))
    mass = torch.tensor(0.5, requires_grad=True)
    cz = torch.tensor(10.0, requires_grad=True)
    xl, dl = T(x0).requires_grad_(True), T(d0).requires_grad_(True)
    env = tint.GeodesicEnv(
        mass=mass, r_capture=2.0 * mass, r_escape=torch.tensor(60.0),
        lam_max=torch.tensor(50.0),
        disk=tint.DiskGeom(r_in=torch.tensor(2.0), r_out=torch.tensor(6.0)),
        spheres=tint.SphereGeom(
            center=torch.stack([torch.tensor(2.0), torch.tensor(0.0),
                                cz])[None], radius=torch.tensor([3.0])))
    s = tint.integrate(env, port_state(env, xl, dl),
                       tint.IntegratorConfig(**CFG64))
    assert s.x.requires_grad and int((s.status == tstates.OBJECT).sum()) > 40
    ok = ((s.status != tstates.CAPTURED)
          & (s.status != tstates.ERROR))[..., None]
    torch.where(ok, T(wx) * s.x, 0.0).sum().backward()
    for got, want, what in ((mass.grad, jg[0], "mass"), (cz.grad, jg[1], "cz"),
                            (xl.grad, jg[2], "x0"), (dl.grad, jg[3], "d0")):
        close(got, want, 1e-4, what)


def test_needs_grad_sees_the_sphere_geometry():
    """A render whose only differentiated input is a moon still records the
    integration, so the moon's gradient is not lost."""
    _, tenv = envs(SPH[:1, :3], SPH[:1, 3])
    s0 = port_state(tenv, *map(T, rays(8)))
    assert not tint.needs_grad(tenv, s0)
    tenv.spheres.radius.requires_grad_(True)
    assert tint.needs_grad(tenv, s0)


def test_no_nan_gradients_with_all_event_types():
    """Twin of tests/test_pallas.py::test_no_nan_gradients_with_all_event_types:
    rays ending on the disk, on the sphere and still active give a finite
    mass gradient, equal to JAX's."""
    x0, d0 = rays(512, seed=3)

    def jloss(mass):
        env = dataclasses.replace(envs([[2.0, 0.0, 10.0]], [3.0])[0],
                                  mass=mass, r_capture=2.0 * mass)
        p0, E0 = jnull(jnp.asarray(x0), jnp.asarray(d0), mass)
        s = jint.integrate_fixed(env, jstates.init_state(
            jnp.asarray(x0), p0, E0), jint.IntegratorConfig(**CFG64))
        ok = ((s.status != jstates.CAPTURED)
              & (s.status != jstates.ERROR))[..., None]
        return jnp.sum(jnp.where(ok, s.x ** 2, 0.0))

    mass = torch.tensor(0.5, requires_grad=True)
    env = dataclasses.replace(envs([[2.0, 0.0, 10.0]], [3.0])[1], mass=mass,
                              r_capture=2.0 * mass)
    s0 = tstates.init_state(T(x0), *tnull(T(x0), T(d0), mass))
    s = tint.integrate(env, s0, tint.IntegratorConfig(**CFG64))
    counts = np.bincount(s.status.numpy(), minlength=8)
    for st in (tstates.ACTIVE, tstates.DISK, tstates.OBJECT):
        assert counts[st], (st, counts)
    ok = ((s.status != tstates.CAPTURED)
          & (s.status != tstates.ERROR))[..., None]
    torch.where(ok, s.x ** 2, 0.0).sum().backward()
    assert torch.isfinite(mass.grad)
    close(mass.grad, jax.grad(jloss)(jnp.float32(0.5)), 1e-4, "mass")


# =============================================================================
# Texture and shading.
# =============================================================================
@pytest.mark.parametrize("compat", [True, False], ids=["arctan", "atan2"])
def test_sphere_uv_bpy_matches_jax(compat):
    rng = np.random.default_rng(8)
    nrm = rng.normal(size=(3000, 3))
    nrm[:50, 0] = 0.0                         # on the arctan's pole
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    w = rng.normal(size=(2, 3000)).astype(np.float32)
    (jph, jth), vjp = jax.vjp(lambda n: jtexture.sphere_uv_bpy(n, compat),
                              jnp.asarray(nrm))
    (jgn,) = vjp((jnp.asarray(w[0]), jnp.asarray(w[1])))
    tn = T(nrm).requires_grad_(True)
    ph, th = ttexture.sphere_uv_bpy(tn, compat)
    (ph * T(w[0]) + th * T(w[1])).sum().backward()
    close(ph.detach(), jph, 1e-6, "ph")
    close(th.detach(), jth, 1e-6, "th")
    # the arctan form's derivative is ~1e20 on its pole; compare elsewhere
    k = slice(50, None) if compat else slice(None)
    close(tn.grad[k], np.asarray(jgn)[k], 1e-5, "d normal")


def shading_scene(beaming=None, lights=True):
    """A disk and three moons (one Lambertian, one partly emissive) with two
    lights, in the JAX package and carried over to the port.  The hole lies
    between the first light and moon 0, so the horizon shadows it."""
    rng = np.random.default_rng(9)
    disk = JDisk.make(r_in=2.0, r_out=6.0, beaming=beaming,
                      texture=rng.uniform(size=(16, 32, 3)))
    spheres = JSpheres.make(center=SPH[:, :3], radius=SPH[:, 3],
                            texture=rng.uniform(size=(3, 8, 16, 3)),
                            emission=[1.0, 0.0, 0.3],
                            albedo=rng.uniform(size=(3, 3)))
    js = JScene(bh=JBlackHole.make(mass=0.5), disk=disk, spheres=spheres,
                lights=JLights.make(position=[[-12.0, 0.0, 0.3],
                                              [-4.0, 8.0, 1.0]],
                                    intensity=6.0) if lights else None)
    return js, convert.scene_from_reference(js, device="cpu")


def disk_hits(n=3000, seed=10):
    """Points on the disk annulus with momenta of photons of E = 1."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(2.0, 6.0, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    x = np.stack([r * np.cos(ph), r * np.sin(ph), np.zeros(n)], -1)
    p = rng.normal(size=(n, 3)) * 0.6
    return x.astype(np.float32), p.astype(np.float32), np.ones(n, np.float32)


def test_disk_redshift_matches_jax():
    x, p, E = disk_hits()
    x[:100, :2] *= 0.4                      # inside the photon orbit: g = 0
    jg_, vjp = jax.vjp(lambda a, b, m: jshading.disk_redshift(a, b, E, m),
                       jnp.asarray(x), jnp.asarray(p), jnp.float32(0.5))
    jgrad = vjp(jnp.ones_like(jg_))
    leaves = [T(x).requires_grad_(True), T(p).requires_grad_(True),
              torch.tensor(0.5, requires_grad=True)]
    g = tshading.disk_redshift(leaves[0], leaves[1], T(E), leaves[2])
    g.sum().backward()
    close(g.detach(), jg_, 1e-5, "g")
    assert (g.detach()[:100] == 0).any() and (g.detach()[100:] > 0).all()
    for i, what in enumerate(("x", "p", "mass")):
        close(leaves[i].grad, jgrad[i], 1e-5, f"d {what}")


@pytest.mark.parametrize("beaming", [None, 4.0], ids=["plain", "beaming"])
def test_shade_disk_matches_jax(beaming):
    js, ts = shading_scene(beaming)
    x, p, E = disk_hits()
    w = np.random.default_rng(11).normal(size=(len(E), 3)).astype(np.float32)

    def jf(pt, mom, tex):
        scene = dataclasses.replace(js, disk=dataclasses.replace(
            js.disk, texture=tex))
        return jshading.shade_disk(scene, pt, mom, jnp.asarray(E))

    out, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(p), js.disk.texture)
    jg = vjp(jnp.asarray(w))
    leaves = [T(x).requires_grad_(True), T(p).requires_grad_(True),
              ts.disk.texture.requires_grad_(True)]
    rgb = tshading.shade_disk(ts, leaves[0], leaves[1], T(E))
    (rgb * T(w)).sum().backward()
    close(rgb.detach(), out, 1e-5, "rgb")
    for i, what in enumerate(("hit point", "p", "texture")):
        if beaming is None and what == "p":
            assert leaves[i].grad is None
            continue
        close(leaves[i].grad, jg[i], 1e-4, f"d {what}")


def sphere_hits(n=3000, seed=12):
    """Points on the surfaces of the spheres of SPH, with their ids."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, len(SPH), n)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    x = SPH[k, :3] + SPH[k, 3:] * u
    return x.astype(np.float32), k.astype(np.int32)


def test_occluded_matches_jax():
    """Shadow rays from the sphere surfaces and from points behind the
    spheres to the first light, the spheres and the horizon as blockers."""
    js, ts = shading_scene()
    x, k = sphere_hits()
    lp = np.asarray(js.lights.position)[0]
    u = lp - SPH[k, :3]
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    x[::2] = SPH[k[::2], :3] - 1.5 * SPH[k[::2], 3:] * u[::2]   # behind
    lv = lp - x
    dist = np.linalg.norm(lv, axis=-1).astype(np.float32)
    ld = (lv / dist[:, None]).astype(np.float32)
    jb = np.asarray(jshading._occluded(js, jnp.asarray(x), jnp.asarray(ld),
                                       jnp.asarray(dist)))
    tb = tshading._occluded(ts, T(x), T(ld), T(dist)).numpy()
    np.testing.assert_array_equal(tb, jb)
    assert 0.2 < jb.mean() < 0.8


@pytest.mark.parametrize("lights", [True, False], ids=["lights", "emission"])
def test_shade_sphere_matches_jax(lights):
    """The emission and Lambert branches (with rays in shadow and in light),
    forward and gradient with respect to the hit points, the sphere
    centres, the textures, the albedos and the light positions."""
    js, ts = shading_scene(lights=lights)
    x, k = sphere_hits()
    w = np.random.default_rng(13).normal(size=(len(k), 3)).astype(np.float32)
    n = len(k)

    def jf(xx, c, tex, alb, lpos):
        scene = dataclasses.replace(js, spheres=dataclasses.replace(
            js.spheres, center=c, texture=tex, albedo=alb),
            lights=None if lpos is None else dataclasses.replace(
                js.lights, position=lpos))
        s = jstates.RayState(x=xx, p=jnp.zeros_like(xx), E=jnp.ones(n),
                             lam=jnp.zeros(n),
                             status=jnp.full(n, jstates.OBJECT, jnp.int32),
                             hit_obj=jnp.asarray(k))
        return jshading.shade_sphere(scene, s)

    jargs = (jnp.asarray(x), js.spheres.center, js.spheres.texture,
             js.spheres.albedo, js.lights.position if lights else None)
    out, vjp = jax.vjp(jf, *jargs)
    jg = vjp(jnp.asarray(w))
    leaves = [T(x).requires_grad_(True)] + [
        t.requires_grad_(True) for t in (ts.spheres.center,
                                         ts.spheres.texture,
                                         ts.spheres.albedo)]
    if lights:
        leaves.append(ts.lights.position.requires_grad_(True))
    s = tstates.RayState(x=leaves[0], p=torch.zeros(n, 3), E=torch.ones(n),
                         lam=torch.zeros(n),
                         status=torch.full((n,), tstates.OBJECT,
                                           dtype=torch.int32),
                         hit_obj=T(k))
    rgb = tshading.shade_sphere(ts, s)
    (rgb * T(w)).sum().backward()
    close(rgb.detach(), out, 1e-5, "rgb")
    for i, what in enumerate(("hit point", "center", "texture", "albedo",
                              "light position")[:len(leaves)]):
        if not lights and what == "albedo":
            continue
        close(leaves[i].grad, jg[i], 1e-4, f"d {what}")
    if lights:   # some hit points are in the first light's shadow
        lv = ts.lights.position[0].detach() - s.x.detach()
        dist = lv.norm(dim=-1)
        shadow = tshading._occluded(ts, s.x.detach(), lv / dist[:, None],
                                    dist)
        assert shadow.any() and not shadow.all()


# =============================================================================
# Whole renders.
# =============================================================================
def golden_rule(img, ref, what):
    diff = np.abs(np.asarray(img, np.float32) - np.asarray(ref, np.float32))
    assert diff.mean() < 2e-3, f"{what}: mean drift {diff.mean():.2e}"
    assert (diff > 0.1).mean() < 0.01, (
        f"{what}: {100 * (diff > 0.1).mean():.2f}% of pixels moved > 0.1")


def golden_sky():
    h, w = 32, 64
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * u / w) * np.sin(np.pi * v / h),
        v / h, ((u // 8 + v // 8) % 2)], -1).astype(np.float32)


GOLDEN_CFG = JRenderConfig(width=64, height=64, samples=1,
                           integrator=JIntegratorConfig(n_steps=400, dt=0.08,
                                                        backend="scan"),
                           lam_max=120.0)


def golden_scene(name):
    """tests/test_golden.py's scenes (:53-65) and their config (:40-43)."""
    disk_tex = np.broadcast_to(np.float32([1.0, 0.6, 0.2]), (8, 32, 3))
    moon_tex = np.broadcast_to(np.float32([0.2, 1.0, 0.2]), (2, 8, 8, 3))
    bh = JBlackHole.make(mass=0.5)
    if name == "einstein_ring":
        return (JScene(bh=bh, background=golden_sky(),
                       spheres=JSpheres.make(center=[[0.0, 0.0, -12.0]],
                                             radius=[1.0],
                                             texture=moon_tex[:1])),
                JCamera.make(position=(0.0, 0.0, 20.0), fov=(0.9, 0.9)))
    return (JScene(bh=bh, background=golden_sky(),
                   disk=JDisk.make(r_in=2.0, r_out=6.0, texture=disk_tex),
                   spheres=JSpheres.make(
                       center=[[6.0, 2.0, 6.0], [-5.0, -2.0, -8.0]],
                       radius=[0.8, 0.8], texture=moon_tex)),
            JCamera.make(position=(0.0, 6.0, 19.0), euler=(-0.3, 0.0, 0.0),
                         fov=(0.9, 0.9)))


@pytest.mark.parametrize("name", ["einstein_ring", "disk_and_moons"])
def test_golden(name):
    """The port's render of tests/golden/<name>.npz through the plain
    event path, held to the golden rule."""
    scene, cam = golden_scene(name)
    img = render_image(convert.scene_from_reference(scene, device="cpu"),
                       convert.camera_from_reference(cam, device="cpu"),
                       convert.render_config_from_reference(GOLDEN_CFG))
    assert img.shape == (64, 64, 4) and torch.isfinite(img).all()
    with np.load(f"tests/golden/{name}.npz") as z:
        golden_rule(img.numpy(), z["img"].astype(np.float32), name)


def flagship_sky(h=256, w=512, check=16):
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * u / w) * np.sin(np.pi * v / h),
        v / h, ((u // check + v // check) % 2)], -1).astype(np.float32)


def events_scene(beaming=None, lights=None, albedo=None, emission=None):
    """bench.py's make_scene('events') (:126-141): a z = 0 disk, r_in 2,
    r_out 6, with a 64x256 texture, and four textured moons at radius 7."""
    h, w = 64, 256
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    disk_tex = np.stack([0.9 + 0 * u, 0.5 + 0.3 * np.sin(8 * np.pi * u / w),
                         0.2 + 0 * u], -1).astype(np.float32)
    moon_tex = np.broadcast_to(np.float32([0.3, 0.9, 0.4]), (4, 16, 32, 3))
    ang = np.array([0.3, 1.9, 3.6, 5.2])
    centers = np.stack([7 * np.cos(ang), 7 * np.sin(ang),
                        0.8 * np.sin(2 * ang)], -1)
    return JScene(
        bh=JBlackHole.make(mass=0.5), background=flagship_sky(),
        disk=JDisk.make(r_in=2.0, r_out=6.0, texture=disk_tex,
                        beaming=beaming),
        spheres=JSpheres.make(center=centers, radius=[0.6, 0.5, 0.7, 0.4],
                              texture=moon_tex, emission=emission,
                              albedo=albedo),
        lights=lights)


def events_cfg(size):
    """bench.py's make_render_cfg (:144-158) at ``size``^2."""
    return JRenderConfig(
        width=size, height=size, samples=1,
        integrator=JIntegratorConfig(n_steps=100, dt=0.12, dt_boost=64.0,
                                     dt_boost_r_ref=1.7, dt_power=1.5,
                                     backend="scan"),
        lam_max=100.0)


EVENTS_CAM = JCamera.make(position=(0.0, 0.0, 25.0), euler=(0.25, 0.0, 0.0),
                          fov=(0.8, 0.8))


def moon_texture():
    """A moon texture that varies over the surface (the bench's is one
    colour, which makes the image independent of where a moon is hit)."""
    v, u = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
    tex = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * u / 32),
                    0.5 + 0.4 * np.cos(np.pi * v / 16), 0.5 + 0 * u], -1)
    return np.broadcast_to(tex, (4, 16, 32, 3)).astype(np.float32)


def test_events_scene_matches_jax():
    """bench.py's events scene and camera (euler 0.25, bench.py:1023-1027)
    at 32x32 against JAX render_image with backend='scan'."""
    scene, cfg = events_scene(), events_cfg(32)
    ref = np.asarray(jrender(scene, EVENTS_CAM, cfg))
    img = render_image(convert.scene_from_reference(scene, device="cpu"),
                       convert.camera_from_reference(EVENTS_CAM, device="cpu"),
                       convert.render_config_from_reference(cfg)).numpy()
    assert np.isfinite(img).all()
    golden_rule(img, ref, "events 32x32")


@pytest.fixture(scope="module")
def events_grads():
    """d mean(img[..., :3]^2) (bench.py:385-391) of the 32x32 events frame
    with respect to the mass, the camera position, the sky, the disk
    texture and moon 0's centre: (JAX, the port).  The moons get a
    varying texture, so that the image depends on the moon's position."""
    scene0, cfg = events_scene(), events_cfg(32)
    scene0.spheres.texture = jnp.asarray(moon_texture())

    def jloss(m, pos, sky, dtex, c0):
        scene = dataclasses.replace(
            scene0, bh=dataclasses.replace(scene0.bh, mass=m), background=sky,
            disk=dataclasses.replace(scene0.disk, texture=dtex),
            spheres=dataclasses.replace(
                scene0.spheres, center=scene0.spheres.center.at[0].set(c0)))
        cam = dataclasses.replace(EVENTS_CAM, position=pos)
        return jnp.mean(jrender(scene, cam, cfg)[..., :3] ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        jnp.float32(0.5), EVENTS_CAM.position, scene0.background,
        scene0.disk.texture, scene0.spheres.center[0])
    scene = convert.scene_from_reference(scene0, device="cpu")
    cam = convert.camera_from_reference(EVENTS_CAM, device="cpu")
    c0 = scene.spheres.center[0].clone().requires_grad_(True)
    scene.spheres.center = torch.cat([c0[None], scene.spheres.center[1:]])
    leaves = (scene.bh.mass, cam.position, scene.background,
              scene.disk.texture)
    for t in leaves:
        t.requires_grad_(True)
    img = render_image(scene, cam, convert.render_config_from_reference(cfg))
    img[..., :3].pow(2).mean().backward()
    return ([np.asarray(g) for g in jg],
            [t.grad.numpy() for t in (*leaves, c0)])


@pytest.mark.parametrize("i,what,tol", [
    (0, "mass", 1e-2), (1, "camera position", 1e-3), (2, "sky", 1e-3),
    (3, "disk texture", 1e-3), (4, "moon 0 centre", 1e-3)])
def test_events_render_gradients_match_jax(events_grads, i, what, tol):
    """The 32x32 events frame's gradient with respect to one parameter
    against jax.grad of the JAX render_image, to 1e-3 of its largest
    component -- and the mass to 1e-2: JAX in float32 is itself 4.3e-3
    (5.5e-3 with the varying moon texture) from a float64 JAX render of
    this frame, and the port reads 2.5e-3 from JAX."""
    jg, tg = events_grads
    assert np.abs(jg[i]).max() > 0
    close(tg[i], jg[i], tol, what)


def test_convert_carries_a_full_events_scene():
    """A events scene with a beaming disk, two lights and Lambertian moons
    with albedos, carried over with convert.py: the port's 32x32 render
    agrees with JAX's by the golden rule."""
    scene = events_scene(
        beaming=3.0, emission=[1.0, 0.0, 0.0, 0.5],
        albedo=np.random.default_rng(14).uniform(size=(4, 3)),
        lights=JLights.make(position=[[0.0, 0.0, 12.0], [9.0, -4.0, 3.0]],
                            intensity=8.0))
    cfg = events_cfg(32)
    tscene = convert.scene_from_reference(scene, device="cpu")
    assert float(tscene.disk.beaming) == 3.0
    assert tscene.lights.position.shape == (2, 3)
    np.testing.assert_array_equal(tscene.spheres.albedo.numpy(),
                                  np.asarray(scene.spheres.albedo))
    ref = np.asarray(jrender(scene, EVENTS_CAM, cfg))
    img = render_image(tscene,
                       convert.camera_from_reference(EVENTS_CAM,
                                                     device="cpu"),
                       convert.render_config_from_reference(cfg)).numpy()
    golden_rule(img, ref, "events with beaming and lights")


def test_scalars_carry_the_disk_radii():
    _, tenv = envs(None, None)
    scal = cuda_kernel._scalars(tenv, tint.IntegratorConfig(),
                                torch.device("cpu"))
    np.testing.assert_array_equal(scal[7:9].numpy(), [2.0, 6.0])
    _, tenv = envs(SPH[:, :3], SPH[:, 3])
    np.testing.assert_array_equal(
        cuda_kernel._sphere_table(tenv, torch.device("cpu")).numpy(), SPH)
