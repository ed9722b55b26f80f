"""PyTorch port against the JAX package: Kerr spacetimes.

Inputs are made from numpy seeds and fed to both packages.  Covered, module
by module:

* models/kerr.py -- ``ks_radius``, ``ks_scalars``, ``horizon_radius``;
* ops/geodesic.py -- ``null_init``, ``xdot``, ``hamiltonian`` with spin and
  ``kerr_rhs`` (the analytic ``_rhs_kerr_soa``), against the TPU kernel's
  SoA function and against autodiff of the Hamiltonian (``ks_rhs``);
* ops/adjoint.py -- the hand-derived ``rhs_kerr_vjp``, the Kerr step-size
  VJP and ``step_adjoint(kerr=True)``, against ``jax.vjp``, the TPU
  kernel's ``_step_adjoint`` and ``torch.autograd``;
* the integrator and whole renders: a twin of
  tests/test_pallas.py::test_kerr_forward_parity_and_adjoint, the
  ``kerr_a09`` golden and a 32x32 Kerr events frame with its gradients;
* render/renderer.py's Kerr capture radius, ``needs_grad`` and convert.py.

Spins a = 0.45 (a/M = 0.9 at M = 0.5), a = -0.3 (retrograde) and a = 0.
Tolerances are the port's: single functions to 1e-6 relative (the radius,
the potential) or 1e-5 of the largest value (right-hand sides and VJPs;
readings <= 2e-6); statuses equal, x and lam within 1e-3, p within 1e-4;
integrator gradients to the reference's rtol 2e-4 (test_pallas.py:153);
images to the golden rule.
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
from blackhole_geodesic_calculator_tpu.models import kerr as jkerr  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import IntegratorConfig as JIntegratorConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import geodesic as jgeo  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import pallas_kernel as jpk  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import states as jstates  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import RenderConfig as JRenderConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import render_image as jrender  # noqa: E402
from blackhole_geodesic_calculator_tpu.render.renderer import scene_env as jscene_env  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import BlackHole as JBlackHole  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Disk as JDisk  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Scene as JScene  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Spheres as JSpheres  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import convert  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.camera.pinhole import generate_rays, pixel_grid  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.models import kerr as tkerr  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import adjoint, cuda_kernel  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import geodesic as tgeo  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import integrate as tint  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import states as tstates  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.render.renderer import render_image  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.render.renderer import scene_env  # noqa: E402

# the JAX package's ops/__init__ exports a function named ``integrate``
jint = importlib.import_module("blackhole_geodesic_calculator_tpu.ops.integrate")

MASS = 0.5
SPINS = [0.45, -0.3, 0.0]
POWERS = [1.5, 1.0, 2.0, 1.3]
TOL_X, TOL_P = 1e-3, 1e-4
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


def scal(spin):
    """[mass, dt, dt_boost, r_ref, r_capture, r_escape, lam_max, r_in,
    r_out, a] of the flagship schedule with the events scene's disk."""
    return np.array([MASS, 0.12, 64.0, 1.7, 1.0, 70.0, 100.0, 2.0, 6.0, spin],
                    np.float32)


def kerr_states(spin, n=3000, seed=0, r_min=None, r_max=30.0):
    """Positions from just outside the outer horizon (through the
    ergosphere, r_+ < r < 2M on the equator) out to ``r_max``, null
    momenta of random directions (the JAX package's null_init); SoA numpy
    arrays (x, p, E)."""
    rng = np.random.default_rng(seed)
    r_plus = MASS + np.sqrt(MASS * MASS - spin * spin)
    r = rng.uniform(1.08 * r_plus if r_min is None else r_min, r_max, n)
    u = rng.normal(size=(n, 3))
    x = (r[:, None] * u / np.linalg.norm(u, axis=-1, keepdims=True))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p, E = jgeo.null_init(jnp.asarray(x, jnp.float32),
                          jnp.asarray(d, jnp.float32), jnp.float32(MASS),
                          jnp.float32(spin))
    return (x.T.astype(np.float32).copy(), np.asarray(p).T.copy(),
            np.asarray(E))


# =============================================================================
# models/kerr.py and ops/geodesic.py.
# =============================================================================
@pytest.mark.parametrize("spin", SPINS)
def test_kerr_model_matches_jax(spin):
    """ks_radius, ks_scalars and horizon_radius within 1e-6 relative."""
    x, _, _ = kerr_states(spin, r_min=0.3)
    x = x.T.copy()
    rj = np.asarray(jkerr.ks_radius(jnp.asarray(x), jnp.float32(spin)))
    close(tkerr.ks_radius(T(x), torch.tensor(spin)), rj, 1e-6, "ks_radius")
    Hj, lj = jkerr.ks_scalars(jnp.asarray(x), jnp.float32(MASS),
                              jnp.float32(spin))
    H, l3 = tkerr.ks_scalars(T(x), torch.tensor(MASS), torch.tensor(spin))
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-6)
    np.testing.assert_allclose(l3.numpy(), np.asarray(lj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        float(tkerr.horizon_radius(MASS, spin)),
        float(jkerr.horizon_radius(jnp.float32(MASS), jnp.float32(spin))),
        rtol=1e-6)


@pytest.mark.parametrize("spin", SPINS)
def test_geodesic_forms_with_spin_match_jax(spin):
    """null_init, xdot and hamiltonian of a spinning hole: rtol 1e-5 of the
    largest value (the Hamiltonian: of the size of its terms, since it is
    a difference of squares that vanishes on null rays)."""
    x, p, E = kerr_states(spin, seed=1)
    x, p = x.T.copy(), p.T.copy()
    d = np.random.default_rng(2).normal(size=x.shape)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    a = jnp.float32(spin)
    pj, Ej = jgeo.null_init(jnp.asarray(x), jnp.asarray(d), MASS, a)
    pt, Et = tgeo.null_init(T(x), T(d), MASS, torch.tensor(spin))
    # away from the static limit: p divides by 1 - q, which vanishes where
    # q = 2H = 1 (the ergosurface; the horizon for a = 0)
    H, _ = jkerr.ks_scalars(jnp.asarray(x), MASS, a)
    calm = np.abs(1.0 - 2.0 * np.asarray(H)) > 0.1
    close(pt[calm], np.asarray(pj)[calm], 1e-5, "null_init p")
    close(Et, Ej, 1e-5, "null_init E")
    vj = jgeo.xdot(jnp.asarray(x), jnp.asarray(p), jnp.asarray(E), MASS, a)
    close(tgeo.xdot(T(x), T(p), T(E), MASS, torch.tensor(spin)), vj, 1e-5,
          "xdot")
    hj = np.asarray(jgeo.hamiltonian(jnp.asarray(x), jnp.asarray(p),
                                     jnp.asarray(E), MASS, a))
    ht = tgeo.hamiltonian(T(x), T(p), T(E), MASS, torch.tensor(spin)).numpy()
    terms = E * E + np.sum(p.astype(np.float64) ** 2, -1)
    np.testing.assert_array_less(np.abs(ht - hj), 1e-5 * terms)
    # the initial coordinate velocity is the camera direction
    close(tgeo.xdot(T(x), pt, Et, MASS, torch.tensor(spin))[calm], d[calm],
          1e-5, "xdot at init")


@pytest.mark.parametrize("spin", SPINS)
def test_kerr_rhs_matches_jax(spin):
    """kerr_rhs against the TPU kernel's _rhs_kerr_soa and against autodiff
    of the Hamiltonian (ks_rhs), 1e-5 of the largest value; at a = 0 it is
    the Schwarzschild right-hand side (as tests/test_geodesic.py:56).
    Against ks_rhs away from the static limit, where momenta of the
    horizon's scale make the two float32 forms part (_rhs_kerr_soa itself
    reads 1.5e-5 from ks_rhs there)."""
    x, p, E = kerr_states(spin, seed=3)
    xr, pr = x.T.copy(), p.T.copy()
    dx, dp = tgeo.kerr_rhs(T(xr), T(pr), T(E), MASS, torch.tensor(spin))
    soa = jpk._rhs_kerr_soa(jnp.float32(MASS), jnp.float32(spin),
                            jnp.asarray(E))(*map(jnp.asarray, (*x, *p)))
    close(dx.T, np.stack(soa[:3]), 1e-5, "dx vs _rhs_kerr_soa")
    close(dp.T, np.stack(soa[3:]), 1e-5, "dp vs _rhs_kerr_soa")
    jdx, jdp = jgeo.ks_rhs(jnp.asarray(xr), jnp.asarray(pr), jnp.asarray(E),
                           jnp.float32(MASS), jnp.float32(spin))
    H, _ = jkerr.ks_scalars(jnp.asarray(xr), MASS, jnp.float32(spin))
    calm = np.abs(1.0 - 2.0 * np.asarray(H)) > 0.1
    close(dx[calm], np.asarray(jdx)[calm], 1e-5, "dx vs ks_rhs")
    close(dp[calm], np.asarray(jdp)[calm], 1e-5, "dp vs ks_rhs")
    if spin == 0.0:
        sx, sp = tgeo.schwarzschild_rhs(T(xr), T(pr), T(E), MASS)
        close(dx, sx, 1e-5, "dx vs schwarzschild_rhs")
        close(dp, sp, 1e-5, "dp vs schwarzschild_rhs")


# =============================================================================
# ops/adjoint.py: the Kerr VJPs.
# =============================================================================
@pytest.mark.parametrize("spin", SPINS)
def test_rhs_kerr_vjp_matches_jax(spin):
    """rhs_kerr_vjp against jax.vjp of _rhs_kerr_soa: all 9 cotangents
    (6 state components, E, mass, spin), rays through the ergosphere,
    1e-5 of the largest value."""
    x, p, E = kerr_states(spin, seed=4)
    g = np.random.default_rng(5).normal(size=(6, len(E))).astype(np.float32)

    def rhs(a0, a1, a2, b0, b1, b2, E_, m, a):
        return jpk._rhs_kerr_soa(m, a, E_)(a0, a1, a2, b0, b1, b2)

    args = ([jnp.asarray(v) for v in (*x, *p, E)]
            + [jnp.float32(MASS), jnp.float32(spin)])
    out, vjp = jax.vjp(rhs, *args)
    jg = vjp(tuple(jnp.asarray(v) for v in g))
    tout = tgeo.kerr_rhs_soa(T(np.float32(MASS)), T(np.float32(spin)), T(E),
                             *map(T, x), *map(T, p))
    tg, tE, tm, ts = adjoint.rhs_kerr_vjp(
        T(np.float32(MASS)), T(np.float32(spin)), T(E), tuple(map(T, x)),
        tuple(map(T, p)), tuple(map(T, g)))
    for i in range(6):
        close(tout[i], out[i], 1e-5, f"rhs[{i}]")
        close(tg[i], jg[i], 1e-5, f"d(x, p)[{i}]")
    close(tE, jg[6], 1e-5, "dE")
    close(tm.sum(), jg[7], 1e-5, "dmass")
    close(ts.sum(), jg[8], 1e-5, "dspin")


@pytest.mark.parametrize("power", POWERS)
def test_kerr_step_size_vjp_matches_jax(power):
    """The Kerr step size (the floored Kerr-Schild radius) and its VJP
    against jax.vjp of _dt_soa(kerr=True): x, dt, boost, r_ref and the
    spin; r_ref = 1.7 puts rays on both sides of both clip edges."""
    spin = 0.45
    x, _, _ = kerr_states(spin, seed=6, r_max=120.0)
    rng = np.random.default_rng(7)
    active = rng.random(x.shape[1]) < 0.9
    gh = rng.normal(size=x.shape[1]).astype(np.float32)

    def dt(a0, a1, a2, s):
        return jpk._dt_soa(a0, a1, a2, jnp.asarray(active), s,
                           jnp.bool_(True), True, power)

    h, vjp = jax.vjp(dt, *map(jnp.asarray, x), jnp.asarray(scal(spin)))
    jg = vjp(jnp.asarray(gh))
    xs, S = tuple(map(T, x)), T(scal(spin))
    close(adjoint.step_size(xs, T(active), S, power, kerr=True), h, 1e-6,
          "dt")
    ga, g_dt, g_boost, g_rref, g_spin = adjoint.step_size_vjp(
        xs, T(active), S, power, T(gh), kerr=True)
    for i in range(3):
        close(ga[i], jg[i], 1e-5, f"dx[{i}]")
    close(torch.stack([g_dt.sum(), g_boost.sum(), g_rref.sum(),
                       g_spin.sum()]),
          np.asarray(jg[3])[[1, 2, 3, 9]], 1e-5, "d(dt, boost, r_ref, a)")
    assert float(g_spin.abs().sum()) > 0


def step_state(spin, n=2000, seed=8):
    """Rays near the disk plane and the spheres of SPH with random
    directions (one step ends a fair share of them on the disk or a
    sphere); a tenth are frozen (ESCAPED).  SoA numpy arrays."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.8, 8.0, n)
    ph = rng.uniform(0, 2 * np.pi, n)
    x = np.stack([r * np.cos(ph), r * np.sin(ph), rng.uniform(-0.6, 0.6, n)],
                 -1).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p, E = jgeo.null_init(jnp.asarray(x), jnp.asarray(d, jnp.float32),
                          jnp.float32(MASS), jnp.float32(spin))
    status = np.where(rng.random(n) < 0.1, jstates.ESCAPED,
                      jstates.ACTIVE).astype(np.int32)
    g = rng.normal(size=(6, n)).astype(np.float32)
    return x.T.copy(), np.asarray(p).T.copy(), np.asarray(E), status, g


@pytest.mark.parametrize("events,spin,power", [
    (False, 0.45, 1.5), (True, 0.45, 1.0), (True, -0.3, 2.0),
    (False, -0.3, 1.3)])
def test_kerr_step_adjoint_matches_jax(events, spin, power):
    """adjoint.step_adjoint(kerr=True), event-free and with the disk and
    three spheres, against the TPU kernel's _step_adjoint(kerr=True) and
    against jax.vjp of _soa_step(kerr=True)[:6]; 1e-5 of the largest
    value.  The scalar cotangent's spin entry is the Kerr one."""
    x, p, E, status, g = step_state(spin)
    n = len(E)
    S = scal(spin)
    xp = tuple(jnp.asarray(v) for v in (*x, *p, E))
    zeros, obj = jnp.zeros(n), jnp.full(n, -1, jnp.int32)
    sph = jnp.asarray(SPH) if events else None
    kw = dict(has_disk=events, n_sph=len(SPH) if events else 0, power=power,
              kerr=True)
    if events:
        st1 = np.asarray(jpk._soa_step(xp, zeros, jnp.asarray(status), obj,
                                       jnp.asarray(S), sph, **kw)[2])
        assert (st1 == jstates.DISK).sum() > 50
        assert (st1 == jstates.OBJECT).sum() > 10
    jg6, jgE, jgscal, jgsph = jpk._step_adjoint(
        xp, zeros, jnp.asarray(status), obj, jnp.asarray(S), sph,
        tuple(map(jnp.asarray, g)), enabled=jnp.bool_(True), **kw)

    def step6(x6, E_, s, sp):
        out = jpk._soa_step((*x6, E_), zeros, jnp.asarray(status), obj, s,
                            sp, **kw)
        return out[0][:6]

    _, vjp = jax.vjp(step6, xp[:6], xp[6], jnp.asarray(S), sph)
    vg6, vgE, vgscal, vgsph = vjp(tuple(map(jnp.asarray, g)))
    g6, gE, gscal, gsph = adjoint.step_adjoint(
        tuple(map(T, x)), tuple(map(T, p)), T(E), T(status), T(S),
        tuple(map(T, g)), power, sph=T(SPH) if events else None,
        has_disk=events, kerr=True)
    entries = [0, 1, 2, 3, 9]
    for ref6, refE, refscal, refsph, what in (
            (jg6, jgE, jgscal, jgsph, "_step_adjoint"),
            (vg6, vgE, vgscal, vgsph, "jax.vjp of _soa_step")):
        for i in range(6):
            close(g6[i], ref6[i], 1e-5, f"{what}: d(x, p)[{i}]")
        close(gE, refE, 1e-5, f"{what}: dE")
        close(gscal[entries], np.asarray(refscal)[entries], 1e-5,
              f"{what}: d(mass, dt, boost, r_ref, a)")
        if events:
            close(gsph, refsph, 1e-5, f"{what}: dsph")
    np.testing.assert_array_equal(gscal[4:9].numpy(), 0.0)
    assert float(gscal[9]) != 0.0


def test_kerr_step_adjoint_matches_autograd():
    """adjoint.step_adjoint(kerr=True) with events against torch.autograd
    of the port's _fixed_step with a spin: cotangents of x, p, E, the mass,
    the spin and the sphere centres and radii."""
    x, p, E, status, g = step_state(0.45, seed=9)
    mass = torch.tensor(MASS, requires_grad=True)
    spin = torch.tensor(0.45, requires_grad=True)
    center = T(SPH[:, :3].copy()).requires_grad_(True)
    radius = T(SPH[:, 3].copy()).requires_grad_(True)
    env = tint.GeodesicEnv(
        mass=mass, spin=spin, r_capture=torch.tensor(1.0),
        r_escape=torch.tensor(70.0), lam_max=torch.tensor(100.0),
        disk=tint.DiskGeom(r_in=torch.tensor(2.0), r_out=torch.tensor(6.0)),
        spheres=tint.SphereGeom(center=center, radius=radius))
    cfg = tint.IntegratorConfig(n_steps=1, dt=0.12, dt_boost=64.0,
                                dt_boost_r_ref=1.7, dt_power=1.5)
    xl, pl, El = (T(x.T.copy()).requires_grad_(True),
                  T(p.T.copy()).requires_grad_(True), T(E).requires_grad_(True))
    s = tstates.init_state(xl, pl, El)
    s.status = T(status)
    s1 = tint._fixed_step(env, cfg, s)
    gt = T(g)
    ((s1.x * gt[:3].T).sum() + (s1.p * gt[3:].T).sum()).backward()
    assert int((s1.status == tstates.OBJECT).sum()) > 10
    S = cuda_kernel._scalars(env, cfg, torch.device("cpu")).detach()
    sph = cuda_kernel._sphere_table(env, torch.device("cpu")).detach()
    g6, gE, gscal, gsph = adjoint.step_adjoint(
        tuple(map(T, x)), tuple(map(T, p)), T(E), T(status), S,
        tuple(map(T, g)), 1.5, sph=sph, has_disk=True, kerr=True)
    close(torch.stack(g6[:3], -1), xl.grad, 1e-5, "dx")
    close(torch.stack(g6[3:], -1), pl.grad, 1e-5, "dp")
    close(gE, El.grad, 1e-5, "dE")
    close(gscal[0], mass.grad, 1e-5, "dmass")
    close(gscal[9], spin.grad, 1e-5, "dspin")
    close(gsph[:, :3], center.grad, 1e-5, "dcenter")
    close(gsph[:, 3], radius.grad, 1e-5, "dradius")


# =============================================================================
# The integrator.
# =============================================================================
def pallas_rays(n=1024, seed=5):
    """tests/test_pallas.py's rays: from z = 25 towards the hole."""
    rng = np.random.default_rng(seed)
    x0 = np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                   np.full(n, 25.0)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  np.full(n, -1.0)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x0, d.astype(np.float32)


@pytest.fixture(scope="module")
def kerr_parity():
    """Twin of tests/test_pallas.py::test_kerr_forward_parity_and_adjoint
    (:122-153): 1024 rays, a = 0.45, the disk, 50 steps of 0.1 (not a
    segment multiple).  The final states of JAX integrate_fixed, of the TPU
    kernels in interpret mode and of the port's plain loop, and the (mass,
    spin) gradient of the loss of test_pallas.py:146-148 through the TPU
    kernels and the port (the reference's own test holds the kernels'
    gradient to integrate_fixed's at rtol 2e-4)."""
    x0, d0 = pallas_rays()
    wx = np.random.default_rng(6).normal(size=(1024, 3)).astype(np.float32)
    cfg = dict(n_steps=50, dt=0.1)

    def jrun(m, a, pallas):
        env = jint.GeodesicEnv(
            mass=m, spin=a, r_capture=jkerr.horizon_radius(m, a),
            r_escape=jnp.float32(60.0), lam_max=jnp.float32(50.0),
            disk=jint.DiskGeom(r_in=jnp.float32(2.0), r_out=jnp.float32(6.0)))
        p0, E0 = jgeo.null_init(jnp.asarray(x0), jnp.asarray(d0), m, a)
        s0 = jstates.init_state(jnp.asarray(x0), p0, E0)
        c = jint.IntegratorConfig(**cfg)
        s = (jpk.integrate_pallas(env, s0, c, interpret=True) if pallas
             else jint.integrate_fixed(env, s0, c))
        ok = ((s.status != jstates.CAPTURED)
              & (s.status != jstates.ERROR))[..., None]
        return jnp.sum(jnp.where(ok, wx * s.x, 0.0)), s

    out = {"scan": (jrun(jnp.float32(MASS), jnp.float32(0.45), False)[1],
                    None)}
    (_, s), g = jax.value_and_grad(
        lambda m, a: jrun(m, a, True), argnums=(0, 1), has_aux=True)(
        jnp.float32(MASS), jnp.float32(0.45))
    out["pallas"] = (s, [float(v) for v in g])

    mass = torch.tensor(MASS, requires_grad=True)
    spin = torch.tensor(0.45, requires_grad=True)
    env = tint.GeodesicEnv(
        mass=mass, spin=spin, r_capture=tkerr.horizon_radius(mass, spin),
        r_escape=torch.tensor(60.0), lam_max=torch.tensor(50.0),
        disk=tint.DiskGeom(r_in=torch.tensor(2.0), r_out=torch.tensor(6.0)))
    s = tint.launch(env, T(x0), T(d0), tint.IntegratorConfig(**cfg))
    assert s.x.requires_grad
    ok = ((s.status != tstates.CAPTURED)
          & (s.status != tstates.ERROR))[..., None]
    torch.where(ok, T(wx) * s.x, 0.0).sum().backward()
    out["port"] = (s, [float(mass.grad), float(spin.grad)])
    return out


@pytest.mark.parametrize("reference", ["scan", "pallas"])
def test_kerr_forward_parity_and_adjoint(kerr_parity, reference):
    """The port's plain Kerr loop against JAX integrate_fixed and the TPU
    kernels in interpret mode: statuses equal, x and lam within 1e-3, p
    within 1e-4; against the kernels also the (mass, spin) gradient, within
    the reference's rtol 2e-4 (readings 1e-6 or less)."""
    js, jg = kerr_parity[reference]
    ts, tg = kerr_parity["port"]
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_allclose(ts.x.detach().numpy(), np.asarray(js.x),
                               rtol=0, atol=TOL_X)
    np.testing.assert_allclose(ts.lam.detach().numpy(), np.asarray(js.lam),
                               rtol=0, atol=TOL_X)
    np.testing.assert_allclose(ts.p.detach().numpy(), np.asarray(js.p),
                               rtol=0, atol=TOL_P)
    if jg is not None:
        np.testing.assert_allclose(tg, jg, rtol=2e-4)


def test_needs_grad_sees_the_spin():
    """A render whose only differentiated input is the spin still records
    the integration, so the spin's gradient is not lost."""
    env = tint.GeodesicEnv(mass=torch.tensor(MASS),
                           spin=torch.tensor(0.45, requires_grad=True),
                           r_capture=torch.tensor(0.8),
                           r_escape=torch.tensor(60.0),
                           lam_max=torch.tensor(50.0))
    x0, d0 = pallas_rays(8)
    p0, E0 = tgeo.null_init(T(x0), T(d0), env.mass, env.spin.detach())
    s0 = tstates.init_state(T(x0), p0, E0)
    assert tint.needs_grad(env, s0)
    with torch.no_grad():
        assert not tint.needs_grad(env, s0)
    env.spin = env.spin.detach()
    assert not tint.needs_grad(env, s0)


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


def test_golden_kerr_a09():
    """The port's render of tests/golden/kerr_a09.npz (tests/test_golden.py
    :66-72: a = 0.45 at M = 0.5, seen edge-on from +x) through the plain
    Kerr path, held to the golden rule."""
    scene = JScene(bh=JBlackHole.make(mass=0.5, spin=0.45),
                   background=golden_sky())
    cam = JCamera.make(position=(20.0, 0.0, 0.0),
                       euler=(0.0, np.pi / 2, 0.0), fov=(0.7, 0.7))
    cfg = JRenderConfig(width=64, height=64, samples=1,
                        integrator=JIntegratorConfig(n_steps=400, dt=0.08,
                                                     backend="scan"),
                        lam_max=120.0)
    tscene = convert.scene_from_reference(scene)
    assert float(tscene.bh.spin) == np.float32(0.45)
    img = render_image(tscene, convert.camera_from_reference(cam),
                       convert.render_config_from_reference(cfg))
    assert img.shape == (64, 64, 4) and torch.isfinite(img).all()
    with np.load("tests/golden/kerr_a09.npz") as z:
        golden_rule(img.numpy(), z["img"].astype(np.float32), "kerr_a09")


def flagship_sky(h=256, w=512, check=16):
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * u / w) * np.sin(np.pi * v / h),
        v / h, ((u // check + v // check) % 2)], -1).astype(np.float32)


def kerr_events_scene(spin=0.45):
    """bench.py's make_scene('events', spin=0.45) (:111-141): the flagship
    sky, a z = 0 disk (r_in 2, r_out 6) with a 64x256 texture and four
    one-colour moons at radius 7, around a hole of a/M = 0.9."""
    v, u = np.meshgrid(np.arange(64), np.arange(256), indexing="ij")
    disk_tex = np.stack([0.9 + 0 * u, 0.5 + 0.3 * np.sin(8 * np.pi * u / 256),
                         0.2 + 0 * u], -1).astype(np.float32)
    ang = np.array([0.3, 1.9, 3.6, 5.2])
    centers = np.stack([7 * np.cos(ang), 7 * np.sin(ang),
                        0.8 * np.sin(2 * ang)], -1)
    return JScene(
        bh=JBlackHole.make(mass=0.5, spin=spin), background=flagship_sky(),
        disk=JDisk.make(r_in=2.0, r_out=6.0, texture=disk_tex),
        spheres=JSpheres.make(
            center=centers, radius=[0.6, 0.5, 0.7, 0.4],
            texture=np.broadcast_to(np.float32([0.3, 0.9, 0.4]),
                                    (4, 16, 32, 3))))


KERR_EVENTS_CFG = JRenderConfig(
    width=32, height=32, samples=1,
    integrator=JIntegratorConfig(n_steps=100, dt=0.12, dt_boost=64.0,
                                 dt_boost_r_ref=1.7, dt_power=1.5,
                                 backend="scan"),
    lam_max=100.0)
KERR_EVENTS_CAM = JCamera.make(position=(0.0, 0.0, 25.0),
                               euler=(0.25, 0.0, 0.0), fov=(0.8, 0.8))


def calm_pixels(scene, cam, cfg):
    """The pixels of a frame whose gradient float32 conditions well, from
    the port's plain forward: not on a silhouette (next to a pixel of
    another status or hit id: the shadow's edge, where rays circle near
    b_c, and the disk's and moons' edges), not ending within 0.05 rad of
    the sky's pole (whose checker varies along u there) and not on the disk
    texture's seam (its azimuth's derivative ~ 1 / |y|)."""
    with torch.no_grad():
        ys, xs = pixel_grid(cfg.width, cfg.height)
        o, d = generate_rays(cam, cfg.width, cfg.height, ys, xs)
        env = scene_env(scene, cfg, cam)
        s = tint.launch(env, o - scene.bh.loc, d, cfg.integrator)
        end = tint.final_direction(env, s)
    key = s.status * 8 + s.hit_obj
    edge = torch.zeros_like(key, dtype=torch.bool)
    for dim in (0, 1):
        step = key.diff(dim=dim) != 0
        pad = torch.zeros_like(step.narrow(dim, 0, 1))
        edge |= torch.cat([pad, step], dim=dim) | torch.cat([step, pad], dim)
    pole = end[..., :2].norm(dim=-1) < 0.05
    seam = ((s.status == tstates.DISK)
            & (s.x[..., 1].abs() < 0.05 * s.x[..., :2].norm(dim=-1)))
    return ~edge & ~pole & ~seam


@pytest.fixture(scope="module")
def kerr_events_grads():
    """The 32x32 Kerr events frame (bench.py's kerr-events row,
    :1032-1038): the images of JAX render_image with backend 'scan' and of
    the port, and d mean(calm * img[..., :3]^2) with respect to the mass,
    the spin, the camera position and the sky over the calm pixels
    (``calm_pixels``): (JAX image, JAX gradients, image, gradients, calm
    pixels)."""
    scene0 = kerr_events_scene()
    cfg = convert.render_config_from_reference(KERR_EVENTS_CFG)
    calm = calm_pixels(convert.scene_from_reference(scene0),
                       convert.camera_from_reference(KERR_EVENTS_CAM), cfg)

    def jloss(m, a, pos, sky):
        scene = dataclasses.replace(
            scene0, bh=dataclasses.replace(scene0.bh, mass=m, spin=a),
            background=sky)
        cam = dataclasses.replace(KERR_EVENTS_CAM, position=pos)
        img = jrender(scene, cam, KERR_EVENTS_CFG)
        w = jnp.asarray(calm.numpy(), jnp.float32)[..., None]
        return jnp.mean(w * img[..., :3] ** 2), img

    (_, jimg), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        jnp.float32(0.5), jnp.float32(0.45), KERR_EVENTS_CAM.position,
        scene0.background)
    scene = convert.scene_from_reference(scene0)
    cam = convert.camera_from_reference(KERR_EVENTS_CAM)
    leaves = (scene.bh.mass, scene.bh.spin, cam.position, scene.background)
    for t in leaves:
        t.requires_grad_(True)
    img = render_image(scene, cam, cfg)
    (calm[..., None] * img[..., :3].pow(2)).mean().backward()
    return (np.asarray(jimg), [np.asarray(g) for g in jg],
            img.detach().numpy(), [t.grad.numpy() for t in leaves], calm)


def test_kerr_events_render_matches_jax(kerr_events_grads):
    """bench.py's Kerr events frame at 32x32 against JAX render_image:
    the golden rule."""
    jimg, _, img, _, _ = kerr_events_grads
    assert np.isfinite(img).all()
    golden_rule(img, jimg, "Kerr events 32x32")


@pytest.mark.parametrize("i,what", [(0, "mass"), (1, "spin"),
                                    (2, "camera position"), (3, "sky")])
def test_kerr_events_render_gradients_match_jax(kerr_events_grads, i, what):
    """The 32x32 Kerr events frame's gradient over its calm pixels with
    respect to one parameter against jax.grad of the JAX render_image, to
    1e-3 of its largest component (readings: mass 5.0e-4, spin 2.5e-4,
    camera 3.9e-5, sky 9.7e-5).  The whole frame's reads 1.3e-3 (mass) to
    5.8e-3 (sky): its silhouettes, the 212 pixels near the sky's pole and
    the disk's seam are the badly conditioned part, as for the flagship
    (PERF.md)."""
    _, jg, _, tg, calm = kerr_events_grads
    assert int(calm.sum()) > 600
    assert np.abs(jg[i]).max() > 0
    close(tg[i], jg[i], 1e-3, what)


# =============================================================================
# The renderer's environment and convert.py.
# =============================================================================
@pytest.mark.parametrize("spin", [0.45, -0.3, None])
def test_scene_env_capture_radius_matches_jax(spin):
    """Capture at capture_factor times the outer horizon r_+ (2M without
    spin), and the spin carried into the environment."""
    scene = kerr_events_scene(spin)
    cfg = dataclasses.replace(KERR_EVENTS_CFG, capture_factor=1.1)
    jenv = jscene_env(scene, cfg, KERR_EVENTS_CAM)
    tenv = scene_env(convert.scene_from_reference(scene),
                     convert.render_config_from_reference(cfg),
                     convert.camera_from_reference(KERR_EVENTS_CAM))
    np.testing.assert_allclose(float(tenv.r_capture), float(jenv.r_capture),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tenv.r_escape), float(jenv.r_escape),
                               rtol=1e-6)
    if spin is None:
        assert tenv.spin is None
    else:
        assert float(tenv.spin) == np.float32(spin)


def test_convert_carries_a_spun_scene():
    """A spun JAX scene comes across with its spin as a float32 tensor that
    can take a gradient through the render."""
    tscene = convert.scene_from_reference(kerr_events_scene(-0.3))
    assert tscene.bh.spin.dtype == torch.float32
    assert float(tscene.bh.spin) == np.float32(-0.3)
    tscene.bh.spin.requires_grad_(True)
    cfg = dataclasses.replace(
        KERR_EVENTS_CFG, width=4, height=4, integrator=dataclasses.replace(
            KERR_EVENTS_CFG.integrator, n_steps=30))
    img = render_image(tscene, convert.camera_from_reference(KERR_EVENTS_CAM),
                       convert.render_config_from_reference(cfg))
    img[..., :3].pow(2).mean().backward()
    assert tscene.bh.spin.grad is not None
    assert torch.isfinite(tscene.bh.spin.grad)
