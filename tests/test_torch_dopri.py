"""PyTorch port against the JAX package: adaptive Dormand-Prince 5(4).

Inputs are made from numpy seeds and fed to both packages.  Covered:

* ops/integrate.py -- ``dopri_step``; the trip loop ``integrate_adaptive``
  (the plain version of the CUDA kernel dopri_fwd) on the fans of
  tests/test_pallas.py::test_dopri_kernel_parity, Schwarzschild, with the
  disk and a sphere, and Kerr; ``integrate_adaptive_scan`` against the
  while loop (a twin of tests/test_integrate.py's) and its gradient
  against ``jax.grad`` (twins of test_pallas.py's
  test_dopri_grad_kernel_adjoint and its Kerr case);
* ops/adjoint.py -- ``dopri_trip`` against the TPU kernel's
  ``_dopri_trip``, and the hand-derived ``dopri_trip_vjp`` against the TPU
  kernel's whole-trip ``_dopri_trip_adjoint`` and against torch.autograd
  of ``dopri_trip``, on single trips chosen to take every branch of the
  step controller and of the events;
* ops/cuda_kernel.py -- the plain checkpoint twin of dopri_ckpt;
* a 32x32 Einstein ring rendered with Dormand-Prince against the JAX
  package's render.

Tolerances: single trips to 1e-5 of the largest value (readings below
2e-6); final states of whole integrations as the reference holds its two
implementations (test_pallas.py:187-206: statuses equal on >= 99.8% of the
rays, lam within max_step, escaped directions within 2e-3 rad), and rays
with the same number of accepted steps to x and lam within 1e-3 and p
within 1e-4; gradients to the reference's 5e-2 ceiling and tighter where
the readings allow (stated in each test).
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
from blackhole_geodesic_calculator_tpu.models.kerr import horizon_radius as jhorizon  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import geodesic as jgeo  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import pallas_kernel as jpk  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import states as jstates  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import RenderConfig as JRenderConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import render_image as jrender  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import BlackHole as JBlackHole  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Scene as JScene  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Spheres as JSpheres  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import convert  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.models.kerr import horizon_radius  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import adjoint, cuda_kernel  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import integrate as tint  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import states as tstates  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops.geodesic import null_init as tnull  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.render.renderer import render_image  # noqa: E402

# the JAX package's ops/__init__ exports a function named ``integrate``
jint = importlib.import_module("blackhole_geodesic_calculator_tpu.ops.integrate")

MASS = 0.5
TOL_X, TOL_P = 1e-3, 1e-4
# the reference's cross-implementation invariants (test_pallas.py:187-206)
MIN_AGREE, TOL_ANGLE = 0.998, 2e-3
# the disk and the spheres of the trips' events (r_in 2, r_out 6)
SPH = np.array([[4.0, 0.0, 0.3, 1.0], [-3.0, 3.0, 0.0, 1.2]], np.float32)


def T(a):
    return torch.as_tensor(np.array(a))


def close(a, b, rtol, what):
    """|a - b| <= rtol * max|b|, elementwise; both finite."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert np.isfinite(a).all() and np.isfinite(b).all(), what
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= rtol, f"{what}: {err:.3e} > {rtol:g}"


def angle(a, b):
    """Angle between unit vectors, as 2 asin(|a - b| / 2) in float64."""
    chord = np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b), axis=-1)
    return 2.0 * np.arcsin(np.minimum(chord / 2.0, 1.0))


# =============================================================================
# dopri_step.
# =============================================================================
@pytest.mark.parametrize("spin", [None, 0.45], ids=["schw", "kerr"])
def test_dopri_step_matches_jax(spin):
    """integrate.dopri_step against the JAX package's: the 5th-order step
    to 1e-5 of the largest value, the embedded error to 1e-4 of its own
    largest (a difference of nearly equal sums: float32 cancellation,
    reading 2.5e-5)."""
    rng = np.random.default_rng(1)
    n = 2000
    r = rng.uniform(1.5, 30.0, n)
    u = rng.normal(size=(n, 3))
    x = (r[:, None] * u / np.linalg.norm(u, axis=-1, keepdims=True))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x, d = x.astype(np.float32), d.astype(np.float32)
    dt = rng.uniform(0.01, 1.0, n).astype(np.float32)
    a = None if spin is None else jnp.float32(spin)
    p, E = jgeo.null_init(jnp.asarray(x), jnp.asarray(d), jnp.float32(MASS),
                          a)
    jenv = jint.GeodesicEnv(mass=jnp.float32(MASS), r_capture=1.0,
                            r_escape=60.0, lam_max=70.0, spin=a)
    tenv = tint.GeodesicEnv(mass=torch.tensor(MASS), r_capture=1.0,
                            r_escape=60.0, lam_max=70.0,
                            spin=None if spin is None else torch.tensor(spin))
    ref = jint.dopri_step(jenv, jnp.asarray(x), p, E, jnp.asarray(dt))
    got = tint.dopri_step(tenv, T(x), T(p), T(E), T(dt))
    for g, rf, what, tol in zip(got, ref, ("x5", "p5", "ex", "ep"),
                                (1e-5, 1e-5, 1e-4, 1e-4)):
        close(g, rf, tol, what)


# =============================================================================
# Single trips: adjoint.dopri_trip and its hand-derived transpose.
# =============================================================================
CTL = adjoint.Controller(rtol=1e-5, atol=1e-8, min_step=1e-6, max_step=4.0)

# Each case: radii of the start points, the start direction ("random",
# "in", "out", "disk": heading down onto the disk's plane, "sphere": at
# sphere 0), the step h, controller overrides, the start lam, the share of
# frozen rays, the spin, the events, and the branch the case must take.
TRIPS = {
    "accepted": dict(r=(8, 20), h=1.2, expect="accepted"),
    "rejected": dict(r=(3, 5), h=2.0, expect="rejected"),
    "min_step": dict(r=(3, 6), h=3.0, ctl=dict(min_step=3.0),
                     expect="min_step"),
    "f_low": dict(r=(1.6, 2.5), h=4.0, expect="f_low"),
    "f_high": dict(r=(20, 40), h=0.002, expect="f_high"),
    "max_step": dict(r=(15, 30), h=0.45, ctl=dict(max_step=0.5),
                     expect="max_step"),
    "captured": dict(r=(1.01, 1.1), d="in", h=0.2, expect="captured"),
    "escaped": dict(r=(59.0, 59.5), d="out", h=2.0, expect="escaped"),
    "budget": dict(r=(8, 20), h=0.3, lam=69.9, expect="budget"),
    "disk": dict(d="disk", h=0.2, events=True, expect="disk"),
    "object": dict(d="sphere", h=1.0, events=True, expect="object"),
    "frozen": dict(r=(3, 20), h=0.5, frozen=0.5, events=True,
                   expect="frozen"),
    "kerr_0.45": dict(r=(1.8, 12), h=0.6, spin=0.45, events=True,
                      frozen=0.1, expect="mixed"),
    "kerr_-0.3": dict(r=(1.8, 12), h=0.6, spin=-0.3, events=True,
                      frozen=0.1, expect="mixed"),
}


def trip_case(name, n=256, seed=0):
    """(state dict of float32 numpy arrays, scal, controller, sph or None,
    kerr) of the trip case ``name``."""
    c = TRIPS[name]
    rng = np.random.default_rng(seed + len(name))
    spin = c.get("spin")
    if c.get("d") == "disk":
        rr = rng.uniform(2.5, 5.5, n)
        ph = rng.uniform(0, 2 * np.pi, n)
        x = np.stack([rr * np.cos(ph), rr * np.sin(ph),
                      rng.uniform(0.02, 0.1, n)], -1)
        d = np.stack([rng.uniform(-0.2, 0.2, n), rng.uniform(-0.2, 0.2, n),
                      -np.ones(n)], -1)
    elif c.get("d") == "sphere":
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        x = SPH[0, :3] + 1.6 * u
        d = SPH[0, :3] + 0.3 * rng.normal(size=(n, 3)) - x
    else:
        r = rng.uniform(*c["r"], n)
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        if c.get("events"):
            u[:, 2] *= 0.1        # near the disk's plane
            u /= np.linalg.norm(u, axis=-1, keepdims=True)
        x = r[:, None] * u
        d = {"in": -u, "out": u}.get(c.get("d"), rng.normal(size=(n, 3)))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    x, d = x.astype(np.float32), d.astype(np.float32)
    a = None if spin is None else jnp.float32(spin)
    p, E = jgeo.null_init(jnp.asarray(x), jnp.asarray(d), jnp.float32(MASS),
                          a)
    status = np.where(rng.random(n) < c.get("frozen", 0.0), jstates.ESCAPED,
                      jstates.ACTIVE).astype(np.int32)
    r_cap = 1.0 if spin is None else float(jhorizon(MASS, spin))
    scal = np.array([MASS, 0.05, 1.0, 1.0, r_cap, 60.0, 70.0, 2.0, 6.0,
                     0.0 if spin is None else spin], np.float32)
    state = dict(x=x.T.copy(), p=np.asarray(p).T.copy(), E=np.asarray(E),
                 h=np.full(n, c["h"], np.float32),
                 lam=np.full(n, c.get("lam", 0.0), np.float32),
                 status=status, obj=np.full(n, -1, np.int32))
    ctl = CTL._replace(**c.get("ctl", {}))
    return state, scal, ctl, SPH if c.get("events") else None, spin is not None


def F(a, dtype):
    """numpy -> torch, floats in ``dtype``."""
    a = np.array(a)
    return torch.as_tensor(a.astype(dtype) if a.dtype.kind == "f" else a)


def J(a, dtype):
    a = np.asarray(a)
    return jnp.asarray(a, dtype if a.dtype.kind == "f" else a.dtype)


def port_trip(st, scal, ctl, sph, kerr, dtype=np.float64):
    f = lambda a: F(a, dtype)  # noqa: E731
    out = adjoint.dopri_trip(
        tuple(map(f, st["x"])), tuple(map(f, st["p"])), f(st["E"]),
        f(st["h"]), f(st["lam"]), f(st["status"]), f(st["obj"]), f(scal),
        ctl, sph=None if sph is None else f(sph), has_disk=sph is not None,
        kerr=kerr)
    return [torch.stack(out[0]), torch.stack(out[1]), *out[2:]]


def jax_trip_args(st, scal, sph, dtype):
    f = lambda a: J(a, dtype)  # noqa: E731
    xp = tuple(f(v) for v in (*st["x"], *st["p"], st["E"]))
    return (xp, f(st["h"]), f(st["lam"]), f(st["status"]), f(st["obj"]),
            f(scal), None if sph is None else f(sph))


def jax_kw(sph, kerr, ctl):
    return dict(has_disk=sph is not None, n_sph=0 if sph is None else len(sph),
                kerr=kerr, rtol=ctl.rtol, atol=ctl.atol,
                min_step=ctl.min_step, max_step=ctl.max_step, enabled=None)


def check_branch(name, st, ctl, out):
    """The case takes the branch it is named for, on most of its rays."""
    expect = TRIPS[name]["expect"]
    live = st["status"] == jstates.ACTIVE
    moved = (out[0].numpy() != st["x"]).any(0) & live
    h1 = out[2].numpy()
    ratio = h1 / st["h"]
    stn = out[4].numpy()
    share = {
        "accepted": moved & (ratio > 0.21) & (ratio < 4.9),
        "rejected": ~moved & live & (ratio > 0.21) & (ratio < 0.99),
        "min_step": moved & (h1 == np.float32(ctl.min_step)),
        "f_low": ~moved & live & (np.abs(ratio - 0.2) < 1e-6),
        "f_high": moved & (np.abs(ratio - 5.0) < 1e-6),
        "max_step": moved & (h1 == np.float32(ctl.max_step)),
        "captured": stn == jstates.CAPTURED,
        "escaped": stn == jstates.ESCAPED,
        "budget": stn == jstates.BUDGET,
        "disk": stn == jstates.DISK,
        "object": stn == jstates.OBJECT,
        "frozen": ~live,
    }
    if expect == "mixed":
        assert share["accepted"].any() and share["rejected"].any()
        assert share["disk"].any() and share["frozen"].any()
    else:
        assert share[expect].mean() >= (0.4 if expect == "frozen" else 0.6), (
            f"{name}: {share[expect].mean():.2f} of the rays take the branch")
    if expect == "frozen":
        assert share["accepted"].any() and share["disk"].any()


@pytest.mark.parametrize("name", list(TRIPS))
def test_dopri_trip_matches_jax(name):
    """adjoint.dopri_trip against the TPU kernel's _dopri_trip on one trip
    of the case's rays.  In float64 (both packages) the next x, p, h and
    lam to 1e-10 of the largest value, statuses and hit ids equal: the
    same arithmetic.  In float32 statuses and hit ids equal, x, p and lam
    to 1e-5 (readings <= 2e-7); h is not held there: the embedded error
    is a difference of nearly equal sums, so in float32 the two packages'
    errn differ by up to 2e-3 relative (more where it is at the rounding
    floor and f near its clip at 5), and h' with it."""
    st, scal, ctl, sph, kerr = trip_case(name)
    out = port_trip(st, scal, ctl, sph, kerr)
    check_branch(name, st, ctl, out)
    kw = jax_kw(sph, kerr, ctl)
    with jax.enable_x64(True):
        ref = jpk._dopri_trip(*jax_trip_args(st, scal, sph, jnp.float64),
                              **kw)
        ref = [np.stack(ref[0][:3]), np.stack(ref[0][3:6]), *map(np.asarray,
                                                                 ref[1:])]
    for i, what in enumerate(("x", "p", "h", "lam")):
        close(out[i], ref[i], 1e-10, f"float64 {what}")
    np.testing.assert_array_equal(out[4].numpy(), ref[4])
    np.testing.assert_array_equal(out[5].numpy(), ref[5])
    out = port_trip(st, scal, ctl, sph, kerr, np.float32)
    ref = jpk._dopri_trip(*jax_trip_args(st, scal, sph, jnp.float32), **kw)
    close(out[0], np.stack(ref[0][:3]), 1e-5, "float32 x")
    close(out[1], np.stack(ref[0][3:6]), 1e-5, "float32 p")
    close(out[3], ref[2], 1e-5, "float32 lam")
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(out[5].numpy(), np.asarray(ref[4]))


def trip_vjp(st, scal, ctl, sph, kerr, g, gh):
    f = lambda a: F(a, np.float64)  # noqa: E731
    return adjoint.dopri_trip_vjp(
        tuple(map(f, st["x"])), tuple(map(f, st["p"])), f(st["E"]),
        f(st["h"]), f(st["lam"]), f(st["status"]), f(scal), ctl,
        tuple(map(f, g)), f(gh), sph=None if sph is None else f(sph),
        has_disk=sph is not None, kerr=kerr)


def cotangents(n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(6, n)), rng.normal(size=n)


@pytest.mark.parametrize("name", list(TRIPS))
def test_dopri_trip_vjp_matches_jax(name):
    """adjoint.dopri_trip_vjp against the TPU kernel's _dopri_trip_adjoint
    (a whole-trip jax.vjp) in float64: the cotangents of (x, p), E and h
    per ray, of the mass and the spin and of the (K, 4) sphere table, to
    1e-7 of the largest value (readings <= 1.9e-8, the mass's: a sum over
    rays of both signs) -- the transpose derived by hand is the same
    linear map."""
    st, scal, ctl, sph, kerr = trip_case(name)
    g, gh = cotangents(len(st["E"]))
    g6, gE, g_h, gscal, gsph = trip_vjp(st, scal, ctl, sph, kerr, g, gh)
    with jax.enable_x64(True):
        ref = jpk._dopri_trip_adjoint(
            *jax_trip_args(st, scal, sph, jnp.float64),
            tuple(map(jnp.asarray, g)), jnp.asarray(gh),
            **jax_kw(sph, kerr, ctl))
        jg6, jgE, jgh, jgscal, jgsph = jax.tree.map(np.asarray, ref)
    for i in range(6):
        close(g6[i], jg6[i], 1e-7, f"d(x, p)[{i}]")
    close(gE, jgE, 1e-7, "dE")
    close(g_h, jgh, 1e-7, "dh")
    close(gscal[[0, 9]] if kerr else gscal[0], jgscal[[0, 9]] if kerr
          else jgscal[0], 1e-7, "d(mass, a)")
    np.testing.assert_array_equal(gscal[1:9].numpy(), 0.0)
    if sph is not None:
        close(gsph, jgsph, 1e-7, "dsph")


def test_accept_on_err2_matches_the_square_root():
    """The kernels' accept test on the squared error norm
    (adjoint.error_accepts, dopri_trip.cuh's: not err2 > 1 + 2^-23) agrees
    with the plain path's errn <= 1, errn = sqrt(err2) and 0 where err2 is
    not positive, on every float32 within 2^12 ulps of 1, at +-0, on
    subnormals, at the least normal float, at inf and at NaN; the float
    after 1 is accepted and the one after it is not."""
    one = int(np.array(1.0, np.float32).view(np.int32))
    near = np.arange(one - 4096, one + 4097, dtype=np.int32).view(np.float32)
    sub = np.array([1, 2, 3, 1 << 10, 1 << 22, (1 << 23) - 1],
                   np.int32).view(np.float32)
    special = np.array([0.0, -0.0, np.finfo(np.float32).tiny, 1e-20, 1e30,
                        np.inf, -np.inf, np.nan], np.float32)
    err2 = np.concatenate([near, sub, special])
    with np.errstate(invalid="ignore"):
        errn = np.where(err2 > 0, np.sqrt(np.where(err2 > 0, err2, 1.0)),
                        0.0).astype(np.float32)
    got = adjoint.error_accepts(torch.from_numpy(err2)).numpy()
    np.testing.assert_array_equal(got, errn <= 1.0)
    t = torch.from_numpy(err2)
    pos = t > 0
    plain = torch.where(pos, torch.sqrt(torch.where(pos, t, 1.0)), 0.0)
    assert torch.equal(adjoint.error_accepts(t), plain <= 1.0)
    after = np.nextafter(np.float32(1), np.float32(2))
    assert bool(adjoint.error_accepts(torch.tensor(after)))
    assert not bool(adjoint.error_accepts(
        torch.tensor(np.nextafter(after, np.float32(2)))))
    assert int(got[:near.size].sum()) == 4096 + 2


@pytest.mark.parametrize("name", ["rejected", "f_low", "max_step", "object",
                                  "kerr_0.45"])
def test_dopri_trip_vjp_matches_autograd(name):
    """adjoint.dopri_trip_vjp against torch.autograd of adjoint.dopri_trip
    (the plain path's own framework), float64, 1e-7 of the largest
    (readings <= 2.7e-9)."""
    st, scal, ctl, sph, kerr = trip_case(name)
    g, gh = cotangents(len(st["E"]), seed=4)
    leaf = lambda a: F(a, np.float64).requires_grad_(True)  # noqa: E731
    f = lambda a: F(a, np.float64)  # noqa: E731
    x, p = tuple(map(leaf, st["x"])), tuple(map(leaf, st["p"]))
    E, h, s = leaf(st["E"]), leaf(st["h"]), leaf(scal)
    sp = None if sph is None else leaf(sph)
    out = adjoint.dopri_trip(x, p, E, h, f(st["lam"]), f(st["status"]),
                             f(st["obj"]), s, ctl, sph=sp,
                             has_disk=sph is not None, kerr=kerr)
    loss = (f(gh) * out[2]).sum()
    for i, c in enumerate((*out[0], *out[1])):
        loss = loss + (f(g[i]) * c).sum()
    inputs = [*x, *p, E, h, s] + ([sp] if sp is not None else [])
    grads = torch.autograd.grad(loss, inputs)
    g6, gE, g_h, gscal, gsph = trip_vjp(st, scal, ctl, sph, kerr, g, gh)
    for i in range(6):
        close(g6[i], grads[i], 1e-7, f"d(x, p)[{i}]")
    close(gE, grads[6], 1e-7, "dE")
    close(g_h, grads[7], 1e-7, "dh")
    close(gscal[0], grads[8][0], 1e-7, "d mass")
    if kerr:
        close(gscal[9], grads[8][9], 1e-7, "d a")
    if sph is not None:
        close(gsph, grads[9], 1e-7, "dsph")


# =============================================================================
# Whole integrations.
# =============================================================================
def pallas_rays(n=900, seed=11):
    """tests/test_pallas.py's rays(): z = 25, offsets in [-8, 8], directions
    within 0.3 of -z."""
    rng = np.random.default_rng(seed)
    x0 = np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                   np.full(n, 25.0)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  np.full(n, -1.0)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x0, d.astype(np.float32)


def envs(name):
    """The three environments of test_dopri_kernel_parity (:173-182), in
    both packages."""
    kw = dict(r_capture=1.0, r_escape=60.0, lam_max=70.0)
    jkw = {k: jnp.float32(v) for k, v in kw.items()}
    tkw = {k: torch.tensor(v) for k, v in kw.items()}
    if name == "kerr":
        jkw["r_capture"], tkw["r_capture"] = (jnp.float32(0.95),
                                              torch.tensor(0.95))
        jkw["spin"], tkw["spin"] = jnp.float32(0.45), torch.tensor(0.45)
    if name == "events":
        jkw["r_capture"], tkw["r_capture"] = jnp.float32(1.0), torch.tensor(1.0)
        jkw["disk"] = jint.DiskGeom(r_in=jnp.float32(2.0),
                                    r_out=jnp.float32(6.0))
        jkw["spheres"] = jint.SphereGeom(center=jnp.asarray([[2.0, 0.0, 10.0]]),
                                         radius=jnp.asarray([3.0]))
        tkw["disk"] = tint.DiskGeom(r_in=torch.tensor(2.0),
                                    r_out=torch.tensor(6.0))
        tkw["spheres"] = tint.SphereGeom(center=torch.tensor([[2.0, 0.0, 10.0]]),
                                         radius=torch.tensor([3.0]))
    return (jint.GeodesicEnv(mass=jnp.float32(MASS), **jkw),
            tint.GeodesicEnv(mass=torch.tensor(MASS), **tkw))


def initial(jenv, tenv, x0, d0):
    p0, E0 = jgeo.null_init(jnp.asarray(x0), jnp.asarray(d0), jenv.mass,
                            jenv.spin)
    js = jstates.init_state(jnp.asarray(x0), p0, E0)
    ts = tstates.init_state(T(x0), T(np.asarray(p0)), T(np.asarray(E0)))
    return js, ts


DOPRI = dict(n_steps=400, dt=0.05, method="dopri", mode="while", rtol=1e-5,
             atol=1e-8, max_step=4.0)


def assert_adaptive_agree(jenv, ref, tenv, got, max_step):
    """A plain Dormand-Prince integration of the port against the JAX
    package's: the reference's invariants between its two implementations
    (statuses on >= 99.8% of the rays, lam within max_step, final
    directions within 2e-3 rad), and tightly what shading reads, where the
    two make the same decisions: the final direction of a ray that ends
    on the sky (ESCAPED, BUDGET) within 1e-4 rad, the event point and lam
    of a ray that ends on the disk or a sphere within 1e-3.  The two
    controllers' h differ by float32 rounding of the error norm, so their
    trips sample the same path at other points: a ray's end lies up to a
    step apart along it, and x or p there is not held tightly."""
    st_r, st_p = np.asarray(ref.status), got.status.numpy()
    assert (st_r == st_p).mean() >= MIN_AGREE
    m = st_r == st_p
    dlam = np.abs(np.asarray(ref.lam) - got.lam.numpy())
    assert dlam[m].max() <= max_step + 1e-3
    ang = angle(tint.final_direction(tenv, got).numpy(),
                jint.final_direction(jenv, ref))
    assert ang[m].max() < TOL_ANGLE
    sky = m & ((st_p == tstates.ESCAPED) | (st_p == tstates.BUDGET))
    assert sky.any() and ang[sky].max() <= 1e-4, ang[sky].max()
    ev = m & ((st_p == tstates.DISK) | (st_p == tstates.OBJECT))
    if ev.any():
        np.testing.assert_allclose(got.x.numpy()[ev], np.asarray(ref.x)[ev],
                                   rtol=0, atol=TOL_X)
        assert dlam[ev].max() <= TOL_X


@pytest.mark.parametrize("name", ["schw", "events", "kerr"])
def test_integrate_adaptive_matches_jax(name):
    """integrate_adaptive against the JAX package's on the rays of
    test_dopri_kernel_parity (assert_adaptive_agree; readings: statuses
    all equal, sky directions <= 1.6e-5 rad, event points <= 1.5e-5), and
    the accepted-step counts equal on >= 99% of the rays (reading 99.8%):
    the two controllers accept and reject alike."""
    jenv, tenv = envs(name)
    js0, ts0 = initial(jenv, tenv, *pallas_rays())
    ref, jnacc = jint.integrate_adaptive(jenv, js0,
                                         jint.IntegratorConfig(**DOPRI))
    got, nacc = tint.integrate_adaptive(tenv, ts0,
                                        tint.IntegratorConfig(**DOPRI))
    assert_adaptive_agree(jenv, ref, tenv, got, DOPRI["max_step"])
    assert (np.asarray(jnacc) == nacc.numpy()).mean() >= 0.99
    if name == "events":
        st = got.status.numpy()
        assert (st == tstates.DISK).any() and (st == tstates.OBJECT).any()
    # the dispatch: no gradient recorded -> integrate_adaptive
    via = tint.integrate(tenv, ts0, tint.IntegratorConfig(**DOPRI))
    assert torch.equal(via.x, got.x) and torch.equal(via.status, got.status)


def test_adaptive_scan_matches_while_loop():
    """Twin of tests/test_integrate.py::test_adaptive_scan_matches_while_loop:
    the checkpointed trip loop runs the while loop's trips, so the final
    states are equal bit for bit (a frozen ray is an identity under a
    trip), and the JAX package's scan agrees (assert_adaptive_agree)."""
    n = 13
    b = np.linspace(1.8, 8.0, n)
    x0 = np.stack([b, np.zeros(n), np.full(n, 20.0)], -1).astype(np.float32)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1)).astype(np.float32)
    tenv = tint.GeodesicEnv(mass=torch.tensor(MASS),
                            r_capture=torch.tensor(1.0),
                            r_escape=torch.tensor(45.0),
                            lam_max=torch.tensor(80.0))
    cfg = dict(n_steps=400, dt=0.1, method="dopri", rtol=1e-5, atol=1e-8,
               max_step=2.0)
    p0, E0 = tnull(T(x0), T(d0), tenv.mass)
    s0 = tstates.init_state(T(x0), p0, E0)
    s_while, nacc = tint.integrate_adaptive(tenv, s0,
                                            tint.IntegratorConfig(**cfg))
    s_scan = tint.integrate_adaptive_scan(tenv, s0,
                                          tint.IntegratorConfig(**cfg))
    assert int(nacc.max()) < cfg["n_steps"]
    for f in ("x", "p", "lam", "status", "hit_obj"):
        assert torch.equal(getattr(s_while, f), getattr(s_scan, f)), f
    jenv = jint.GeodesicEnv(mass=jnp.float32(MASS),
                            r_capture=jnp.float32(1.0),
                            r_escape=jnp.float32(45.0),
                            lam_max=jnp.float32(80.0))
    pj, Ej = jgeo.null_init(jnp.asarray(x0), jnp.asarray(d0), jenv.mass)
    jscan = jint.integrate_adaptive_scan(
        jenv, jstates.init_state(jnp.asarray(x0), pj, Ej),
        jint.IntegratorConfig(**cfg))
    assert_adaptive_agree(jenv, jscan, tenv, s_scan, cfg["max_step"])


def test_ckpt_plain_rows_follow_the_trip_loop():
    """cuda_kernel.integrate_adaptive_ckpt_plain (dopri_ckpt's plain
    version): its final state equals integrate_adaptive's bit for bit, and
    row k holds the state and h before trip k seg, as the while loop run
    for k seg trips has them."""
    jenv, tenv = envs("events")
    _, ts0 = initial(jenv, tenv, *pallas_rays(300, seed=2))
    cfg = tint.IntegratorConfig(**{**DOPRI, "n_steps": 90})
    seg = cuda_kernel.segment(cfg.n_steps)
    final, rows, hs = cuda_kernel.integrate_adaptive_ckpt_plain(
        tenv, ts0, cfg, seg)
    ref, _ = tint.integrate_adaptive(tenv, ts0, cfg)
    assert seg == 16 and len(rows) == len(hs) == 6
    for f in ("x", "p", "lam", "status", "hit_obj"):
        assert torch.equal(getattr(final, f), getattr(ref, f)), f
    assert torch.equal(hs[0], torch.full_like(ts0.lam, 0.05))
    k = 3
    part, _ = tint.integrate_adaptive(
        tenv, ts0, dataclasses.replace(cfg, n_steps=k * seg))
    for f in ("x", "p", "lam", "status"):
        assert torch.equal(getattr(rows[k], f), getattr(part, f)), f


def weak_fan(n, seed):
    """The weak-field fan of test_dopri_grad_kernel_adjoint (:241-250):
    b in [6.5, 12] at z = 25, direction -z, and the loss weights."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(6.5, 12.0, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    x0 = np.stack([b * np.cos(ang), b * np.sin(ang), np.full(n, 25.0)],
                  -1).astype(np.float32)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1)).astype(np.float32)
    return x0, d0, rng.normal(size=(n, 3)).astype(np.float32)


def test_adaptive_gradient_matches_jax():
    """Twin of test_dopri_grad_kernel_adjoint: the port's plain gradient
    (autograd of integrate_adaptive_scan, the plain version of
    dopri_ckpt/dopri_bwd) of escape directions and frozen event points,
    with respect to the mass and the initial positions, against jax.grad
    of the JAX package's integrate_adaptive_scan.  The reference holds its
    two implementations to 5e-2; here the mass and the positions to 1e-2
    of the largest (readings 1.6e-3 and 4.2e-4)."""
    n = 320
    x0, d0, wx = weak_fan(n, 3)
    cfg = dict(n_steps=96, dt=0.05, method="dopri", mode="scan", rtol=1e-5,
               atol=1e-8, max_step=4.0)

    def jloss(m, x0_):
        env = jint.GeodesicEnv(
            mass=m, r_capture=1.0, r_escape=jnp.float32(60.0),
            lam_max=jnp.float32(70.0),
            disk=jint.DiskGeom(r_in=jnp.float32(5.0), r_out=jnp.float32(9.0)),
            spheres=jint.SphereGeom(center=jnp.asarray([[6.5, 0.0, 10.0]]),
                                    radius=jnp.asarray([1.5])))
        p0, E0 = jgeo.null_init(x0_, jnp.asarray(d0), m, None)
        s = jint.integrate_adaptive_scan(
            env, jstates.init_state(x0_, p0, E0),
            jint.IntegratorConfig(**cfg))
        d1 = jint.final_direction(env, s)
        esc = (s.status == jstates.ESCAPED)[..., None]
        ev = ((s.status == jstates.DISK)
              | (s.status == jstates.OBJECT))[..., None]
        return jnp.sum(jnp.where(esc, wx * d1, 0.0)
                       + jnp.where(ev, wx * s.x, 0.0)), s.status

    (v_r, st_r), g_r = jax.value_and_grad(jloss, argnums=(0, 1),
                                          has_aux=True)(jnp.float32(MASS),
                                                        jnp.asarray(x0))
    m = torch.tensor(MASS, requires_grad=True)
    x = T(x0).requires_grad_(True)
    env = tint.GeodesicEnv(
        mass=m, r_capture=torch.tensor(1.0), r_escape=torch.tensor(60.0),
        lam_max=torch.tensor(70.0),
        disk=tint.DiskGeom(r_in=torch.tensor(5.0), r_out=torch.tensor(9.0)),
        spheres=tint.SphereGeom(center=torch.tensor([[6.5, 0.0, 10.0]]),
                                radius=torch.tensor([1.5])))
    p0, E0 = tnull(x, T(d0), m)
    s = tint.integrate(env, tstates.init_state(x, p0, E0),
                       tint.IntegratorConfig(**cfg))
    d1 = tint.final_direction(env, s)
    esc = (s.status == tstates.ESCAPED)[..., None]
    ev = ((s.status == tstates.DISK) | (s.status == tstates.OBJECT))[..., None]
    v = (torch.where(esc, T(wx) * d1, 0.0)
         + torch.where(ev, T(wx) * s.x, 0.0)).sum()
    v.backward()
    st_p = s.status.numpy()
    assert (np.asarray(st_r) == st_p).mean() >= MIN_AGREE
    assert (st_p == tstates.DISK).any() and (st_p == tstates.OBJECT).any()
    assert abs(float(v) - float(v_r)) / abs(float(v_r)) < 1e-3
    close(m.grad, g_r[0], 1e-2, "d/dmass")
    close(x.grad, g_r[1], 1e-2, "d/dx0")


def test_adaptive_gradient_matches_jax_kerr():
    """Twin of test_dopri_grad_kernel_adjoint_kerr: the (mass, spin)
    gradient of final directions through the plain Kerr trip loop against
    jax.grad of the JAX package's; the reference's 5e-2, held here to 1e-3
    (readings 9.2e-6 and 3.9e-5).  The directions are those of the rays
    that end on the sky, ESCAPED or BUDGET: within 80 trips this fan's
    rays reach lam_max = 70 before r_escape = 60, so a loss of ESCAPED
    rays alone would be 0."""
    n = 256
    x0, d0, wx = weak_fan(n, 7)
    cfg = dict(n_steps=80, dt=0.05, method="dopri", mode="scan", rtol=1e-5,
               atol=1e-8, max_step=4.0)

    def jloss(m, a):
        env = jint.GeodesicEnv(mass=m, spin=a, r_capture=jhorizon(m, a),
                               r_escape=jnp.float32(60.0),
                               lam_max=jnp.float32(70.0))
        p0, E0 = jgeo.null_init(jnp.asarray(x0), jnp.asarray(d0), m, a)
        s = jint.integrate_adaptive_scan(
            env, jstates.init_state(jnp.asarray(x0), p0, E0),
            jint.IntegratorConfig(**cfg))
        sky = ((s.status == jstates.ESCAPED)
               | (s.status == jstates.BUDGET))[..., None]
        return jnp.sum(jnp.where(sky, wx * jint.final_direction(env, s), 0.0))

    g_r = jax.grad(jloss, argnums=(0, 1))(jnp.float32(MASS), jnp.float32(0.45))
    m = torch.tensor(MASS, requires_grad=True)
    a = torch.tensor(0.45, requires_grad=True)
    env = tint.GeodesicEnv(mass=m, spin=a, r_capture=horizon_radius(m, a),
                           r_escape=torch.tensor(60.0),
                           lam_max=torch.tensor(70.0))
    p0, E0 = tnull(T(x0), T(d0), m, a)
    s = tint.integrate(env, tstates.init_state(T(x0), p0, E0),
                       tint.IntegratorConfig(**cfg))
    sky = ((s.status == tstates.ESCAPED)
           | (s.status == tstates.BUDGET))[..., None]
    torch.where(sky, T(wx) * tint.final_direction(env, s), 0.0).sum().backward()
    assert float(m.grad) != 0.0 and float(a.grad) != 0.0
    close(m.grad, g_r[0], 1e-3, "d/dmass")
    close(a.grad, g_r[1], 1e-3, "d/dspin")


def ring_scene(size):
    """BASELINE config 2 (tests/test_golden_baseline.py:65-91) at
    ``size``^2: the 64x128 sky, one green moon at (0, 0, -12) of radius 1
    behind a hole of mass 0.5, camera (0, 0, 20), fov 0.9."""
    h, w = 64, 128
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sky = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * u / w)
                    * np.sin(np.pi * v / h), v / h,
                    ((u // 8 + v // 8) % 2).astype(np.float32)],
                   -1).astype(np.float32)
    moon = np.zeros((8, 16, 3), np.float32)
    moon[..., 1] = 1.0
    scene = JScene(bh=JBlackHole.make(mass=0.5), background=jnp.asarray(sky),
                   spheres=JSpheres.make(center=[[0.0, 0.0, -12.0]],
                                         radius=[1.0], texture=[moon]))
    cam = JCamera.make(position=(0.0, 0.0, 20.0), fov=(0.9, 0.9))
    cfg = JRenderConfig(
        width=size, height=size, samples=1, lam_max=120.0,
        integrator=jint.IntegratorConfig(
            n_steps=2000, dt=0.5, method="dopri", mode="while", rtol=1e-5,
            atol=1e-8, max_step=2.0))
    return scene, cam, cfg


def test_einstein_ring_render_matches_jax():
    """A 32x32 Einstein ring (BASELINE config 2, the 512^2 golden's scene)
    through the port's Dormand-Prince render against the JAX package's:
    the golden rule of tests/test_golden.py (mean |d| < 2e-3, < 1% of the
    elements off by > 0.1); the ring is green and the shadow black."""
    scene, cam, cfg = ring_scene(32)
    ref = np.asarray(jrender(scene, cam, cfg))
    img = render_image(convert.scene_from_reference(scene, device="cpu"),
                       convert.camera_from_reference(cam, device="cpu"),
                       convert.render_config_from_reference(cfg))
    img = img.numpy()
    assert img.shape == (32, 32, 4) and np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert diff.mean() < 2e-3 and (diff > 0.1).mean() < 0.01, diff.mean()
    assert (img[16, 16, :3] < 0.02).all()
    assert img[16, 22:32, 1].max() > 0.5


@pytest.mark.parametrize("grad", [False, True], ids=["forward", "gradient"])
def test_dopri_on_cpu_takes_the_plain_path(grad):
    """On CPU tensors the Dormand-Prince entry launches no kernel: "auto"
    runs the plain loop (integrate_adaptive, or integrate_adaptive_scan when
    autograd records the call) and "cuda" raises, forward and gradient."""
    _, tenv = envs("events")
    _, ts0 = initial(*envs("events"), *pallas_rays(64, seed=5))
    cfg = tint.IntegratorConfig(**{**DOPRI, "n_steps": 40})
    mass = tenv.mass.clone().requires_grad_(grad)
    env = dataclasses.replace(tenv, mass=mass)
    before = dict(cuda_kernel.LAUNCHES)
    with torch.set_grad_enabled(grad):
        auto = tint.integrate(env, ts0, cfg)
        ref = (tint.integrate_adaptive_scan(env, ts0, cfg) if grad
               else tint.integrate_adaptive(env, ts0, cfg)[0])
        with pytest.raises(ValueError, match="CUDA device"):
            tint.integrate(env, ts0, dataclasses.replace(cfg, backend="cuda"))
    assert dict(cuda_kernel.LAUNCHES) == before
    assert torch.equal(auto.x, ref.x) and torch.equal(auto.status, ref.status)
    assert auto.x.requires_grad == grad
