"""PyTorch port against the JAX package: massive particles and the
trajectory recorder -- ``timelike_init``, ``launch(..., time_like=True)``
with RK4 and Dormand-Prince, ``trajectory`` -- and twins of the first four
tests of tests/test_timelike.py on the port's plain path.

Tolerances: timelike_init's values to 1e-6 (float32, rsqrt against
jax.lax.rsqrt); integrated states as tests/test_torch_integrate.py holds
photons: statuses equal, x and lam within 1e-3, p within 1e-4.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu.ops import geodesic as jgeo  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import geodesic as tgeo  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import integrate as tint  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import states as tstates  # noqa: E402
from torch_particles import particle_fan  # noqa: E402

# the JAX package's ops/__init__ exports a function named ``integrate``
jint = importlib.import_module("blackhole_geodesic_calculator_tpu.ops.integrate")

M = 0.5
TOL_X, TOL_P = 1e-3, 1e-4


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def envs(lam_max, r_escape=200.0, spin=None):
    """The same environment in both packages: capture at r_s (or r_+)."""
    r_cap = 2 * M if spin is None else M + np.sqrt(M * M - spin * spin)
    kw = dict(mass=M, r_capture=r_cap, r_escape=r_escape, lam_max=lam_max)
    jenv = jint.GeodesicEnv(**{k: jnp.float32(v) for k, v in kw.items()},
                            spin=None if spin is None else jnp.float32(spin))
    tenv = tint.GeodesicEnv(**{k: torch.tensor(float(v))
                               for k, v in kw.items()},
                            spin=None if spin is None else torch.tensor(spin))
    return jenv, tenv


def random_inputs(kind, r_h=2 * M, n=2048, seed=1):
    """(x, v) for timelike_init: random positions from inside the horizon
    to r ~ 60 and velocities of any size; far from the hole (the flat
    limit); or all inside the horizon of radius ``r_h``, the centre
    included."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v = rng.normal(size=(n, 3)) * 10.0 ** rng.uniform(-2, 1, (n, 1))
    if kind == "random":
        r = 10.0 ** rng.uniform(-0.5, 1.8, n)
    elif kind == "flat":
        r = 10.0 ** rng.uniform(5, 7, n)
    else:
        r = rng.uniform(0.0, 0.99 * r_h, n)
        r[:2] = [0.0, 1e-7]
    return (u * r[:, None]).astype(np.float32), v.astype(np.float32)


@pytest.mark.parametrize("kind,spin", [
    ("random", None), ("flat", None), ("inside", None), ("random", 0.45),
    ("flat", 0.45)])
def test_timelike_init_matches_jax(kind, spin):
    """timelike_init against the JAX package's on the same inputs: p and E
    to 1e-6 (relative, with an absolute floor of 1e-6 of the row) times
    q's condition number: 1 / (1 - q) outside the horizon -- T divides by
    1 - q, so by the horizon one ulp of q (rsqrt against jax.lax.rsqrt)
    moves T by ulp / (1 - q) -- and q inside it, where p = v + q (T + s) l
    carries q's ulp times q; the gradient of a weighted sum of (p, E) to x and v
    finite everywhere, inside the horizon too (the double-where guard),
    and equal to jax.grad's to 1e-4 of its largest entry on the inputs
    with q < 0.9 or behind the guard (its 1 / (1 - q)^2 leaves two float32
    paths apart by the horizon; far out the x part is rounding).  The
    inside case is Schwarzschild's: inside a Kerr hole random positions
    reach the ring singularity, where the Kerr-Schild radius is itself a
    cancellation."""
    r_h = 2 * M if spin is None else M + np.sqrt(M * M - spin * spin)
    x, v = random_inputs(kind, r_h)
    a = None if spin is None else jnp.float32(spin)
    pj, Ej = jgeo.timelike_init(jnp.asarray(x), jnp.asarray(v), M, a)
    q = np.asarray(jgeo.ks_fields(jnp.asarray(x), M, a)[0], np.float64)
    cond = np.maximum(np.where(q < 1.0, 1.0 / np.maximum(1.0 - q, 1e-30),
                               q), 1.0)
    tx, tv = t(x).requires_grad_(True), t(v).requires_grad_(True)
    pt_, Et = tgeo.timelike_init(tx, tv, M,
                                 None if spin is None else torch.tensor(spin))
    for got, ref, c in ((pt_, pj, cond[:, None]), (Et, Ej, cond)):
        got, ref = got.detach().numpy().astype(np.float64), np.asarray(ref)
        assert np.isfinite(got).all()
        scale = np.abs(ref).max(-1, keepdims=True) if ref.ndim > 1 else 0.0
        np.testing.assert_array_less(np.abs(got - ref),
                                     (1e-6 * (np.abs(ref) + scale) + 1e-6)
                                     * c)
    w = np.random.default_rng(2).normal(size=(len(x), 4)).astype(np.float32)

    def jloss(x, v):
        p, E = jgeo.timelike_init(x, v, M, a)
        return jnp.sum(p * w[:, :3]) + jnp.sum(E * w[:, 3])

    gj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(v))
    ((pt_ * t(w[:, :3])).sum() + (Et * t(w[:, 3])).sum()).backward()
    got = np.concatenate([tx.grad.numpy(), tv.grad.numpy()], -1)
    ref = np.concatenate([np.asarray(g) for g in gj], -1)
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    held = (q < 0.9) | (q >= 1.0)
    assert held.mean() > 0.9
    err = np.abs(got - ref)[held].max() / np.abs(ref[held]).max()
    assert err <= 1e-4, err


def assert_states_agree(js, ts, what):
    """Statuses equal, x and lam within 1e-3, p within 1e-4 of max(1,
    |p|) (a particle's |p| grows to ~10 by the horizon)."""
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status),
                                  err_msg=what)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=TOL_X, err_msg=what)
    np.testing.assert_allclose(ts.lam.numpy(), np.asarray(js.lam), rtol=0,
                               atol=TOL_X, err_msg=what)
    pj = np.asarray(js.p)
    dp = np.abs(ts.p.numpy() - pj) / np.maximum(
        1.0, np.linalg.norm(pj, axis=-1, keepdims=True))
    assert dp.max() <= TOL_P, f"{what}: p {dp.max():.3e}"


@pytest.mark.parametrize("method", ["rk4", "dopri"])
def test_launch_timelike_matches_jax(method):
    """launch(..., time_like=True) of the particle fan on the port's plain
    path against the JAX package's scan path: RK4 on the flagship step
    schedule (bound orbits still ACTIVE at the end), and Dormand-Prince
    (bench.py's adaptive tolerances) until bound orbits end on the
    budget.  Every inside-horizon particle is marked and never moves."""
    x, v = particle_fan(1200)
    if method == "rk4":
        kw = dict(n_steps=100, dt=0.12, dt_boost=64.0, dt_boost_r_ref=1.7,
                  dt_power=1.5)
        lam_max = 1000.0
    else:
        kw = dict(n_steps=400, dt=0.05, method="dopri", rtol=1e-5,
                  atol=1e-8, max_step=4.0)
        lam_max = 60.0
    jenv, tenv = envs(lam_max, r_escape=70.0)
    js = jint.launch(jenv, jnp.asarray(x), jnp.asarray(v),
                     jint.IntegratorConfig(**kw, backend="scan", mode="while"),
                     time_like=True)
    ts = tint.launch(tenv, t(x), t(v), tint.IntegratorConfig(**kw,
                                                             backend="torch"),
                     time_like=True)
    st = ts.status.numpy()
    inside = st == tstates.INSIDE_HORIZON
    assert inside.any() and np.array_equal(ts.x.numpy()[inside], x[inside])
    for code in (tstates.CAPTURED, tstates.ESCAPED):
        assert (st == code).any()
    bound = tstates.ACTIVE if method == "rk4" else tstates.BUDGET
    assert (st == bound).sum() > len(x) // 3
    if method == "rk4":
        assert_states_agree(js, ts, "rk4")
        H = tgeo.hamiltonian(ts.x, ts.p, ts.E, M)[st == tstates.ACTIVE]
        assert float((H + 0.5).abs().max()) < 5e-4
        return
    # Dormand-Prince: two float32 controllers part on accept or reject
    # where the error norm sits at 1, and then sample the same path at
    # other points.  Statuses on >= 99.8%, as the reference holds its own
    # two paths, lam within max_step; the particles that do not fall in
    # and took the same trips (lam within 1e-4) to the states'
    # tolerances; and all that do not fall in, whatever their trips, by
    # what their path conserves: the angular momentum x cross p (to 1e-4
    # of max(1, |L|)) and Hh = -1/2 (5e-4).  A captured particle's last
    # step ends where p changes fastest, as a captured photon's (held by
    # status and lam alone, tests/test_torch_dopri.py).
    sj = np.asarray(js.status)
    agree = st == sj
    assert agree.mean() >= 0.998
    dlam = np.abs(ts.lam.numpy() - np.asarray(js.lam))
    assert dlam[agree].max() <= kw["max_step"] + 1e-3
    out = agree & (st != tstates.CAPTURED) & (st != tstates.INSIDE_HORIZON)
    same = out & (dlam <= 1e-4)
    assert same.sum() > out.sum() // 3
    k = torch.as_tensor(same)
    sub = lambda s, m: dataclasses.replace(  # noqa: E731
        s, x=s.x[m], p=s.p[m], lam=s.lam[m], status=s.status[m])
    assert_states_agree(sub(js, same), sub(ts, k), "dopri, same trips")
    Lj = np.cross(np.asarray(js.x), np.asarray(js.p))[out]
    Lt = np.cross(ts.x.numpy(), ts.p.numpy())[out]
    dL = np.abs(Lt - Lj).max(-1) / np.maximum(1.0, np.linalg.norm(Lj, axis=-1))
    assert dL.max() <= 1e-4, dL.max()
    H = tgeo.hamiltonian(ts.x, ts.p, ts.E, M).numpy()[out]
    assert np.abs(H + 0.5).max() < 5e-4


@pytest.mark.parametrize("time_like", [False, True], ids=["null", "timelike"])
def test_trajectory_matches_jax(time_like):
    """trajectory over 200 steps against the JAX package's: the start and
    every step's x within 1e-3, p within 1e-4; the final statuses equal,
    its lam within 1e-3."""
    if time_like:
        x, v = particle_fan(64, seed=3)
        keep = np.linalg.norm(x, axis=-1) > 2 * M   # trajectory marks none
        x, v = x[keep], v[keep]
    else:
        rng = np.random.default_rng(4)
        b = rng.uniform(1.5, 12.0, 48)
        x = np.stack([b, np.zeros(48), np.full(48, 25.0)], -1)
        v = np.tile([0.0, 0.0, -1.0], (48, 1))
        x, v = x.astype(np.float32), v.astype(np.float32)
    kw = dict(n_steps=200, dt=0.1, dt_boost=8.0, dt_power=1.0)
    jenv, tenv = envs(150.0, r_escape=70.0)
    xj, pj, sj = jint.trajectory(jenv, jnp.asarray(x), jnp.asarray(v),
                                 jint.IntegratorConfig(**kw, backend="scan"),
                                 time_like=time_like)
    xt, pt_, st = tint.trajectory(tenv, t(x), t(v),
                                  tint.IntegratorConfig(**kw), time_like)
    assert xt.shape == (201, len(x), 3) and pt_.shape == xt.shape
    np.testing.assert_array_equal(xt[0].numpy(), x)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=TOL_X)
    scale = np.maximum(1.0, np.linalg.norm(np.asarray(pj), axis=-1,
                                           keepdims=True))
    assert (np.abs(pt_.numpy() - np.asarray(pj)) / scale).max() <= TOL_P
    np.testing.assert_array_equal(st.status.numpy(), np.asarray(sj.status))
    np.testing.assert_allclose(st.lam.numpy(), np.asarray(sj.lam), rtol=0,
                               atol=TOL_X)
    assert (st.status.numpy() != tstates.ACTIVE).any()


def test_timelike_gradients_finite_inside_the_horizon():
    """The gradient of the particle fan's final positions to the initial
    velocities and the mass through the plain checkpointed loop: finite,
    the inside-horizon particles' zero."""
    x, v = particle_fan(300, seed=5)
    _, tenv = envs(1000.0, r_escape=70.0)
    mass = tenv.mass.clone().requires_grad_(True)
    tenv = dataclasses.replace(tenv, mass=mass)
    tv = t(v).requires_grad_(True)
    s = tint.launch(tenv, t(x), tv, tint.IntegratorConfig(
        n_steps=60, dt=0.12, dt_boost=64.0, dt_boost_r_ref=1.7, dt_power=1.5,
        backend="torch"), time_like=True)
    (s.x ** 2).sum().backward()
    assert torch.isfinite(tv.grad).all() and torch.isfinite(mass.grad)
    inside = s.status == tstates.INSIDE_HORIZON
    assert inside.any() and float(tv.grad[inside].abs().max()) == 0.0
    assert float(tv.grad[~inside].abs().max()) > 0.0


# Twins of tests/test_timelike.py's first four tests on the port's plain
# path (backend="torch").
def test_timelike_init_flat_limit():
    """M -> 0: T = sqrt(1 + |v|^2), p = v (special relativity)."""
    v = t([[0.3, -0.1, 0.2]])
    x = t([[5.0, 1.0, -2.0]])
    p, E = tgeo.timelike_init(x, v, 1e-12)
    np.testing.assert_allclose(p.numpy(), v.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(E[0]), float(torch.sqrt(1 + (v ** 2)
                                                             .sum())),
                               rtol=1e-6)


def test_timelike_normalization_conserved():
    """g u u = -1  <=>  Hh = -1/2, at init and all along the orbit."""
    r0 = 4.0
    omega = np.sqrt(M / r0 ** 3)
    ut = 1.0 / np.sqrt(1.0 - 3.0 * M / r0)
    v = t([[0.0, r0 * omega * ut, 0.0]])
    x = t([[r0, 0.0, 0.0]])
    p, E = tgeo.timelike_init(x, v, M)
    h0 = float(tgeo.hamiltonian(x, p, E, M)[0])
    assert abs(h0 + 0.5) < 1e-6, h0
    cfg = tint.IntegratorConfig(n_steps=2000, dt=0.05, dt_boost=1.0,
                                backend="torch")
    xs, ps, s = tint.trajectory(envs(lam_max=100.0)[1], x, v, cfg,
                                time_like=True)
    hs = tgeo.hamiltonian(xs, ps, s.E[None], M).numpy()
    assert np.abs(hs + 0.5).max() < 5e-4, np.abs(hs + 0.5).max()


def test_circular_orbit_stays_circular():
    """Circular timelike orbit at r = 8M: Omega = sqrt(M/r^3), dphi/dtau =
    Omega u^t with u^t = 1/sqrt(1 - 3M/r).  One full orbit keeps r
    constant."""
    r0 = 8.0 * M
    omega = np.sqrt(M / r0 ** 3)
    ut = 1.0 / np.sqrt(1.0 - 3.0 * M / r0)
    v = t([[0.0, r0 * omega * ut, 0.0]])
    x = t([[r0, 0.0, 0.0]])
    tau = 2 * np.pi / (omega * ut)
    cfg = tint.IntegratorConfig(n_steps=4000, dt=float(tau / 3800),
                                dt_boost=1.0, backend="torch")
    xs, _, s = tint.trajectory(envs(lam_max=float(tau * 0.99))[1], x, v,
                               cfg, time_like=True)
    r = np.linalg.norm(xs.numpy(), axis=-1)[:, 0]
    assert abs(r.max() - r0) < 2e-3 * r0
    assert abs(r.min() - r0) < 2e-3 * r0
    xy = xs.numpy()[:, 0, :2]
    phi = np.unwrap(np.arctan2(xy[:, 1], xy[:, 0]))
    assert abs((phi[-1] - phi[0]) - 2 * np.pi * 0.99) < 0.05


def test_perihelion_precession():
    """Eccentric orbit (p~ = 20 M, e = 0.2): perihelion advance per orbit
    against the exact Schwarzschild result by quadrature of dphi over one
    radial period, and above the leading-order 6 pi M / p."""
    from scipy.integrate import quad

    p_dimless, e = 20.0, 0.2
    p_phys = p_dimless * M
    r_peri = p_phys / (1 + e)
    E2 = ((p_dimless - 2 - 2 * e) * (p_dimless - 2 + 2 * e)
          / (p_dimless * (p_dimless - 3 - e * e)))
    L = M * p_dimless / np.sqrt(p_dimless - 3 - e * e)
    x = t([[r_peri, 0.0, 0.0]])
    v = t([[0.0, L / r_peri, 0.0]])

    def integrand(chi):
        r = p_phys / (1 + e * np.cos(chi))
        drdchi = p_phys * e * np.sin(chi) / (1 + e * np.cos(chi)) ** 2
        R = E2 - (1 - 2 * M / r) * (1 + L * L / (r * r))
        return (L / (r * r)) * drdchi / np.sqrt(max(R, 1e-30))

    exact = 2 * quad(integrand, 1e-8, np.pi - 1e-8, limit=200)[0] - 2 * np.pi
    cfg = tint.IntegratorConfig(n_steps=9000, dt=0.12, dt_boost=1.0,
                                backend="torch")
    xs, _, s = tint.trajectory(envs(lam_max=1000.0, r_escape=400.0)[1], x, v,
                               cfg, time_like=True)
    pos = xs.numpy()[:, 0, :]
    r = np.linalg.norm(pos, axis=-1)
    phi = np.unwrap(np.arctan2(pos[:, 1], pos[:, 0]))
    mins = np.where((r[1:-1] < r[:-2]) & (r[1:-1] < r[2:]))[0] + 1
    assert len(mins) >= 2, f"need two perihelion passages, got {len(mins)}"
    precession = phi[mins[1]] - phi[mins[0]] - 2 * np.pi
    assert precession == pytest.approx(exact, rel=0.02), (precession, exact)
    assert precession > 6 * np.pi * M / p_phys
