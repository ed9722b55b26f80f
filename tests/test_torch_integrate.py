"""PyTorch port against the JAX package: the fixed-step RK4 integrator.

The plain PyTorch integrator (the CPU path, and the reference the CUDA
kernel is held against on the card) is compared with the JAX package's TPU
kernel path, ``integrate_pallas(..., interpret=True)``, and with its XLA scan
path, on the flagship step schedule.

Tolerances (float32 on both sides; rsqrt and summation order differ by a
few ulp per step, amplified near the photon sphere): statuses equal, x and
lam within 1e-3, p within 1e-4, final directions within 1e-4 rad -- an
eighth of the 7.8e-4 rad pixel of the 1024 px / 0.8 rad flagship camera.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu.ops import states as jstates  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops.geodesic import null_init as jnull  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops.pallas_kernel import integrate_pallas  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import _build, cuda_kernel  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import integrate as tint  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import states as tstates  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops.geodesic import null_init as tnull  # noqa: E402

# the JAX package's ops/__init__ exports a function named ``integrate``
jint = importlib.import_module("blackhole_geodesic_calculator_tpu.ops.integrate")

TOL_X, TOL_P, TOL_DIR = 1e-3, 1e-4, 1e-4
FLAGSHIP = dict(n_steps=100, dt=0.12, dt_boost=64.0, dt_boost_r_ref=1.7,
                dt_power=1.5)


def fan(n=1500, n_inside=36):
    """The bench's camera fan -- impact parameters b in [1.5, 2.45] u
    [2.75, 12] at z = 25, direction -z, skirting b_c = 3 sqrt(3) M -- plus
    ``n_inside`` rays that start inside the horizon."""
    b = np.concatenate([np.linspace(1.5, 2.45, n // 2),
                        np.linspace(2.75, 12.0, n - n // 2)])
    ang = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    x0 = np.stack([b * np.cos(ang), b * np.sin(ang), np.full(n, 25.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))
    rng = np.random.default_rng(7)
    xin = rng.uniform(-0.5, 0.5, (n_inside, 3))
    din = rng.normal(size=(n_inside, 3))
    din /= np.linalg.norm(din, axis=-1, keepdims=True)
    return (np.concatenate([x0, xin]).astype(np.float32),
            np.concatenate([d0, din]).astype(np.float32))


def envs(mass=0.5):
    kw = dict(r_capture=2.0 * mass, r_escape=70.0, lam_max=100.0)
    jenv = jint.GeodesicEnv(mass=jnp.float32(mass),
                            **{k: jnp.float32(v) for k, v in kw.items()})
    tenv = tint.GeodesicEnv(mass=torch.tensor(mass),
                            **{k: torch.tensor(v) for k, v in kw.items()})
    return jenv, tenv


def port_launch(tenv, x0, d0, **cfg):
    cfg = tint.IntegratorConfig(**{**FLAGSHIP, "backend": "torch", **cfg})
    return tint.launch(tenv, torch.as_tensor(x0), torch.as_tensor(d0), cfg)


def angle(a, b):
    """Angle between unit vectors, as 2 asin(|a - b| / 2) in float64."""
    chord = np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b), axis=-1)
    return 2.0 * np.arcsin(np.minimum(chord / 2.0, 1.0))


def assert_states_agree(jenv, js, tenv, ts):
    np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0,
                               atol=TOL_X)
    np.testing.assert_allclose(ts.lam.numpy(), np.asarray(js.lam), rtol=0,
                               atol=TOL_X)
    np.testing.assert_allclose(ts.p.numpy(), np.asarray(js.p), rtol=0,
                               atol=TOL_P)
    dang = angle(tint.final_direction(tenv, ts).numpy(),
                 jint.final_direction(jenv, js))
    assert dang.max() <= TOL_DIR, dang.max()


@pytest.mark.parametrize("tile_order", ["none", "cost"])
def test_plain_matches_jax_kernel_path(tile_order):
    """integrate_plain against the TPU kernel K1 in interpret mode; with
    tile_order='cost' the kernel's row reordering fires (sub=4 rows/tile)."""
    jenv, tenv = envs()
    x0, d0 = fan()
    cfg = jint.IntegratorConfig(**FLAGSHIP, tile_order=tile_order)
    p0, E0 = jnull(jnp.asarray(x0), jnp.asarray(d0), jenv.mass)
    s0 = jstates.init_state(jnp.asarray(x0), p0, E0)
    s0.status = jnp.where(jenv.radius(jnp.asarray(x0)) <= jenv.r_capture,
                          jstates.INSIDE_HORIZON, s0.status)
    js = integrate_pallas(jenv, s0, cfg, sub=4 if tile_order == "cost"
                          else None, interpret=True)

    p0t, E0t = tnull(torch.as_tensor(x0), torch.as_tensor(d0), tenv.mass)
    ts0 = tstates.init_state(torch.as_tensor(x0), p0t, E0t)
    ts0.status = ts0.status.masked_fill(
        tenv.radius(ts0.x) <= tenv.r_capture, tstates.INSIDE_HORIZON)
    tcfg = tint.IntegratorConfig(**FLAGSHIP, tile_order=tile_order)
    ts = cuda_kernel.integrate_plain(tenv, ts0, tcfg)

    counts = np.bincount(ts.status.numpy(), minlength=8)
    assert counts[tstates.CAPTURED] and counts[tstates.ESCAPED]
    assert counts[tstates.INSIDE_HORIZON] == 36
    assert_states_agree(jenv, js, tenv, ts)


def test_plain_matches_jax_scan():
    jenv, tenv = envs()
    x0, d0 = fan()
    js = jint.launch(jenv, jnp.asarray(x0), jnp.asarray(d0),
                     jint.IntegratorConfig(**FLAGSHIP, backend="scan"))
    ts = port_launch(tenv, x0, d0)
    inside = ts.status == tstates.INSIDE_HORIZON
    assert int(inside.sum()) == 36
    np.testing.assert_array_equal(ts.x[inside].numpy(), x0[-36:])
    assert (ts.lam[inside] == 0).all()
    assert_states_agree(jenv, js, tenv, ts)


@pytest.mark.parametrize("power", [1.0, 2.0, 1.3])
def test_plain_matches_jax_scan_other_powers(power):
    """The other step-size schedules the kernel compiles (power 1, 2 and a
    general power), with a budget short enough that BUDGET rays occur."""
    jenv, tenv = envs()
    jenv.lam_max = jnp.float32(30.0)
    tenv.lam_max = torch.tensor(30.0)
    x0, d0 = fan(500, 12)
    cfg = {**FLAGSHIP, "dt_power": power, "n_steps": 60}
    js = jint.launch(jenv, jnp.asarray(x0), jnp.asarray(d0),
                     jint.IntegratorConfig(**cfg, backend="scan"))
    ts = port_launch(tenv, x0, d0, **cfg)
    assert (ts.status == tstates.BUDGET).any()
    assert_states_agree(jenv, js, tenv, ts)


def test_auto_backend_on_cpu_takes_the_plain_path():
    _, tenv = envs()
    x0, d0 = fan(64, 4)
    before = dict(cuda_kernel.LAUNCHES)
    auto = port_launch(tenv, x0, d0, backend="auto")
    plain = port_launch(tenv, x0, d0, backend="torch")
    assert dict(cuda_kernel.LAUNCHES) == before
    for a, b in zip(dataclasses.astuple(auto), dataclasses.astuple(plain)):
        assert torch.equal(a, b)


def test_cuda_backend_on_cpu_raises():
    _, tenv = envs()
    x0, d0 = fan(64, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        port_launch(tenv, x0, d0, backend="cuda")


def _state(n=8):
    x = torch.tensor([[0.0, 3.0, 25.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1)
    p, E = tnull(x, d, 0.5)
    return tstates.init_state(x, p, E)


# The holes an unknown integrator method is refused on, by test id:
# Schwarzschild, Kerr, and Kerr with a disk and a sphere.
DOPRI_HOLES = {"dopri": (False, False), "spin": (True, False),
               "spin-events": (True, True)}


@pytest.mark.parametrize("case", list(DOPRI_HOLES))
def test_out_of_slice_raises(case):
    """Dormand-Prince and RK4 are the only integrators (JAX
    ops/integrate.py:510-529): any other method raises ValueError on the
    CUDA entry and on the plain path, for each hole of DOPRI_HOLES; the
    Dormand-Prince holes themselves run (tests/test_torch_dopri.py)."""
    _, env = envs()
    s0 = _state()
    cfg = tint.IntegratorConfig(**FLAGSHIP, method="rk45")
    kerr, events = DOPRI_HOLES[case]
    if kerr:
        env.spin = torch.tensor(0.45)
    if events:
        env.disk = tint.DiskGeom(r_in=torch.tensor(2.0),
                                 r_out=torch.tensor(6.0))
        env.spheres = tint.SphereGeom(center=torch.zeros(1, 3),
                                      radius=torch.ones(1))
    with pytest.raises(ValueError, match="rk45"):
        cuda_kernel.integrate_cuda(env, s0, cfg)
    with pytest.raises(ValueError, match="rk45"):
        tint.integrate(env, s0, dataclasses.replace(cfg, backend="torch"))
    out = tint.integrate(env, s0, dataclasses.replace(
        cfg, method="dopri", backend="torch", n_steps=4))
    assert torch.isfinite(out.x).all()


@pytest.mark.parametrize("field,bad", [
    ("x", lambda t: t.double()),
    ("status", lambda t: t.long()),
    ("p", lambda t: t[:, :2]),
    ("lam", lambda t: t[None]),
], ids=["x-float64", "status-int64", "p-shape", "lam-shape"])
def test_integrate_cuda_checks_its_inputs(field, bad):
    """Wrong dtypes and shapes raise before anything reaches the kernel."""
    _, env = envs()
    s0 = _state()
    setattr(s0, field, bad(getattr(s0, field)))
    with pytest.raises((TypeError, ValueError), match=field):
        cuda_kernel.integrate_cuda(env, s0, tint.IntegratorConfig(**FLAGSHIP))


def test_scalars_follow_the_tpu_layout():
    _, env = envs()
    cfg = tint.IntegratorConfig(**FLAGSHIP)
    scal = cuda_kernel._scalars(env, cfg, torch.device("cpu"))
    assert scal.dtype == torch.float32 and scal.shape == (cuda_kernel.NSCAL,)
    np.testing.assert_allclose(
        scal.numpy(), [0.5, 0.12, 64.0, 1.7, 1.0, 70.0, 100.0, 0, 0, 0],
        rtol=1e-7)
    # r_ref defaults to 6 M and the boost to at least 1
    cfg = tint.IntegratorConfig(dt_boost=0.5)
    scal = cuda_kernel._scalars(env, cfg, torch.device("cpu"))
    assert float(scal[2]) == 1.0 and float(scal[3]) == 3.0


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails raises and leaves no library behind."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load()
    assert not list(tmp_path.rglob("*.so"))


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


@pytest.mark.parametrize("defines", [("BHGC_SPHERE_GUARD=0",),
                                     ("BHGC_IEEE_RECIPROCALS=1",)])
def test_witness_build_keys_its_own_library(defines):
    """A witness build's definitions are nvcc flags and key a library of
    their own, so it never takes the shipped library's place on disk."""
    assert _build._flags(()) == _build.NVCC_FLAGS
    assert _build._flags(defines) == _build.NVCC_FLAGS + (f"-D{defines[0]}",)
    assert _build.library_path(defines) != _build.library_path()
    assert _build.library_path(defines) == _build.library_path(
        tuple(defines))


def test_failed_witness_build_names_its_definition(tmp_path, monkeypatch):
    """The definitions reach every nvcc command of a witness build."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="-DBHGC_SPHERE_GUARD=0"):
        _build.build(("BHGC_SPHERE_GUARD=0",))
    assert not list(tmp_path.rglob("*.so"))


def test_built_with_restores_the_shipped_library(monkeypatch):
    """Launches inside built_with go through the witness library, and the
    shipped one is back after the block, also when the block raises."""
    shipped, witness, built = object(), object(), []
    monkeypatch.setattr(_build, "_lib", shipped)
    monkeypatch.setattr(_build, "build",
                        lambda defines=(): built.append(defines) or "w.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: witness)
    monkeypatch.setattr(_build, "_declare", lambda lib: lib)
    with pytest.raises(KeyError):
        with _build.built_with("BHGC_SPHERE_GUARD=0") as lib:
            assert lib is witness and _build.load() is witness
            raise KeyError
    assert built == [("BHGC_SPHERE_GUARD=0",)]
    assert _build.load() is shipped
