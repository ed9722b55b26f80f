"""PyTorch port against the JAX package: the gradient path.

Inputs are made from numpy seeds and fed to both packages.  Covered:

* ops/adjoint.py, the hand-written adjoint of one RK4 step that the CUDA
  kernel rk4_bwd.cu mirrors line by line, against ``jax.vjp`` of the TPU
  kernel's SoA functions (``_rhs_schw_soa``, ``_dt_soa``) and the TPU
  kernel's own ``_step_adjoint``, and against ``torch.autograd`` of the
  port's ``_fixed_step``;
* ``integrate_fixed``, the checkpointed step loop autograd runs on the CPU;
* the texture sampler's hand-written backward;
* gradients of whole renders with respect to the mass, the camera position
  and the sky.

Tolerances, each with its reading on this suite's inputs: a single VJP
agrees to float32 rounding (readings <= 1e-6 relative), held to 1e-5; the
integrator's gradients use the reference's rtol 1e-4 (test_pallas.py:100);
whole renders need 1e-3 (see ``test_flagship_render_gradients_match_jax``).
"""

import dataclasses
import fractions
import importlib
import math
import os

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
from blackhole_geodesic_calculator_tpu.scene import Scene as JScene  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene.texture import sample_bpy as jsample  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import convert  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import adjoint, cuda_kernel  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import integrate as tint  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import states as tstates  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops.geodesic import null_init as tnull  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.render.renderer import render_image  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.scene import texture  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.scene.texture import sample_bpy  # noqa: E402

# the JAX package's ops/__init__ exports a function named ``integrate``
jint = importlib.import_module("blackhole_geodesic_calculator_tpu.ops.integrate")

POWERS = [1.5, 1.0, 2.0, 1.3]
FLAGSHIP = dict(n_steps=100, dt=0.12, dt_boost=64.0, dt_boost_r_ref=1.7,
                dt_power=1.5)
# [mass, dt, dt_boost, r_ref, r_capture, r_escape, lam_max, r_in, r_out, a]
SCAL = np.array([0.5, 0.12, 64.0, 1.7, 1.0, 70.0, 100.0, 0.0, 0.0, 0.0],
                np.float32)


def T(a):
    return torch.as_tensor(np.array(a))


def close(a, b, rtol, what):
    """|a - b| <= rtol * max|b|, elementwise; both finite."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert np.isfinite(a).all() and np.isfinite(b).all(), what
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= rtol, f"{what}: {err:.3e} > {rtol:g}"


def step_inputs(n=1500, seed=0):
    """Rays at radii 1.5..60 around an M = 0.5 hole with random directions
    (p, E from the null condition), a fifth of them frozen (ESCAPED), and
    random output cotangents; SoA numpy arrays."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.5, 60.0, n)
    u = rng.normal(size=(n, 3))
    x = r[:, None] * u / np.linalg.norm(u, axis=-1, keepdims=True)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p, E = jnull(jnp.asarray(x, jnp.float32), jnp.asarray(d, jnp.float32),
                 jnp.float32(0.5))
    status = np.where(rng.random(n) < 0.2, jstates.ESCAPED,
                      jstates.ACTIVE).astype(np.int32)
    g = rng.normal(size=(6, n)).astype(np.float32)
    return (x.T.astype(np.float32), np.asarray(p).T, np.asarray(E), status,
            g)


# =============================================================================
# ops/adjoint.py: the hand-derived VJPs.
# =============================================================================
def test_rhs_vjp_matches_jax():
    x, p, E, _, g = step_inputs()

    def rhs(a0, a1, a2, b0, b1, b2, E_, m):
        return jpk._rhs_schw_soa(m, E_)(a0, a1, a2, b0, b1, b2)

    args = [jnp.asarray(v) for v in (*x, *p, E)] + [jnp.float32(0.5)]
    out, vjp = jax.vjp(rhs, *args)
    jg = vjp(tuple(jnp.asarray(v) for v in g))
    tout = adjoint.rhs(T(np.float32(0.5)), T(E), tuple(map(T, x)),
                       tuple(map(T, p)))
    tg, tE, tm = adjoint.rhs_vjp(T(np.float32(0.5)), T(E), tuple(map(T, x)),
                                 tuple(map(T, p)), tuple(map(T, g)))
    for i in range(6):
        close(tout[i], out[i], 1e-5, f"rhs[{i}]")
        close(tg[i], jg[i], 1e-5, f"d(x, p)[{i}]")
    close(tE, jg[6], 1e-5, "dE")
    close(tm.sum(), jg[7], 1e-5, "dmass")


@pytest.mark.parametrize("power", POWERS)
def test_step_size_vjp_matches_jax(power):
    """The four power forms of _dt_soa and the clip to [1, boost]: r_ref =
    1.7 puts rays on both sides of both clip edges."""
    x, _, _, status, _ = step_inputs()
    active = status == jstates.ACTIVE
    gh = np.random.default_rng(1).normal(size=x.shape[1]).astype(np.float32)

    def dt(a0, a1, a2, scal):
        return jpk._dt_soa(a0, a1, a2, jnp.asarray(active), scal,
                           jnp.bool_(True), False, power)

    h, vjp = jax.vjp(dt, *map(jnp.asarray, x), jnp.asarray(SCAL))
    jg = vjp(jnp.asarray(gh))
    xs = tuple(map(T, x))
    close(adjoint.step_size(xs, T(active), T(SCAL), power), h, 1e-6, "dt")
    ga, g_dt, g_boost, g_rref = adjoint.step_size_vjp(
        xs, T(active), T(SCAL), power, T(gh))
    for i in range(3):
        close(ga[i], jg[i], 1e-5, f"dx[{i}]")
    close(torch.stack([g_dt.sum(), g_boost.sum(), g_rref.sum()]),
          jg[3][1:4], 1e-5, "d(dt, boost, r_ref)")
    assert float(g_boost.abs().sum()) > 0 or power == 1.0


@pytest.mark.parametrize("power", POWERS)
def test_step_adjoint_matches_jax(power):
    """adjoint.step_adjoint against the TPU kernel's _step_adjoint."""
    x, p, E, status, g = step_inputs()
    g6, gE, gscal, _ = adjoint.step_adjoint(
        tuple(map(T, x)), tuple(map(T, p)), T(E), T(status), T(SCAL),
        tuple(map(T, g)), power)
    jg6, jgE, jgscal, _ = jpk._step_adjoint(
        tuple(jnp.asarray(v) for v in (*x, *p, E)),
        jnp.zeros_like(jnp.asarray(E)), jnp.asarray(status), None,
        jnp.asarray(SCAL), None, tuple(map(jnp.asarray, g)),
        has_disk=False, n_sph=0, kerr=False, power=power,
        enabled=jnp.bool_(True))
    for i in range(6):
        close(g6[i], jg6[i], 1e-5, f"d(x, p)[{i}]")
    close(gE, jgE, 1e-5, "dE")
    close(gscal, jgscal, 1e-5, "dscal")
    frozen = status != jstates.ACTIVE
    np.testing.assert_array_equal(gE.numpy()[frozen], 0.0)
    np.testing.assert_array_equal(g6[0].numpy()[frozen], g[0][frozen])


@pytest.mark.parametrize("power", POWERS)
def test_step_adjoint_matches_autograd(power):
    """adjoint.step_adjoint against torch.autograd of the port's
    _fixed_step.  r_ref defaults to 6 M here, so the mass cotangent comes
    through the scalar vector's entries 0 and 3."""
    x, p, E, status, g = step_inputs(seed=3)
    mass = torch.tensor(0.5, requires_grad=True)
    env = tint.GeodesicEnv(mass=mass, r_capture=torch.tensor(1.0),
                           r_escape=torch.tensor(70.0),
                           lam_max=torch.tensor(100.0))
    cfg = tint.IntegratorConfig(**{**FLAGSHIP, "dt_boost_r_ref": 0.0,
                                   "dt_power": power})
    xl, pl, El = (T(x.T.copy()).requires_grad_(True),
                  T(p.T.copy()).requires_grad_(True),
                  T(E).requires_grad_(True))
    s = tstates.init_state(xl, pl, El)
    s.status = T(status)
    s1 = tint._fixed_step(env, cfg, s)
    gt = T(g)
    loss = (s1.x * gt[:3].T).sum() + (s1.p * gt[3:].T).sum()
    loss.backward()

    scal = cuda_kernel._scalars(env, cfg, torch.device("cpu")).detach()
    g6, gE, gscal, _ = adjoint.step_adjoint(
        tuple(map(T, x)), tuple(map(T, p)), T(E), T(status), scal,
        tuple(map(T, g)), power)
    close(torch.stack(g6[:3], -1), xl.grad, 1e-5, "dx")
    close(torch.stack(g6[3:], -1), pl.grad, 1e-5, "dp")
    close(gE, El.grad, 1e-5, "dE")
    close(gscal[0] + 6.0 * gscal[3], mass.grad, 1e-5, "dmass")


# =============================================================================
# integrate_fixed: the checkpointed step loop.
# =============================================================================
def envs(mass=0.5):
    kw = dict(r_capture=2.0 * mass, r_escape=70.0, lam_max=100.0)
    jenv = jint.GeodesicEnv(mass=jnp.float32(mass),
                            **{k: jnp.float32(v) for k, v in kw.items()})
    tenv = tint.GeodesicEnv(mass=torch.tensor(mass),
                            **{k: torch.tensor(v) for k, v in kw.items()})
    return jenv, tenv


def camera_rays(n=512, seed=1):
    """Rays from z = 25 towards the hole with impact parameters across the
    shadow and the lensed sky (bench.py's fan, away from b_c), and a few
    starting inside the horizon."""
    rng = np.random.default_rng(seed)
    b = np.where(rng.random(n) < 0.5, rng.uniform(1.5, 2.45, n),
                 rng.uniform(2.75, 12.0, n))
    ang = rng.uniform(0.0, 2 * np.pi, n)
    x0 = np.stack([b * np.cos(ang), b * np.sin(ang), np.full(n, 25.0)], -1)
    x0[:8] = rng.uniform(-0.5, 0.5, (8, 3))
    d = np.stack([rng.uniform(-0.02, 0.02, n), rng.uniform(-0.02, 0.02, n),
                  -np.ones(n)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x0.astype(np.float32), d.astype(np.float32)


def port_state(tenv, x0, d0):
    p0, E0 = tnull(x0, d0, tenv.mass)
    s0 = tstates.init_state(x0, p0, E0)
    s0.status = s0.status.masked_fill(tenv.radius(x0) <= tenv.r_capture,
                                      tstates.INSIDE_HORIZON)
    return s0


def test_integrate_fixed_forward_equals_fast():
    """Under autograd the plain path takes integrate_fixed, which runs all
    n_steps; its forward equals the early-exit loop bit for bit."""
    _, tenv = envs()
    x0, d0 = map(T, camera_rays())
    cfg = tint.IntegratorConfig(**FLAGSHIP)
    fast = tint.integrate_fixed_fast(tenv, port_state(tenv, x0, d0), cfg)
    xg = x0.clone().requires_grad_(True)
    s = tint.integrate(tenv, port_state(tenv, xg, d0),
                       dataclasses.replace(cfg, backend="torch"))
    assert s.x.requires_grad
    counts = np.bincount(s.status.numpy(), minlength=8)
    assert counts[tstates.CAPTURED] and counts[tstates.ESCAPED]
    for name in ("x", "p", "lam", "status"):
        assert torch.equal(getattr(s, name).detach(), getattr(fast, name))


@pytest.mark.parametrize("n_steps,seg", [(10, 3), (10, 5), (10, 1), (10, 0)],
                         ids=["tail", "no-tail", "seg1", "sqrt"])
def test_integrate_fixed_runs_exactly_n_steps(n_steps, seg):
    """Full segments plus an unsegmented tail run exactly n_steps steps
    (10 = 3 x 3 + 1; seg 0 means int(sqrt(10)) = 3), never a ceil'd
    segment count: the state equals n_steps plain steps bit for bit and
    differs from n_steps - 1 and n_steps + 1."""
    _, tenv = envs()
    x0, d0 = map(T, camera_rays(64))
    cfg = tint.IntegratorConfig(**{**FLAGSHIP, "n_steps": n_steps,
                                   "remat_segment": seg})
    xg = x0.clone().requires_grad_(True)
    s = tint.integrate_fixed(tenv, port_state(tenv, xg, d0), cfg)
    plain = [port_state(tenv, x0, d0)]
    for _ in range(n_steps + 1):
        plain.append(tint._fixed_step(tenv, cfg, plain[-1]))
    assert torch.equal(s.x.detach(), plain[n_steps].x)
    assert torch.equal(s.lam.detach(), plain[n_steps].lam)
    for other in (plain[n_steps - 1], plain[n_steps + 1]):
        assert not torch.equal(s.lam.detach(), other.lam)
    s.x.sum().backward()
    assert torch.isfinite(xg.grad).all()


@pytest.mark.parametrize("reference", ["scan", "pallas"])
def test_integrate_fixed_gradients_match_jax(reference):
    """The loss of test_pallas.py:82-92 (a weighted sum of final positions
    over rays neither CAPTURED nor ERROR) on the flagship step schedule:
    gradients with respect to the mass, x0 and d0 against jax.grad of the
    JAX integrate_fixed and of the TPU kernels in interpret mode."""
    x0, d0 = camera_rays()
    wx = np.random.default_rng(2).normal(size=x0.shape).astype(np.float32)
    cfg = dict(FLAGSHIP, n_steps=64)

    def jloss(mass, x0_, d0_):
        env = jint.GeodesicEnv(mass=mass, r_capture=2.0 * mass,
                               r_escape=jnp.float32(70.0),
                               lam_max=jnp.float32(100.0))
        p0, E0 = jnull(x0_, d0_, env.mass)
        s0 = jstates.init_state(x0_, p0, E0)
        s0.status = jnp.where(env.radius(x0_) <= env.r_capture,
                              jstates.INSIDE_HORIZON, s0.status)
        c = jint.IntegratorConfig(**cfg)
        s = (jpk.integrate_pallas(env, s0, c, interpret=True)
             if reference == "pallas" else jint.integrate_fixed(env, s0, c))
        ok = ((s.status != jstates.CAPTURED)
              & (s.status != jstates.ERROR))[..., None]
        return jnp.sum(jnp.where(ok, jnp.asarray(wx) * s.x, 0.0))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.float32(0.5), jnp.asarray(x0), jnp.asarray(d0))

    mass = torch.tensor(0.5, requires_grad=True)
    xl, dl = T(x0).requires_grad_(True), T(d0).requires_grad_(True)
    tenv = tint.GeodesicEnv(mass=mass, r_capture=2.0 * mass,
                            r_escape=torch.tensor(70.0),
                            lam_max=torch.tensor(100.0))
    s = tint.integrate(tenv, port_state(tenv, xl, dl),
                       tint.IntegratorConfig(**cfg))
    ok = ((s.status != tstates.CAPTURED)
          & (s.status != tstates.ERROR))[..., None]
    torch.where(ok, T(wx) * s.x, 0.0).sum().backward()
    for got, want, what in ((mass.grad, jg[0], "mass"), (xl.grad, jg[1], "x0"),
                            (dl.grad, jg[2], "d0")):
        close(got, want, 1e-4, what)


# =============================================================================
# The texture sampler's backward.
# =============================================================================
WHERE = ["interior", "seam", "poles"]


def texture_inputs(where):
    """A 16x32 texture, 4000 bpy coordinates -- inside, at the x = +-1 seam
    (the +1 column wraps) or at the y = +-1 pole rows (rows clip) -- and
    output cotangents; numpy float32."""
    rng = np.random.default_rng({"interior": 4, "seam": 5, "poles": 6}[where])
    tex = rng.uniform(size=(16, 32, 3)).astype(np.float32)
    n = 4000
    x = rng.uniform(-0.95, 0.95, n)
    y = rng.uniform(-0.95, 0.95, n)
    edge = rng.uniform(0.96, 1.0, n) * rng.choice([-1.0, 1.0], n)
    if where == "seam":
        x = edge
    elif where == "poles":
        y = edge
    x, y = x.astype(np.float32), y.astype(np.float32)
    g = rng.normal(size=(n, 3)).astype(np.float32)
    return tex, x, y, g


@pytest.mark.parametrize("where", WHERE)
def test_sample_bpy_backward_matches_jax(where):
    """dtex, dx and dy against jax.vjp of the JAX sample_bpy (its quad
    scatter with the row fold and column roll) -- at the x = +-1 seam, where
    the +1 column wraps, and at the y = +-1 pole rows, where rows clip."""
    tex, x, y, g = texture_inputs(where)
    out, vjp = jax.vjp(jsample, jnp.asarray(tex), jnp.asarray(x),
                       jnp.asarray(y))
    jtex, jx, jy = vjp(jnp.asarray(g))
    tt, tx, ty = (T(tex).requires_grad_(True), T(x).requires_grad_(True),
                  T(y).requires_grad_(True))
    tout = sample_bpy(tt, tx, ty)
    tout.backward(T(g))
    close(tout.detach(), out, 1e-6, "sample")
    close(tt.grad, jtex, 1e-5, "dtex")
    close(tx.grad, jx, 1e-5, "dx")
    close(ty.grad, jy, 1e-5, "dy")


TEX_GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                          "sample_bpy_backward.npz")


def texture_golden():
    """texture_inputs and jax.vjp of the JAX sample_bpy on them, for each
    of WHERE: {f"{where}_{name}": float32 array}."""
    out = {}
    for where in WHERE:
        tex, x, y, g = texture_inputs(where)
        _, vjp = jax.vjp(jsample, jnp.asarray(tex), jnp.asarray(x),
                         jnp.asarray(y))
        grads = (np.asarray(v, np.float32) for v in vjp(jnp.asarray(g)))
        for name, a in zip(("tex", "x", "y", "g", "dtex", "dx", "dy"),
                           (tex, x, y, g, *grads)):
            out[f"{where}_{name}"] = a
    return out


@pytest.mark.parametrize("where", WHERE)
def test_sample_bpy_backward_golden(where):
    """The golden that tests/test_torch_cuda.py holds the card's texture
    backward to, where JAX is not installed, is texture_inputs and jax.vjp
    of the JAX sample_bpy on them, bit for bit (REGEN_GOLDEN=1 writes it
    anew)."""
    want = texture_golden()
    if os.environ.get("REGEN_GOLDEN") == "1" or not os.path.exists(
            TEX_GOLDEN):
        np.savez_compressed(TEX_GOLDEN, **want)
        pytest.skip(f"golden regenerated: {TEX_GOLDEN}")
    with np.load(TEX_GOLDEN) as z:
        assert sorted(z.files) == sorted(want)
        for name in want:
            if name.startswith(where + "_"):
                assert z[name].dtype == np.float32, name
                assert np.array_equal(z[name], want[name]), name


@pytest.mark.parametrize("learn_tex", [True, False])
def test_sample_bpy_backward_on_cpu_is_plain(learn_tex, monkeypatch):
    """CPU tensors take sample_bpy_bwd_plain, never the kernel's wrapper,
    and count no launch; a frozen texture gets no cotangent."""
    tex, x, y, g = texture_inputs("interior")
    tt, tx, ty = (T(tex).requires_grad_(learn_tex),
                  T(x).requires_grad_(True), T(y).requires_grad_(True))
    out = sample_bpy(tt, tx, ty)
    want = texture.sample_bpy_bwd_plain(*out.grad_fn.saved_tensors, T(g),
                                        tt.shape, learn_tex)

    def refuse(*args):
        raise AssertionError("the CPU path launched tex_bwd")

    monkeypatch.setattr(cuda_kernel, "tex_bwd", refuse)
    before = dict(cuda_kernel.LAUNCHES)
    out.backward(T(g))
    assert dict(cuda_kernel.LAUNCHES) == before
    assert (tt.grad is None) == (not learn_tex)
    for got, w in zip((tt.grad, tx.grad, ty.grad), want):
        assert (got is None and w is None) or torch.equal(got, w)


def test_tex_bwd_refuses_cpu_tensors():
    """The kernel's wrapper raises on CPU tensors: no fallback."""
    tex, x, y, g = texture_inputs("interior")
    out = sample_bpy(T(tex).requires_grad_(True), T(x).requires_grad_(True),
                     T(y))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_kernel.tex_bwd(*out.grad_fn.saved_tensors, T(g), tex.shape,
                            True)


F32_MAX = float(np.finfo(np.float32).max)
F32_TINY = float(np.finfo(np.float32).smallest_subnormal)


@pytest.mark.parametrize("max_abs,n", [
    (0.0, 5 * 1024 ** 2), (1.0, 5 * 1024 ** 2), (F32_MAX, 5 * 1024 ** 2),
    (F32_TINY, 5 * 1024 ** 2), (F32_MAX, 2 ** 31 - 1), (F32_TINY, 2 ** 31 - 1),
    (F32_TINY, 1), (3.0, 1)])
def test_tex_bwd_exponent(max_abs, n):
    """tex_bwd.cu's fixed-point exponent (its host mirror): n terms of
    magnitude up to max_abs scaled by 2^k sum to less than 2^62, so no
    texel's int64 sum overflows, and to at least 2^60, so at most two bits
    of the int64 go unused; every nonzero float32 term scales to a normal
    double and 2^-k, which converts the sums back, is one too.  max_abs = 0
    gives k = 0."""
    k = cuda_kernel.tex_bwd_exponent(max_abs, n)
    if max_abs == 0.0:
        assert k == 0
        return
    top = fractions.Fraction(n) * fractions.Fraction(max_abs) * (
        fractions.Fraction(2) ** k)
    assert 2 ** 60 <= top < 2 ** 62
    assert abs(k) <= 1022
    assert math.ldexp(F32_TINY, k) >= 2.0 ** -1022


@pytest.mark.parametrize("where", WHERE)
def test_tex_bwd_fixed_point_sum(where):
    """tex_bwd.cu's texture cotangent, emulated with numpy: each term g w
    (float32, the plain path's) scaled by 2^k (tex_bwd_exponent) and
    rounded to int64.  The sums are the same bit for bit with the rays in
    another order, and within one float32 rounding of the float64 sum of
    the same terms -- closer than the plain path's float32 sums."""
    tex, x, y, g = texture_inputs(where)
    out = sample_bpy(T(tex).requires_grad_(True), T(x).requires_grad_(True),
                     T(y).requires_grad_(True))
    saved = out.grad_fn.saved_tensors
    _, _, _, _, tx, ty, xi0, xi1, yi0, yi1 = (t.numpy() for t in saved)
    h, w, c = tex.shape
    k = cuda_kernel.tex_bwd_exponent(float(np.abs(g).max()), len(x))
    one = np.float32(1.0)
    terms = [((yi0 * w + xi0), (one - tx) * (one - ty)),
             ((yi0 * w + xi1), tx * (one - ty)),
             ((yi1 * w + xi0), (one - tx) * ty), ((yi1 * w + xi1), tx * ty)]

    def fixed(order):
        acc = np.zeros(h * w * c, np.int64)
        exact = np.zeros(h * w * c, np.float64)
        for texel, wgt in terms:
            v = (g * wgt[:, None])[order]
            idx = (texel[:, None] * c + np.arange(c))[order]
            np.add.at(acc, idx, np.rint(np.ldexp(v.astype(np.float64), k))
                      .astype(np.int64))
            np.add.at(exact, idx, v.astype(np.float64))
        return (np.ldexp(acc.astype(np.float64), -k).astype(np.float32),
                exact)

    got, exact = fixed(np.arange(len(x)))
    again, _ = fixed(np.random.default_rng(7).permutation(len(x)))
    assert np.array_equal(got.view(np.int32), again.view(np.int32))
    assert (np.abs(got - exact) <= np.spacing(np.abs(exact).astype(
        np.float32))).all()
    plain = texture.sample_bpy_bwd_plain(*saved, T(g), tex.shape, True)[0]
    assert (np.abs(got - exact).max()
            <= np.abs(plain.numpy().reshape(-1) - exact).max())


# =============================================================================
# Whole renders.
# =============================================================================
def smooth_sky():
    """tests/test_grad.py's sky: continuous on the sphere (periodic in u,
    constant along u at the poles), so finite differences see no seam."""
    h, w = 16, 32
    v = np.linspace(0.0, 1.0, h)[:, None]
    u = np.linspace(0.0, 1.0, w, endpoint=False)[None, :]
    uc = 0.5 + 0.5 * np.sin(2.0 * np.pi * u) * np.sin(np.pi * v)
    return np.stack([np.broadcast_to(uc, (h, w)), np.broadcast_to(v, (h, w)),
                     0.5 * np.ones((h, w))], axis=-1).astype(np.float32)


GRAD_CFG = JRenderConfig(
    width=16, height=16, samples=1,
    integrator=JIntegratorConfig(n_steps=400, dt=0.1, dt_boost=8.0,
                                 backend="scan"),
    lam_max=100.0)


def smooth_mask(n=16, hole_px=5.0):
    """test_grad.py's mask: the pixels away from the shadow's edge, where
    the capture boundary is a jump that AD sees as zero and FD does not."""
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    r2 = (yy - n // 2) ** 2 + (xx - n // 2) ** 2
    return (r2 > hole_px ** 2).astype(np.float32)[..., None]


def port_loss(mass, cam_z, tex=None, cfg=GRAD_CFG):
    """test_grad.py's loss_fn through the port; returns (loss, leaves)."""
    scene = convert.scene_from_reference(
        JScene(bh=JBlackHole.make(mass=mass),
               background=smooth_sky() if tex is None else tex), device="cpu")
    cam = convert.camera_from_reference(
        JCamera.make(position=(0.0, 0.0, cam_z), fov=(0.5, 0.5)), device="cpu")
    for t in (scene.bh.mass, cam.position, scene.background):
        t.requires_grad_(True)
    img = render_image(scene, cam, convert.render_config_from_reference(cfg))
    loss = (T(smooth_mask()) * img[..., :3] ** 2).mean()
    return loss, (scene.bh.mass, cam.position, scene.background)


def test_mass_gradient_matches_fd():
    """Twin of test_grad.py::test_mass_gradient_matches_fd."""
    loss, (mass, _, _) = port_loss(0.5, 25.0)
    loss.backward()
    gm = float(mass.grad)
    eps = 1e-2
    with torch.no_grad():
        fd = (float(port_loss(0.5 + eps, 25.0)[0])
              - float(port_loss(0.5 - eps, 25.0)[0])) / (2 * eps)
    assert np.isfinite(gm) and abs(gm) > 1e-6
    np.testing.assert_allclose(gm, fd, rtol=0.1)


def test_camera_gradient_matches_fd():
    """Twin of test_grad.py::test_camera_gradient_matches_fd."""
    loss, (_, pos, _) = port_loss(0.5, 25.0)
    loss.backward()
    gz = float(pos.grad[2])
    eps = 1e-1
    with torch.no_grad():
        fd = (float(port_loss(0.5, 25.0 + eps)[0])
              - float(port_loss(0.5, 25.0 - eps)[0])) / (2 * eps)
    assert np.isfinite(gz) and abs(gz) > 1e-8
    np.testing.assert_allclose(gz, fd, rtol=0.15)


def test_texture_gradient_flows():
    """Twin of test_grad.py::test_texture_gradient_flows."""
    loss, (_, _, tex) = port_loss(0.5, 25.0)
    loss.backward()
    g = tex.grad.numpy()
    assert np.isfinite(g).all()
    assert (np.abs(g) > 0).any()


def flagship_sky(h=256, w=512, check=16):
    """bench.py's procedural equirect sky."""
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * u / w) * np.sin(np.pi * v / h),
        v / h, ((u // check + v // check) % 2)], -1).astype(np.float32)


def render_grads(size, mass=0.5, position=(0.0, 0.0, 25.0),
                 euler=(0.0, 0.0, 0.0), crop=None):
    """Gradients of mean(img[..., :3]^2) (bench.py:385-391) with respect to
    (mass, camera position, sky) for bench.py's flagship scene at
    ``size``^2: (JAX render_image with backend="scan", the port)."""
    sky = flagship_sky()
    cfg = JRenderConfig(
        width=size, height=size, samples=1,
        integrator=JIntegratorConfig(**FLAGSHIP, backend="scan"),
        lam_max=100.0, **(crop or {}))
    cam0 = JCamera.make(position=position, euler=euler, fov=(0.8, 0.8))

    def jloss(m, pos, tex):
        scene = JScene(bh=JBlackHole.make(mass=m), background=tex)
        cam = dataclasses.replace(cam0, position=pos)
        return jnp.mean(jrender(scene, cam, cfg)[..., :3] ** 2)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.float32(mass), jnp.asarray(position, jnp.float32),
        jnp.asarray(sky))
    scene = convert.scene_from_reference(
        JScene(bh=JBlackHole.make(mass=mass), background=sky), device="cpu")
    cam = convert.camera_from_reference(cam0, device="cpu")
    leaves = (scene.bh.mass, cam.position, scene.background)
    for t in leaves:
        t.requires_grad_(True)
    img = render_image(scene, cam, convert.render_config_from_reference(cfg))
    img[..., :3].pow(2).mean().backward()
    return ([np.asarray(g) for g in jg], [t.grad.numpy() for t in leaves])


@pytest.fixture(scope="module")
def flagship_grads():
    return render_grads(32)


@pytest.mark.parametrize("i,what", [(0, "mass"), (1, "camera position"),
                                    (2, "sky")])
def test_flagship_render_gradients_match_jax(flagship_grads, i, what):
    """A 32x32 flagship frame (bench.py's settings) through render_image:
    the gradient with respect to one parameter against jax.grad of the JAX
    render_image.  Held to 1e-3 of the gradient's largest component: each
    float32 framework is itself that far from a float64 JAX render here
    (camera position: JAX 1.5e-3, the port 1.0e-3 of the largest
    component), while the two differ by less (readings: mass 1.2e-4,
    camera position 4.8e-4, sky 4.4e-4)."""
    jg, tg = flagship_grads
    assert np.abs(jg[i]).max() > 0
    close(tg[i], jg[i], 1e-3, what)


@pytest.mark.parametrize("case", ["centre", "pole", "inside-horizon",
                                  "captured"])
def test_gradients_finite_where_the_traps_are(case):
    """Finite gradients where a derivative would be 0 * inf without the
    guards, and equal to JAX's:

    * centre: the 2x2 pixels at the image centre, the radial ray through
      the hole among them (captured; safe_arccos at d_z = -1);
    * pole: the whole frame with the camera turned away from the hole, so
      its centre ray escapes along +z (safe_arccos at 1, safe_arctan2 at
      (0, 0)); the crop to the centre alone leaves a mass gradient of
      3e-7 whose float32 noise is 0.7%;
    * inside-horizon: a camera inside the horizon (null_init's guarded
      sqrt; every ray INSIDE_HORIZON);
    * captured: a 4x4 window inside the shadow (every ray CAPTURED, the
      r^2 floor)."""
    kw = dict(size=8)
    mid = dict(mark_x_min=3, mark_x_max=4, mark_y_min=3, mark_y_max=4)
    if case == "centre":
        kw["crop"] = mid
    elif case == "pole":
        kw["euler"] = (np.pi, 0.0, 0.0)
    elif case == "inside-horizon":
        kw["mass"] = 20.0
    else:
        kw.update(size=64, crop=dict(mark_x_min=30, mark_x_max=33,
                                     mark_y_min=30, mark_y_max=33))
    jg, tg = render_grads(**kw)
    for what, a, b in zip(("mass", "camera position", "sky"), tg, jg):
        assert np.isfinite(a).all(), what
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=1e-3 * max(np.abs(b).max(), 1e-12),
                                   err_msg=what)
