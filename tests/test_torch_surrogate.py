"""PyTorch port against the JAX package: the learned surrogate
(``models/surrogate.py``).

Twins of tests/test_surrogate.py at its sizes -- equivariance (rotation,
reflection, the canonical frame, bf16), the sampler and the labels
(Schwarzschild and Kerr), a Schwarzschild training smoke run with the same
bars, persistence, ``render_limited`` with a ``NeuralSurrogate`` (a
briefly trained Kerr one too), and the f32 and bf16 paths -- but the
compat test (``compat.py`` is not ported).  torch's generator cannot
reproduce ``jax.random``, so the parity tests take JAX-made parameters
and entries through numpy: ``_features``, ``mlp_apply``, ``trace`` and
``surrogate_loss`` (its value and gradient) within 1e-5 in f32 (exit
points, of size ~22, within 1e-5 of their size); bf16 by the JAX test's
bars; ``label_rays`` on the plain path against JAX's scan backend
(captured and escaped equal, exit points within 1e-3, directions of the
escaped rays outside the photon band within 1e-4); the learning-rate
schedule against optax's at every step and AdamW updates against
optax.adamw within 1e-6.  npz files cross between the packages both ways.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu.models import surrogate as JS  # noqa: E402
import blackhole_geodesic_calculator_tpu_torch as P  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import convert  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.models import surrogate as TS  # noqa: E402

TOL = 1e-5


def gen(seed):
    g = torch.Generator("cpu")
    g.manual_seed(seed)
    return g


def random_surrogate(seed, cfg, mass=0.5, spin=0.45, precision="f32"):
    return TS.NeuralSurrogate(TS.init_params(gen(seed), cfg), mass=mass,
                              spin=spin, r_influence=cfg.r_influence,
                              precision=precision)


def entries(seed, n, R):
    """n entries on the sphere of radius R, directions pointing inward."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, 3)).astype(np.float32)
    e = R * e / np.linalg.norm(e, axis=-1, keepdims=True)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    s = np.sign(np.sum(d * -e, axis=-1, keepdims=True))
    return (torch.as_tensor(e),
            torch.as_tensor((d * np.where(s == 0, 1.0, s)).astype(
                np.float32)))


def jax_pair(seed, cfg, spin=0.45):
    """A JAX NeuralSurrogate from PRNGKey(seed) and its port twin."""
    js = JS.NeuralSurrogate(
        params=JS.init_params(jax.random.PRNGKey(seed), cfg),
        mass=jnp.asarray(0.5, jnp.float32),
        spin=jnp.asarray(spin, jnp.float32),
        r_influence=jnp.asarray(cfg.r_influence, jnp.float32),
        precision=cfg.precision)
    return js, convert.surrogate_from_reference(js, device="cpu")


def jax_entries(seed, n, cfg):
    e, d = JS.sample_entries(jax.random.PRNGKey(seed), n, cfg, 0.5)
    return e, d, torch.as_tensor(np.array(e)), torch.as_tensor(np.array(d))


def port_cfg(jcfg):
    """The JAX config's twin: its backend 'scan' is the plain loop."""
    fields = dataclasses.asdict(jcfg)
    fields["backend"] = {"scan": "torch", "pallas": "cuda"}.get(
        fields["backend"], fields["backend"])
    return TS.SurrogateConfig(**fields)


def rz(phi):
    return TS._rz(torch.tensor(phi)).numpy()


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# =============================================================================
# Equivariance.
# =============================================================================
def test_rotation_equivariance():
    cfg = TS.SurrogateConfig(width=32, depth=2)
    sur = random_surrogate(0, cfg)
    e, d = entries(1, 64, cfg.r_influence)
    rot = torch.as_tensor(rz(1.234))
    loc0, dir0, cap0 = sur.trace(e, d)
    loc1, dir1, cap1 = sur.trace(e @ rot.T, d @ rot.T)
    np.testing.assert_allclose(loc1.numpy(), (loc0 @ rot.T).numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(dir1.numpy(), (dir0 @ rot.T).numpy(),
                               atol=2e-4)
    assert torch.equal(cap0, cap1)


def test_reflection_equivariance():
    cfg = TS.SurrogateConfig(width=32, depth=2)
    sur = random_surrogate(0, cfg)
    e, d = entries(2, 64, cfg.r_influence)
    flip = torch.diag(torch.tensor([1.0, 1.0, -1.0]))
    loc0, dir0, cap0 = sur.trace(e, d)
    loc1, dir1, cap1 = sur.trace(e @ flip, d @ flip)
    np.testing.assert_allclose(loc1.numpy(), (loc0 @ flip).numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(dir1.numpy(), (dir0 @ flip).numpy(),
                               atol=2e-4)
    assert torch.equal(cap0, cap1)


def test_canonical_frame():
    e, d = entries(3, 128, 20.0)
    ec, dc, phi, flip = TS.canonicalize(e, d)
    np.testing.assert_allclose(ec[:, 1].numpy(), 0.0, atol=1e-4)
    assert bool((ec[:, 2] >= -1e-5).all())
    np.testing.assert_allclose(torch.linalg.norm(dc, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    back = TS.decanonicalize(dc, phi, flip)
    np.testing.assert_allclose(back.numpy(), d.numpy(), atol=1e-6)


def test_equivariance_holds_in_bf16():
    cfg = TS.SurrogateConfig(width=32, depth=2)
    sur = random_surrogate(5, cfg, precision="bf16")
    e, d = entries(6, 64, cfg.r_influence)
    rot = torch.as_tensor(rz(1.234))
    lo, _, cap = sur.trace(e, d)
    lo2, _, cap2 = sur.trace(e @ rot.T, d @ rot.T)
    np.testing.assert_allclose(lo2.numpy(), (lo @ rot.T).numpy(), atol=2e-3)
    assert torch.equal(cap, cap2)


# =============================================================================
# Sampler and labels.
# =============================================================================
def test_entries_on_sphere_inward():
    cfg = TS.SurrogateConfig(r_influence=15.0)
    e, d = TS.sample_entries(gen(0), 512, cfg, 0.5)
    np.testing.assert_allclose(torch.linalg.norm(e, dim=-1).numpy(), 15.0,
                               rtol=1e-5)
    np.testing.assert_allclose(torch.linalg.norm(d, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    assert bool((torch.sum(d * -e, dim=-1) >= -1e-3).all())


def test_labels_cover_both_classes():
    cfg = TS.SurrogateConfig(r_influence=10.0, n_steps=256, dt=0.1,
                             lam_max=80.0, backend="torch")
    env = TS._label_env(0.5, None, cfg, "cpu")
    e, d = TS.sample_entries(gen(1), 512, cfg, 0.5)
    captured, _, _, escaped = TS.label_rays(env, cfg, e, d)
    assert 0.1 < float(captured.float().mean()) < 0.6
    assert float(escaped.float().mean()) > 0.3


def test_kerr_labeling_path():
    cfg = TS.SurrogateConfig(r_influence=10.0, n_steps=256, dt=0.1,
                             lam_max=80.0, backend="torch")
    env = TS._label_env(0.5, 0.45, cfg, "cpu")
    assert env.spin is not None
    e, d = TS.sample_entries(gen(4), 256, cfg, 0.5)
    captured, exit_loc, exit_dir, escaped = TS.label_rays(env, cfg, e, d)
    assert bool(captured.any()) and bool(escaped.any())
    assert bool((torch.linalg.norm(exit_loc, dim=-1)[escaped]
                 > 10.0 * 0.99).all())
    np.testing.assert_allclose(
        torch.linalg.norm(exit_dir[escaped], dim=-1).numpy(), 1.0, atol=1e-4)


def photon_band(m, a):
    """Impact parameters of the photon orbits: [b_c - 0.3 m, b_c + 0.3 m]
    for Schwarzschild; for Kerr from the prograde to the retrograde
    equatorial orbit's (Bardeen's xi), each widened by 0.3 m."""
    if not a:
        b_c = 3.0 * math.sqrt(3.0) * m
        return b_c - 0.3 * m, b_c + 0.3 * m

    def xi(r):
        return abs((r ** 3 - 3 * m * r * r + a * a * r + a * a * m)
                   / (abs(a) * (r - m)))

    r_pro = 2 * m * (1 + math.cos(2 / 3 * math.acos(-abs(a) / m)))
    r_ret = 2 * m * (1 + math.cos(2 / 3 * math.acos(abs(a) / m)))
    return xi(r_pro) - 0.3 * m, xi(r_ret) + 0.3 * m


@pytest.mark.parametrize("spin", [None, 0.45], ids=["schwarzschild", "kerr"])
def test_label_rays_match_jax(spin):
    """The labels on the plain path against JAX's scan backend on JAX's
    entries: captured and escaped equal, exit points within 1e-3, the exit
    directions of the escaped rays outside the photon band within 1e-4."""
    jcfg = JS.SurrogateConfig(r_influence=10.0, n_steps=256, dt=0.1,
                              lam_max=80.0, backend="scan")
    cfg = port_cfg(jcfg)
    je, jd, e, d = jax_entries(4, 512, jcfg)
    jl = [np.asarray(v) for v in JS.label_rays(
        JS._label_env(0.5, spin, jcfg), jcfg, je, jd)]
    tl = [v.numpy() for v in TS.label_rays(
        TS._label_env(0.5, spin, cfg, "cpu"), cfg, e, d)]
    np.testing.assert_array_equal(tl[0], jl[0])
    np.testing.assert_array_equal(tl[3], jl[3])
    assert jl[0].any() and jl[3].any()
    np.testing.assert_allclose(tl[1], jl[1], atol=1e-3)
    b = np.linalg.norm(np.cross(np.asarray(je), np.asarray(jd)), axis=-1)
    lo, hi = photon_band(0.5, spin or 0.0)
    held = jl[3] & ((b < lo) | (b > hi))
    assert held.sum() > 100
    np.testing.assert_allclose(tl[2][held], jl[2][held], atol=1e-4)


# =============================================================================
# Parity of the network, the trace and the loss.
# =============================================================================
def test_features_match_jax():
    cfg = JS.SurrogateConfig()
    je, jd, e, d = jax_entries(2, 1024, cfg)
    jec, jdc, jphi, jflip = JS.canonicalize(je, jd)
    ec, dc, phi, flip = TS.canonicalize(e, d)
    np.testing.assert_allclose(ec.numpy(), np.asarray(jec), atol=TOL * 20)
    np.testing.assert_allclose(dc.numpy(), np.asarray(jdc), atol=TOL)
    np.testing.assert_array_equal(flip.numpy(), np.asarray(jflip))
    np.testing.assert_allclose(
        TS._features(ec, dc, 20.0).numpy(),
        np.asarray(JS._features(jec, jdc, 20.0)), atol=TOL)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_mlp_apply_matches_jax(precision):
    """f32 within 1e-5 of the largest output; bf16 by the JAX test's bars
    (within 0.1, and away from f32's bits)."""
    cfg = JS.SurrogateConfig(width=64, depth=3)
    params = JS.init_params(jax.random.PRNGKey(7), cfg)
    tparams = [(torch.as_tensor(np.array(w)), torch.as_tensor(np.array(b)))
               for w, b in params]
    feats = np.random.default_rng(0).standard_normal((512, 11)).astype(
        np.float32)
    out = TS.mlp_apply(tparams, torch.as_tensor(feats), precision).numpy()
    ref = np.asarray(JS.mlp_apply(params, jnp.asarray(feats), precision))
    if precision == "f32":
        assert max_rel(out, ref) < TOL
    else:
        assert np.abs(out - ref).max() < 0.1
        f32 = TS.mlp_apply(tparams, torch.as_tensor(feats), "f32").numpy()
        assert np.abs(out - f32).max() > 0.0


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_trace_matches_jax(precision):
    """trace of JAX-made parameters on JAX's entries: f32 directions within
    1e-5, exit points within 1e-5 of their size, captures equal; bf16 by
    the JAX test's bars."""
    cfg = JS.SurrogateConfig(width=32, depth=2, precision=precision)
    js, ts = jax_pair(3, cfg)
    assert ts.precision == precision
    je, jd, e, d = jax_entries(4, 1024, cfg)
    jloc, jdir, jcap = (np.asarray(v) for v in js.trace(je, jd))
    loc, dir_, cap = (v.numpy() for v in ts.trace(e, d))
    if precision == "f32":
        assert max_rel(loc, jloc) < TOL
        np.testing.assert_allclose(dir_, jdir, atol=TOL)
        np.testing.assert_array_equal(cap, jcap)
    else:
        assert np.abs(dir_ - jdir).max() < 0.1
        assert (cap == jcap).mean() > 0.95


def test_surrogate_loss_matches_jax():
    """The loss and its three terms, and its gradient to every weight,
    within 1e-5 (relative to the largest), on JAX-made parameters and
    entries and labels of both classes."""
    jcfg = JS.SurrogateConfig(width=32, depth=2)
    params = JS.init_params(jax.random.PRNGKey(11), jcfg)
    je, jd, e, d = jax_entries(12, 512, jcfg)
    rng = np.random.default_rng(5)
    captured = rng.random(512) < 0.3
    escaped = ~captured & (rng.random(512) < 0.9)
    loc = rng.standard_normal((512, 3)).astype(np.float32) * 21.0
    dr = rng.standard_normal((512, 3)).astype(np.float32)
    dr /= np.linalg.norm(dr, axis=-1, keepdims=True)
    R = 20.0
    jlab = (jnp.asarray(captured), jnp.asarray(loc), jnp.asarray(dr),
            jnp.asarray(escaped))
    (jl, jaux), jg = jax.value_and_grad(JS.surrogate_loss, has_aux=True)(
        params, jcfg, jnp.asarray(R, jnp.float32), je, jd, *jlab)
    tparams = [(torch.as_tensor(np.array(w)).requires_grad_(True),
                torch.as_tensor(np.array(b)).requires_grad_(True))
               for w, b in params]
    tl, taux = TS.surrogate_loss(
        tparams, TS.SurrogateConfig(width=32, depth=2), torch.tensor(R),
        e, d, torch.as_tensor(captured), torch.as_tensor(loc),
        torch.as_tensor(dr), torch.as_tensor(escaped))
    tl.backward()
    for a, b in zip((tl, *taux), (jl, *jaux)):
        assert max_rel(float(a.detach()), float(b)) < TOL
    for (tw, tb), (gw, gb) in zip(tparams, jg):
        assert max_rel(tw.grad.numpy(), np.asarray(gw)) < TOL
        assert max_rel(tb.grad.numpy(), np.asarray(gb)) < TOL


# =============================================================================
# Optimizer and schedule.
# =============================================================================
@pytest.mark.parametrize("steps,lr", [(200, 3e-3), (2000, 1e-3)])
def test_schedule_matches_optax(steps, lr):
    """The rate each update of train_surrogate's optimizer runs at, against
    optax.warmup_cosine_decay_schedule at the update's count (the first
    update at count 0: lr = 0), at every step and past the end."""
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, max(steps // 20, 1), steps, lr * 1e-2)
    p = torch.zeros(3, requires_grad=True)
    opt, lr_sched = TS._optimizer([p], lr, steps)
    for t in range(steps + 5):
        got = opt.param_groups[0]["lr"]
        assert abs(got - float(sched(t))) <= 1e-6 * lr, t
        p.grad = torch.zeros(3)
        opt.step()
        lr_sched.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(lr * 1e-2)


def test_adamw_update_matches_optax():
    """Three AdamW updates (weight decay 1e-5) on the same gradients as
    optax.adamw: the parameters within 1e-6."""
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((11, 16)).astype(np.float32)
    grads = [rng.standard_normal((11, 16)).astype(np.float32)
             for _ in range(3)]
    opt = optax.adamw(3e-3, weight_decay=1e-5)
    jw = jnp.asarray(w0)
    state = opt.init(jw)
    w = torch.as_tensor(w0.copy()).requires_grad_(True)
    topt = torch.optim.AdamW([w], lr=3e-3, weight_decay=1e-5)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        w.grad = torch.as_tensor(g)
        topt.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw),
                                   atol=1e-6)


# =============================================================================
# Training.
# =============================================================================
def test_train_schwarzschild_smoke():
    """The JAX test's run on the plain path: the loss falls below 0.6 of
    its first reading, held-out capture accuracy > 0.9 and median direction
    error < 0.5 rad."""
    cfg = TS.SurrogateConfig(width=64, depth=3, r_influence=10.0,
                             n_steps=200, dt=0.1, lam_max=80.0,
                             backend="torch")
    sur, hist = TS.train_surrogate(gen(0), mass=0.5, spin=None, cfg=cfg,
                                   steps=200, batch=512, lr=3e-3,
                                   log_every=40)
    assert hist["loss"][-1] < 0.6 * hist["loss"][0]
    m = TS.evaluate_surrogate(gen(7), sur, cfg, n=2048)
    assert m["capture_acc"] > 0.9
    assert m["dir_err_median_rad"] < 0.5
    assert sur.precision == "f32" and float(sur.spin) == 0.0


# =============================================================================
# Persistence.
# =============================================================================
def test_save_load_roundtrip(tmp_path):
    cfg = TS.SurrogateConfig(width=32, depth=2)
    sur = random_surrogate(5, cfg, spin=0.3)
    path = tmp_path / "sur.npz"
    TS.save_surrogate(path, sur)
    sur2 = TS.load_surrogate(path, device="cpu")
    e, d = entries(6, 32, cfg.r_influence)
    for a, b in zip(sur.trace(e, d), sur2.trace(e, d)):
        assert torch.equal(a, b)
    assert float(sur2.spin) == pytest.approx(0.3)
    assert float(sur2.r_exit) == pytest.approx(22.0)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_npz_crosses_between_packages(tmp_path, precision):
    """A file saved by the JAX package loads in the port and one saved by
    the port loads in JAX, precision kept; the traces agree within 1e-5
    (f32; bf16 by the JAX test's bars)."""
    cfg = JS.SurrogateConfig(width=32, depth=2, precision=precision)
    js, _ = jax_pair(9, cfg, spin=0.3)
    je, jd, e, d = jax_entries(10, 256, cfg)
    JS.save_surrogate(tmp_path / "jax.npz", js)
    ts = TS.load_surrogate(tmp_path / "jax.npz", device="cpu")
    assert ts.precision == precision
    TS.save_surrogate(tmp_path / "port.npz", ts)
    js2 = JS.load_surrogate(tmp_path / "port.npz")
    assert js2.precision == precision
    ref = [np.asarray(v) for v in js.trace(je, jd)]
    for got in ([v.numpy() for v in ts.trace(e, d)],
                [np.asarray(v) for v in js2.trace(je, jd)]):
        if precision == "f32":
            assert max_rel(got[0], ref[0]) < TOL
            np.testing.assert_allclose(got[1], ref[1], atol=TOL)
            np.testing.assert_array_equal(got[2], ref[2])
        else:
            assert np.abs(got[1] - ref[1]).max() < 0.1
            assert (got[2] == ref[2]).mean() > 0.95


def test_load_refuses_old_features_and_defaults_old_files(tmp_path):
    """A file of another feature count raises with the retrain message; a
    file without precision and r_exit loads as bf16 exiting at 1.1 R."""
    cfg = TS.SurrogateConfig(width=8, depth=1)
    sur = random_surrogate(0, cfg)
    flat = {"mass": np.float32(0.5), "spin": np.float32(0.0),
            "r_influence": np.float32(20.0), "depth": np.asarray(1)}
    for i, (w, b) in enumerate(sur.params):
        flat[f"w{i}"], flat[f"b{i}"] = w.numpy(), b.numpy()
    np.savez(tmp_path / "old.npz", **flat)
    old = TS.load_surrogate(tmp_path / "old.npz", device="cpu")
    assert old.precision == "bf16"
    assert float(old.r_exit) == pytest.approx(22.0)
    flat["w0"] = flat["w0"][:9]
    np.savez(tmp_path / "nine.npz", **flat)
    with pytest.raises(ValueError, match="9 input features"):
        TS.load_surrogate(tmp_path / "nine.npz", device="cpu")


# =============================================================================
# The Gen-1 hybrid with a learned surrogate.
# =============================================================================
def hybrid(spin, size):
    sky = torch.ones((8, 16, 3)) * 0.5
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, spin=spin, device="cpu"),
                    background=sky)
    cam = P.Camera.make(position=(0.0, 0.0, 40.0), fov=(0.6, 0.6),
                        device="cpu")
    return scene, cam, P.RenderConfig(width=size, height=size)


def test_limited_render_accepts_neural_surrogate():
    cfg = TS.SurrogateConfig(width=32, depth=2, r_influence=10.0)
    sur = random_surrogate(8, cfg, spin=0.0)
    scene, cam, rcfg = hybrid(None, 24)
    img = P.render_limited(scene, cam, rcfg, P.LimitedConfig(
        approx=True, r_influence=cfg.r_influence), table=sur)
    assert img.shape == (24, 24, 4)
    assert bool(torch.isfinite(img).all())


def test_kerr_approx_requires_learned_surrogate():
    scene, cam, rcfg = hybrid(0.3, 8)
    with pytest.raises(ValueError, match="learned surrogate"):
        P.render_limited(scene, cam, rcfg, P.LimitedConfig(approx=True))


def test_kerr_limited_render_with_trained_surrogate():
    """A Kerr hybrid frame through a briefly trained NeuralSurrogate."""
    cfg = TS.SurrogateConfig(width=32, depth=2, r_influence=10.0,
                             n_steps=160, dt=0.12, lam_max=80.0,
                             backend="torch")
    sur, _ = TS.train_surrogate(gen(0), mass=0.5, spin=0.45, cfg=cfg,
                                steps=60, batch=256)
    scene, cam, rcfg = hybrid(0.45, 16)
    img = P.render_limited(scene, cam, rcfg, P.LimitedConfig(
        approx=True, r_influence=10.0), table=sur)
    assert img.shape == (16, 16, 4)
    assert bool(torch.isfinite(img).all())


def test_trace_refuses_rays_on_another_device():
    cfg = TS.SurrogateConfig(width=8, depth=1)
    sur = random_surrogate(0, cfg)
    e, d = entries(0, 4, 20.0)
    with pytest.raises(ValueError, match="surrogate on"):
        sur.trace(e.to("meta"), d.to("meta"))


# =============================================================================
# Precision.
# =============================================================================
def test_f32_vs_bf16_paths_close_not_identical():
    cfg = TS.SurrogateConfig(width=32, depth=2)
    sur = random_surrogate(3, cfg)
    e, d = entries(4, 256, cfg.r_influence)
    lo_f, do_f, cap_f = sur.trace(e, d)
    sur.precision = "bf16"
    lo_b, do_b, cap_b = sur.trace(e, d)
    assert float((do_f - do_b).abs().max()) < 0.1
    assert float((lo_f - lo_b).abs().max()) > 0.0
    assert float((cap_f == cap_b).float().mean()) > 0.95
    with pytest.raises(ValueError, match="precision"):
        TS.mlp_apply(sur.params, torch.zeros(1, 11), "fp16")
