"""PyTorch port against the JAX package: the distributed layer
(``parallel/``) in one process, and training checkpoints (``io_``).

Twins of tests/test_parallel.py and tests/test_multihost.py: the
round-robin deal and its layout inverse against JAX's for 1, 3 and 8
shards, with and without a crop window; the sharded forward, Stokes frame
and polarization map against the unsharded port (bit for bit at one
sample; on the same draws, within 1e-6 at four); one ``Trainer.step``
against the JAX ``Trainer`` on a one-device mesh, at one sample and at
four on JAX's draws through numpy, the parameters after one SGD step, so
the averaged gradients, within 1e-3 of their largest component (the
port's tolerance for render gradients, tests/test_torch_grad.py);
``test_trainer_recovers_mass`` on the port with its bars; and the seven
cases of the multihost helpers.  The two-process paths are in
tests/test_torch_distributed.py, the orbit fit and the checkpoints in
tests/test_torch_train.py.

The fits run the plain gradient loop unsegmented (``remat_segment``
beyond n_steps): values are the same bits
(``test_checkpointing_changes_no_bit``), and torch.utils.checkpoint's
per-tensor hooks took more than half of a CPU step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blackhole_geodesic_calculator_tpu.camera import Camera as JCamera  # noqa: E402
from blackhole_geodesic_calculator_tpu.ops import IntegratorConfig as JIntegratorConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.parallel import Trainer as JTrainer  # noqa: E402
from blackhole_geodesic_calculator_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from blackhole_geodesic_calculator_tpu.parallel import render as JPR  # noqa: E402
from blackhole_geodesic_calculator_tpu.parallel.mesh import put_global  # noqa: E402
from blackhole_geodesic_calculator_tpu.render import RenderConfig as JRenderConfig  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import BlackHole as JBlackHole  # noqa: E402
from blackhole_geodesic_calculator_tpu.scene import Scene as JScene  # noqa: E402
import blackhole_geodesic_calculator_tpu_torch as P  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import convert  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import parallel as TP  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import integrate as tint  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.parallel import render as TPR  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.render import renderer as TR  # noqa: E402


def sky_np():
    h, w = 16, 32
    v = np.linspace(0.0, 1.0, h)[:, None]
    u = np.linspace(0.0, 1.0, w, endpoint=False)[None, :]
    uc = 0.5 + 0.5 * np.sin(2.0 * np.pi * u) * np.sin(np.pi * v)
    return np.stack([np.broadcast_to(uc, (h, w)), np.broadcast_to(v, (h, w)),
                     0.5 * np.ones((h, w))], -1).astype(np.float32)


def sky():
    return torch.as_tensor(sky_np())


CFG = P.RenderConfig(width=24, height=16, samples=1,
                     integrator=P.IntegratorConfig(n_steps=300, dt=0.1),
                     lam_max=60.0)
CROP = dict(mark_x_min=5, mark_x_max=14, mark_y_min=3, mark_y_max=9)


def scene_cam(mass=0.5):
    return (P.Scene(bh=P.BlackHole.make(mass=mass, device="cpu"),
                    background=sky()),
            P.Camera.make(position=(0.0, 0.0, 20.0), fov=(0.6, 0.6),
                          device="cpu"))


def unsegmented(cfg):
    """``cfg`` with the plain gradient loop in one unsegmented piece."""
    return dataclasses.replace(cfg, integrator=dataclasses.replace(
        cfg.integrator, remat_segment=cfg.integrator.n_steps + 1))


# =============================================================================
# The deal and its inverse.
# =============================================================================
@pytest.mark.parametrize("crop", [None, CROP], ids=["frame", "crop"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_deal_and_undeal_match_jax(n_shards, crop):
    cfg = dataclasses.replace(CFG, **(crop or {}))
    jcfg = JRenderConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(JRenderConfig)
                            if f.name != "integrator"})
    got = TPR._flat_pixels(cfg, n_shards)
    ref = JPR._flat_pixels(jcfg, n_shards)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[3] == ref[3]
    total = got[0].numel()
    assert total % n_shards == 0 and total - got[3] < n_shards
    flat = np.random.default_rng(n_shards).random((3, total)).astype(
        np.float32)
    und = TPR._undeal_cm(torch.as_tensor(flat), n_shards, got[3])
    np.testing.assert_array_equal(und.numpy(), np.asarray(
        JPR._undeal_cm(jnp.asarray(flat), n_shards, ref[3])))
    # slot i serves pixel perm[i]: undealt, every pixel finds its own id
    ids = TPR._undeal_cm(got[2][None].float(), n_shards, got[3])
    np.testing.assert_array_equal(ids[0].numpy(), np.arange(got[3]))


# =============================================================================
# Sharded renders against the unsharded port.
# =============================================================================
@pytest.mark.parametrize("crop", [None, CROP], ids=["frame", "crop"])
def test_sharded_matches_unsharded(crop):
    scene, cam = scene_cam()
    cfg = dataclasses.replace(CFG, **(crop or {}))
    mesh = TP.make_mesh()
    assert mesh.shape == {"samples": 1, "rays": 1}
    assert torch.equal(TP.render_image_sharded(scene, cam, cfg, mesh),
                       P.render_image(scene, cam, cfg))


def test_sharded_multisample_matches_unsharded():
    """Four samples on the same draws: render_image's bits (both render
    every sample in one render_samples call), and the same bits twice."""
    scene, cam = scene_cam()
    cfg = dataclasses.replace(CFG, samples=4)
    draws = TR.sample_draws(cfg, "cpu")
    a = TP.render_image_sharded(scene, cam, cfg, draws=draws)
    assert torch.equal(a, TP.render_image_sharded(scene, cam, cfg))
    assert torch.equal(a, P.render_image(scene, cam, cfg, draws))
    with pytest.raises(ValueError, match="samples"):
        TP.render_image_sharded(scene, cam, cfg, TP.make_mesh(
            list(range(6)), sample_parallel=3))


def stokes_scene():
    tex = torch.tensor([1.0, 0.6, 0.2]).expand(8, 32, 3).contiguous()
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, device="cpu"),
                    background=sky(), disk=P.Disk.make(
                        r_in=2.0, r_out=6.0, texture=tex, pol_frac=0.5,
                        device="cpu"))
    cam = P.Camera.make(position=(0.0, 10.0, 17.0), euler=(-0.53, 0.0, 0.0),
                        fov=(0.8, 0.8), device="cpu")
    return scene, cam


@pytest.mark.parametrize("crop", [None, dict(
    mark_x_min=5, mark_x_max=30, mark_y_min=4, mark_y_max=21)],
    ids=["frame", "crop"])
def test_stokes_sharded_matches_unsharded(crop):
    scene, cam = stokes_scene()
    cfg = dataclasses.replace(CFG, width=40, height=32, lam_max=80.0,
                              **(crop or {}))
    got = TP.render_stokes_sharded(scene, cam, cfg)
    ref = P.render_stokes(scene, cam, cfg)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert bool((torch.hypot(ref[1], ref[2]) > 1e-6).any())
    if crop:
        assert got[0].shape == (18, 26, 3)


@pytest.mark.parametrize("spin", [None, 0.3], ids=["schwarzschild", "kerr"])
def test_polarization_map_sharded_matches_unsharded(spin):
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, spin=spin, device="cpu"))
    cam = P.Camera.make(position=(0.0, 0.0, 20.0), fov=(0.7, 0.7),
                        device="cpu")
    cfg = P.RenderConfig(width=8, height=6, lam_max=60.0, r_escape=70.0,
                         integrator=P.IntegratorConfig(
                             n_steps=60 if spin else 200, dt=0.2))
    got = TP.polarization_map_sharded(scene, cam, cfg)
    ref = P.polarization_map(scene, cam, cfg)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
    assert bool(torch.isfinite(ref).any())


# =============================================================================
# Trainer against the JAX Trainer.
# =============================================================================
@pytest.mark.parametrize("samples", [1, 4])
def test_trainer_step_matches_jax(samples):
    """One SGD step (lr 1) to the mass, the camera position and the sky,
    mask_critical 0.25 (bench.py's gradient parity), against the JAX
    Trainer on a one-device mesh; with four samples on JAX's draws (its
    keys' uniform (2, slots) draws), the port's (4, 2, Hc, Wc) from them."""
    jcfg = JRenderConfig(width=24, height=16, samples=samples,
                         integrator=JIntegratorConfig(n_steps=300, dt=0.1),
                         lam_max=60.0)
    cfg = convert.render_config_from_reference(jcfg)
    jscene = JScene(bh=JBlackHole.make(mass=0.5), background=sky_np())
    jcam = JCamera.make(position=(0.0, 0.0, 20.0), fov=(0.6, 0.6))
    scene = convert.scene_from_reference(jscene, device="cpu")
    cam = convert.camera_from_reference(jcam, device="cpu")
    target = P.render_image(scene, cam, cfg)[..., :3]

    def jparam_fn(p):
        return (dataclasses.replace(jscene, bh=dataclasses.replace(
            jscene.bh, mass=p["mass"]), background=p["background"]),
            dataclasses.replace(jcam, position=p["cam_pos"]))

    def param_fn(p):
        return (dataclasses.replace(scene, bh=dataclasses.replace(
            scene.bh, mass=p["mass"]), background=p["background"]),
            dataclasses.replace(cam, position=p["cam_pos"]))

    mesh = jmake_mesh([jax.devices()[0]])
    jtr = JTrainer(cfg=jcfg, param_fn=jparam_fn, optimizer=optax.sgd(1.0),
                   mesh=mesh, mask_critical=0.25)
    tf, ys, xs = jtr.shard_target(jnp.asarray(target.numpy()))
    p0 = {"mass": np.float32(0.45), "cam_pos": np.float32([0.0, 0.0, 20.0]),
          "background": sky_np()}
    jp = put_global({k: jnp.asarray(v) for k, v in p0.items()}, jtr._repl)
    keys = jax.random.split(jax.random.PRNGKey(3), max(samples, 1))
    jp1, _, jloss = jtr.step(jp, jtr.init(jp), tf, ys, xs, put_global(
        keys if samples > 1 else jnp.zeros((1, 2), jnp.uint32),
        NamedSharding(mesh, PartitionSpec("samples"))))
    draws = None
    if samples > 1:
        draws = torch.as_tensor(np.stack([
            np.asarray(jax.random.uniform(k, (2, ys.shape[0]))).reshape(
                2, 16, 24) for k in keys]))

    tr = TP.Trainer(cfg=unsegmented(cfg), param_fn=param_fn,
                    optimizer=lambda ps: torch.optim.SGD(ps, lr=1.0),
                    mask_critical=0.25)
    ttf, tys, txs = tr.shard_target(target)
    np.testing.assert_array_equal(ttf.numpy(), np.asarray(tf))
    params = {k: torch.as_tensor(v).clone().requires_grad_(True)
              for k, v in p0.items()}
    params, _, loss = tr.step(params, tr.init(params), ttf, tys, txs, draws)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    for k in p0:
        g = p0[k] - params[k].detach().numpy()
        jg = p0[k] - np.asarray(jp1[k])
        assert np.abs(jg).max() > 0, k
        err = np.abs(g - jg).max() / np.abs(jg).max()
        assert err < 1e-3, f"{k}: {err:.3e}"


def test_trainer_recovers_mass():
    """tests/test_parallel.py's fit on the port: a 16x12 target at mass
    0.5, 8 samples, Adam 2e-2 with clipping at 1, from 0.35."""
    cfg = unsegmented(dataclasses.replace(CFG, width=16, height=12,
                                          samples=8))
    scene, cam = scene_cam(mass=0.5)
    target = P.render_image(scene, cam, cfg)[..., :3]

    def param_fn(p):
        s = P.Scene(bh=P.BlackHole.make(mass=0.0, device="cpu"),
                    background=sky())
        return dataclasses.replace(s, bh=dataclasses.replace(
            s.bh, mass=p["mass"])), cam

    tr = TP.Trainer(cfg=cfg, param_fn=param_fn,
                    optimizer=lambda ps: torch.optim.Adam(ps, lr=2e-2),
                    clip_norm=1.0, mesh=TP.make_mesh())
    params, losses = tr.fit({"mass": 0.35}, target, n_steps=60)
    assert min(losses) < losses[0] * 0.5
    assert abs(float(params["mass"]) - 0.5) < 0.05


def test_checkpointing_changes_no_bit():
    """The plain gradient loop checkpointed in sqrt(n) segments and in one
    unsegmented piece: the same forward and the same gradient bits."""
    scene, cam = scene_cam()
    out = []
    for cfg in (CFG, unsegmented(CFG)):
        m = torch.tensor(0.45, requires_grad=True)
        s = dataclasses.replace(scene, bh=dataclasses.replace(scene.bh,
                                                              mass=m))
        img = P.render_image(s, cam, cfg)
        img[..., :3].pow(2).mean().backward()
        out.append((img.detach(), m.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_trainer_refuses_indivisible_samples():
    with pytest.raises(ValueError, match="samples"):
        TP.Trainer(cfg=dataclasses.replace(CFG, samples=3),
                   param_fn=lambda p: scene_cam(), optimizer=None,
                   mesh=TP.make_mesh([0, 1], sample_parallel=2))


# =============================================================================
# Multihost helpers (one process).
# =============================================================================
def tiny():
    v, u = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    tex = torch.as_tensor(np.stack([u / 16.0, v / 8.0, np.ones_like(
        u, float)], -1), dtype=torch.float32)
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, device="cpu"),
                    background=tex)
    cam = P.Camera.make(position=(0.0, 0.0, 15.0), fov=(0.7, 0.7),
                        device="cpu")
    cfg = P.RenderConfig(width=16, height=16, lam_max=60.0,
                         integrator=P.IntegratorConfig(n_steps=48, dt=0.2))
    return scene, cam, cfg


def test_init_distributed_single_host_noop():
    assert TP.init_distributed(num_processes=1) is False
    assert TP.init_distributed() is False


def test_global_mesh_covers_all_devices():
    mesh = TP.global_mesh()
    assert mesh.size == 1 and mesh.shape == {"samples": 1, "rays": 1}
    assert mesh.coords() == (0, 0)
    assert TP.make_mesh([0, 1, 2, 3], sample_parallel=2).shape == {
        "samples": 2, "rays": 2}
    with pytest.raises(ValueError):
        TP.global_mesh(sample_parallel=2)


def test_gather_image_single_process_identity():
    img = np.random.default_rng(42).random((8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(TP.gather_image(img), img)
    np.testing.assert_array_equal(TP.gather_image(torch.as_tensor(img)), img)


def test_render_shards_with_retry_deterministic():
    """A shard that fails once renders again bit for bit."""
    scene, cam, cfg = tiny()
    h, w, n_shards = cfg.height, cfg.width, 4
    rows = h // n_shards
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    armed = {"on": True}

    def shard(i):
        if i == 2 and armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected preemption")
        sl = slice(i * rows, (i + 1) * rows)
        return TR.render_rays(scene, cam, cfg, ys[sl].reshape(-1),
                              xs[sl].reshape(-1)).reshape(rows, w, 3)

    events = []
    parts = TP.render_shards_with_retry(shard, n_shards, backoff_s=0.0,
                                        on_event=events.append)
    assert len(events) == 1 and "shard 2" in events[0]
    ref = TR.render_rays(scene, cam, cfg, ys.reshape(-1), xs.reshape(-1))
    np.testing.assert_array_equal(np.concatenate(parts),
                                  ref.reshape(h, w, 3).numpy())


def test_render_shards_with_retry_gives_up():
    def shard(i):
        raise RuntimeError("permanent fault")

    with pytest.raises(RuntimeError, match="permanent fault"):
        TP.render_shards_with_retry(shard, 1, max_retries=1, backoff_s=0.0)


def test_render_with_failover_reconfigures_mesh(monkeypatch):
    """An 8-rank mesh that keeps failing, with only this rank alive, drops
    to 1 x 1 and renders the healthy frame bit for bit."""
    scene, cam, cfg = tiny()
    healthy = TP.render_image_sharded(scene, cam, cfg)
    real = TPR.render_image_sharded

    def flaky(scene, cam, cfg, mesh=None, draws=None):
        if mesh is not None and mesh.size == 8:
            raise RuntimeError("injected: rank 7 lost")
        return real(scene, cam, cfg, mesh=mesh, draws=draws)

    monkeypatch.setattr(TPR, "render_image_sharded", flaky)
    events = []
    img = TP.render_with_failover(
        scene, cam, cfg, mesh=TP.make_mesh(list(range(8))), backoff_s=0.0,
        on_event=events.append, probe=lambda: [0])
    assert any("reconfigured: 8 -> 1" in e for e in events), events
    assert torch.equal(img, healthy)


def test_render_with_failover_gives_up(monkeypatch):
    scene, cam, cfg = tiny()

    def dead(*a, **k):
        raise RuntimeError("backend gone")

    monkeypatch.setattr(TPR, "render_image_sharded", dead)
    with pytest.raises(RuntimeError, match="backend gone"):
        TP.render_with_failover(scene, cam, cfg, max_retries=1,
                                backoff_s=0.0, probe=lambda: [0])


def test_mesh_of_several_ranks_needs_the_group():
    scene, cam, cfg = tiny()
    with pytest.raises(RuntimeError, match="torch.distributed"):
        TP.render_image_sharded(scene, cam, cfg, TP.make_mesh([0, 1]))


def test_integrate_fixed_skips_frozen_steps(monkeypatch):
    """Once no ray is ACTIVE the plain gradient loop stops stepping (the
    steps left are identities): a 300-step budget whose rays all end
    early runs fewer steps, with the state of all 300."""
    scene, cam = scene_cam()
    calls = []
    real = tint._fixed_step

    def counting(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(tint, "_fixed_step", counting)
    m = torch.tensor(0.5, requires_grad=True)
    s = dataclasses.replace(scene, bh=dataclasses.replace(scene.bh, mass=m))
    img = P.render_image(s, cam, unsegmented(CFG))
    monkeypatch.setattr(tint, "_fixed_step", real)
    assert 0 < len(calls) < CFG.integrator.n_steps
    with torch.no_grad():
        assert torch.equal(img, P.render_image(scene, cam, CFG))
