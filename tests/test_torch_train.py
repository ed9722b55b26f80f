"""The port's Trainer over an orbit, and training checkpoints.

``test_trainer_orbit_fit_camera_and_mass`` is tests/test_parallel.py's
BASELINE config 4 fit on the port, with its bars: mass, orbit phase and
roll recovered from three multisampled frames, with mask_critical 0.25
and common random numbers (``fit_frames(..., reuse_keys=True)``: frame f's
draws ``frame_draws(cfg, f)``, the targets rendered with the same).  It
runs the plain gradient loop unsegmented, as tests/test_torch_parallel.py
explains.  The checkpoint tests twin tests/test_io_cli.py's npz round trip
and hold ``io_.save_train_state``/``load_train_state`` to a structure
check and to a resume that continues bit for bit.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import blackhole_geodesic_calculator_tpu_torch as P  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import io_  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import parallel as TP  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.parallel.train import frame_draws  # noqa: E402


def sky():
    h, w = 16, 32
    v = np.linspace(0.0, 1.0, h)[:, None]
    u = np.linspace(0.0, 1.0, w, endpoint=False)[None, :]
    uc = 0.5 + 0.5 * np.sin(2.0 * np.pi * u) * np.sin(np.pi * v)
    return torch.as_tensor(np.stack([
        np.broadcast_to(uc, (h, w)), np.broadcast_to(v, (h, w)),
        0.5 * np.ones((h, w))], -1), dtype=torch.float32)


def scene_of(mass):
    s = P.Scene(bh=P.BlackHole.make(mass=0.0, device="cpu"),
                background=sky())
    return dataclasses.replace(s, bh=dataclasses.replace(s.bh, mass=mass))


def test_trainer_orbit_fit_camera_and_mass():
    cfg = P.RenderConfig(
        width=32, height=24, samples=4, lam_max=60.0,
        integrator=P.IntegratorConfig(n_steps=150, dt=0.15, dt_boost=16.0,
                                      dt_boost_r_ref=1.6, dt_power=1.5,
                                      remat_segment=151))
    r_orbit, phases = 10.0, [0.0, 2.1, 4.2]

    def orbit_cam(phase, dphi, de2):
        ph = torch.as_tensor(phase, dtype=torch.float32) + dphi
        zero = torch.zeros(())
        return dataclasses.replace(
            P.Camera.make(position=(0.0, 0.0, 0.0), fov=(0.8, 0.8),
                          device="cpu"),
            position=torch.stack([r_orbit * torch.sin(ph), zero,
                                  r_orbit * torch.cos(ph)]),
            euler=torch.stack([zero, ph, de2]))

    zero = torch.zeros(())
    targets = [
        TP.render_image_sharded(scene_of(torch.tensor(0.5)),
                                orbit_cam(ph, zero, zero), cfg,
                                draws=frame_draws(cfg, f, "cpu"))[..., :3]
        for f, ph in enumerate(phases)]

    def frame_param_fn(p, phase):
        return scene_of(p["mass"]), orbit_cam(phase, p["dphi"], p["de2"])

    n_epochs = 60
    total = n_epochs * len(phases)

    def cosine(t):   # optax.cosine_decay_schedule(2e-2, total, 0.05) / 2e-2
        return 0.95 * 0.5 * (1.0 + math.cos(math.pi * min(t, total)
                                            / total)) + 0.05

    tr = TP.Trainer(
        cfg=cfg, param_fn=lambda p: (None, None),
        frame_param_fn=frame_param_fn,
        optimizer=lambda ps: torch.optim.Adam(ps, lr=2e-2),
        scheduler=lambda opt: torch.optim.lr_scheduler.LambdaLR(opt, cosine),
        clip_norm=0.5, mask_critical=0.25)
    params, losses = tr.fit_frames(
        {"mass": 0.38, "dphi": 0.07, "de2": -0.06}, targets, phases,
        n_epochs=n_epochs, reuse_keys=True)
    assert min(losses) < losses[0] * 1e-3
    assert abs(float(params["mass"]) - 0.5) < 0.01
    assert abs(float(params["dphi"])) < 0.005
    assert abs(float(params["de2"])) < 0.005


def test_train_state_checkpoint_npz(tmp_path):
    """tests/test_io_cli.py's round trip: params and an Adam state (after
    a step, when torch's state exists) through npz, with a template."""
    params = {"mass": torch.tensor(0.4, requires_grad=True),
              "tex": torch.ones((4, 4, 3), requires_grad=True)}
    opt = torch.optim.Adam(list(params.values()), lr=1e-2)
    for p in params.values():
        p.grad = torch.full_like(p, 0.5)
    opt.step()
    path = str(tmp_path / "ck.npz")
    io_.save_train_state(path, params, opt, 17)
    p2, s2, step = io_.load_train_state(path, like=(params, opt))
    assert step == 17
    assert float(p2["mass"]) == pytest.approx(0.4 - 1e-2)
    for k in params:
        assert torch.equal(p2[k], params[k].detach())
    ref = opt.state_dict()
    assert s2["param_groups"] == ref["param_groups"]
    for i, st in ref["state"].items():
        for k, v in st.items():
            assert torch.equal(s2["state"][i][k], v)


def test_checkpoint_treedef_mismatch(tmp_path):
    params = {"mass": torch.tensor(0.4, requires_grad=True)}
    opt = torch.optim.SGD(list(params.values()), lr=1e-2)
    path = str(tmp_path / "ck.npz")
    io_.save_train_state(path, params, opt, 3)
    other = {"mass": torch.tensor(0.4), "tex": torch.ones(2)}
    with pytest.raises(ValueError, match="treedef mismatch"):
        io_.load_train_state(path, like=(other, opt))
    wide = {"mass": torch.ones(2)}
    with pytest.raises(ValueError, match="treedef mismatch"):
        io_.load_train_state(path, like=(wide, opt))
    with pytest.raises(ValueError, match="template"):
        io_.load_train_state(path)


@pytest.mark.parametrize("suffix", [".pt", ".npz"])
def test_resume_continues_bit_for_bit(tmp_path, suffix):
    """Three Trainer steps, or two, a save and a load into a fresh
    optimizer and schedule, then the third: the same parameter bits."""
    cam = P.Camera.make(position=(0.0, 0.0, 15.0), fov=(0.7, 0.7),
                        device="cpu")
    cfg = P.RenderConfig(width=12, height=10, samples=2, lam_max=60.0,
                         integrator=P.IntegratorConfig(n_steps=48, dt=0.2))
    target = P.render_image(scene_of(torch.tensor(0.5)), cam, cfg)[..., :3]
    tr = TP.Trainer(
        cfg=cfg, param_fn=lambda p: (scene_of(p["mass"]), dataclasses.replace(
            cam, position=p["cam"])),
        optimizer=lambda ps: torch.optim.Adam(ps, lr=1e-2),
        scheduler=lambda opt: torch.optim.lr_scheduler.LambdaLR(
            opt, lambda t: 1.0 / (1.0 + t)), clip_norm=1.0)
    tf, ys, xs = tr.shard_target(target)
    draws = [torch.rand((2, 2, 10, 12), generator=torch.Generator(
        "cpu").manual_seed(i)) for i in range(3)]

    def fresh():
        params = {"mass": torch.tensor(0.4, requires_grad=True),
                  "cam": torch.tensor([0.0, 0.1, 15.0], requires_grad=True)}
        return params, tr.init(params)

    params, state = fresh()
    for i in range(3):
        params, state, _ = tr.step(params, state, tf, ys, xs, draws[i])
    ref = {k: v.detach().clone() for k, v in params.items()}

    params, state = fresh()
    for i in range(2):
        params, state, _ = tr.step(params, state, tf, ys, xs, draws[i])
    path = str(tmp_path / f"ck{suffix}")
    io_.save_train_state(path, params, state, 2)
    # an npz restore takes its structure from a template: a stepped state
    p2, s2, step = io_.load_train_state(path, like=(params, state))
    params = {k: v.clone().requires_grad_(True) for k, v in p2.items()}
    state = tr.init(params)
    state.load_state_dict(s2)
    assert step == 2
    params, state, _ = tr.step(params, state, tf, ys, xs, draws[2])
    for k in ref:
        assert torch.equal(params[k].detach(), ref[k]), k
    assert state.scheduler.last_epoch == 3
