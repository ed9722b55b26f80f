"""The work counts of the rooflines: the operations per ray-step and per
trip, counted on the frozen reference's own statements, repeat exactly."""

import pytest
import torch

from gpubench.reference import integrate as I
from gpubench.work import _common as C
from gpubench.work import rk4_bwd

RK4 = I.Integrator(n_steps=100, dt=0.12, dt_boost=64.0, dt_boost_r_ref=1.7,
                   dt_power=1.5)
DOPRI = I.Integrator(n_steps=60, dt=4.0, method="dopri", max_step=4.0)
# (disk, spheres, integrator) -> (operations a step or trip, sphere
# quadratics, guard, backward of the step or trip).  The forward RK4
# counts are chip_smoke.py's (276 sky, 437 events); see PERF.md for the
# trips' and the adjoints'.
CASES = {
    "sky": (False, 0, RK4, (276, 0, 0, 553)),
    "events": (True, 4, RK4, (437, 126, 21, 831)),
    "fan": (False, 0, DOPRI, (818, 0, 0, 856)),
    "ring": (False, 1, DOPRI, (871, 48, 15, 947)),
}


def _launch(disk, k, cfg, n=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    ang = torch.tensor([0.3, 1.9, 3.6, 5.2])[:k]
    spheres = None
    if k:
        spheres = (torch.stack([7 * torch.cos(ang), 7 * torch.sin(ang),
                                0.8 * torch.sin(2 * ang)], -1),
                   torch.tensor([0.6, 0.5, 0.7, 0.4])[:k])
    env = I.Env(mass=torch.tensor(0.5), r_capture=torch.tensor(1.0),
                r_escape=torch.tensor(70.0), lam_max=torch.tensor(100.0),
                disk=(torch.tensor(2.0), torch.tensor(6.0)) if disk else None,
                spheres=spheres)
    d = torch.nn.functional.normalize(
        0.1 * torch.randn(n, 3, generator=g) + torch.tensor([0, 0, -1.0]),
        dim=-1)
    o = torch.tensor([0.0, 0.0, 25.0]).expand(n, 3).clone()
    return env, cfg, I.start(env, o, d)


@pytest.mark.parametrize("case", sorted(CASES))
def test_operations_per_step_repeat_exactly(case):
    disk, k, cfg, want = CASES[case]
    reps = [C.replay([_launch(disk, k, cfg, seed=s)]) for s in (0, 1)]
    for rep in reps:
        assert (rep.step_ops, rep.quad_ops, rep.guard_ops,
                rep.adj_ops) == want
    again = C.replay([_launch(disk, k, cfg, seed=0)])
    assert (again.steps, again.guard) == (reps[0].steps, reps[0].guard)


def test_work_of_each_kernel():
    env, cfg, s = _launch(True, 4, RK4)
    rep = C.replay([(env, cfg, s), (env, cfg, s)])
    assert rep.rays == 256 and rep.steps > 256
    assert C.forward_ops(rep) == rep.steps * (437 - 126 + 21) + (
        rep.guard * 126)
    ops, nbytes = rk4_bwd.work(rep)
    assert ops == rep.steps * (437 + 831)
    assert C.segment(100) == 16     # 7 checkpoints of 100 steps
    assert nbytes == 32 * 7 * 256 + 56 * 256 + 8 * (10 + 16)
    env, cfg, s = _launch(False, 1, I.Integrator(
        n_steps=2000, dt=4.0, method="dopri", max_step=4.0), n=16)
    rep = C.replay([(env, cfg, s)])
    assert C.segment(2000) == 64 and rep.rays == 16 and rep.steps >= 16
    assert C.replay([]) is None
