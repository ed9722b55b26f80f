"""The work of the integrator kernels on a Kerr hole, counted on the
frozen Kerr reference (``reference_kerr``), as ``_common`` counts it on
the Schwarzschild one: the rays ACTIVE before each step of the Kerr
reference's loop from the traced rays' initial states, and the operations
of its own step statement and of autograd's backward of it
(``_common.OpCount``, ``_common.BackwardOpCount``), per ray.

``Record.replay`` runs the Schwarzschild reference, so a Kerr roofline
reads the kernel's traced time itself and replays through ``replay``
here, once a record.
"""

from __future__ import annotations

import dataclasses

import torch

from ..reference_kerr import integrate as K
from ._common import BackwardOpCount, OpCount, Replay, bound_ms


def _per_ray_ops(env: K.Env, cfg: K.Integrator, s0: K.State, rep: Replay):
    idx = torch.arange(min(64, s0.E.numel()), device=s0.x.device)
    few = K._compact(s0, idx)
    few.status = torch.zeros_like(few.status)
    n = few.E.numel()

    def step(x, p, E, mass, spin):
        s = dataclasses.replace(few, x=x, p=p, E=E)
        out = K.fixed_step(dataclasses.replace(env, mass=mass, spin=spin),
                           cfg, s)
        return out.x, out.p

    args = (few.x, few.p, few.E, env.mass, env.spin)
    with OpCount(n) as c:
        step(*args)
    rep.step_ops = c.ops
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    outs = step(*leaves)
    with BackwardOpCount(n) as c:
        torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs],
                            allow_unused=True)
    rep.adj_ops = c.ops


@torch.no_grad()
def replay(launches) -> Replay | None:
    """The Kerr reference's loop over each (env, integrator, flat initial
    state) of ``launches``, counting as it goes; None without a launch or
    for a hole without a spin."""
    rep = None
    for env, cfg, s in launches:
        if getattr(env, "spin", None) is None:
            return None
        if rep is None:
            rep = Replay(n_steps=cfg.n_steps)
            with torch.enable_grad():
                _per_ray_ops(env, cfg, s, rep)
        rep.rays += s.E.numel()
        for _ in range(cfg.n_steps):
            idx = torch.nonzero(s.active).squeeze(-1)
            if idx.numel() == 0:
                break
            rep.steps += idx.numel()
            s = K._scatter(s, idx, K.fixed_step(env, cfg, K._compact(s, idx)))
    return rep


def roofline(rec, work_module) -> float | None:
    """Percent of the kernel's traced device time that its bound needs, its
    work counted on the Kerr reference's replay of the traced steps; None
    where the kernel did not run or the loop traced no Kerr rays."""
    us = rec.kernel_us(work_module.KERNEL)
    if us <= 0:
        return None
    if not hasattr(rec, "kerr_replay"):
        rec.kerr_replay = replay(rec.loop.traced_rays())
    if rec.kerr_replay is None:
        return None
    ops, nbytes = work_module.work(rec.kerr_replay)
    return 100.0 * bound_ms(ops, nbytes) / (us / 1e3)
