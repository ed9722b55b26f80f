"""The work of the integrator kernels, counted on the frozen reference.

A kernel's roofline share is the least time the card could take for its
work over the time it took.  The work is counted on the plain reference,
never on the program, so it reads the same whatever implements a kernel:

* ray-steps (RK4) or ray-trips (Dormand-Prince): the rays ACTIVE before
  each step or trip of the reference's loop from the traced rays' initial
  states, summed; and those whose sphere guard passes (the forward
  kernels run the K sphere quadratics only for them);
* operations per ray-step or trip: each elementwise arithmetic result on
  a batch of 64 live rays (``OpCount``, one a ray; a reduction of k terms
  k - 1; selects and data movement none) of the reference's own step
  statement, and, for an adjoint, those of the step again plus the
  operations autograd runs to differentiate it (``BackwardOpCount``);
* bytes: each input read once and each output written once: the ray
  state in and out, the checkpoints, the scalar and sphere tables.

The card's peaks are NVIDIA's data sheet for the H100 SXM at 700 W:
float32 outside the tensor cores, and HBM3.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..reference import integrate as I

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
MAX_SEG = 64

COUNTED = {
    "add", "sub", "mul", "div", "true_divide", "neg", "sqrt", "rsqrt", "abs",
    "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "gt", "ge", "lt",
    "le", "eq", "ne", "isfinite", "pow", "reciprocal", "__add__", "__radd__",
    "__iadd__", "__sub__", "__rsub__", "__isub__", "__mul__", "__rmul__",
    "__imul__", "__truediv__", "__rtruediv__", "__itruediv__", "__neg__",
    "__pow__", "__rpow__", "__gt__", "__ge__", "__lt__", "__le__", "__eq__",
    "__ne__", "__abs__"}
# The same operations as aten names, in which autograd's backward runs.
ATEN_COUNTED = {
    "add", "sub", "mul", "div", "neg", "sqrt", "rsqrt", "abs", "clamp",
    "clamp_min", "clamp_max", "maximum", "minimum", "gt", "ge", "lt", "le",
    "eq", "ne", "isfinite", "pow", "reciprocal", "sign", "sgn", "rsub"}


class OpCount(torch.overrides.TorchFunctionMode):
    """The floating-point operations per ray of a plain PyTorch function
    on a batch of ``n`` rays."""

    def __init__(self, n):
        super().__init__()
        self.n, self.ops = n, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if isinstance(out, torch.Tensor):
            if name in COUNTED:
                self.ops += max(out.numel() // self.n, 1)
            elif name == "sum" and args:
                self.ops += max((args[0].numel() - out.numel()) // self.n, 0)
        return out


class BackwardOpCount(TorchDispatchMode):
    """The same count over the aten operations that run under it: those of
    an autograd backward pass."""

    def __init__(self, n):
        super().__init__()
        self.n, self.ops = n, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if isinstance(out, torch.Tensor):
            if name in ATEN_COUNTED:
                self.ops += max(out.numel() // self.n, 1)
            elif name == "sum" and args:
                self.ops += max((args[0].numel() - out.numel()) // self.n, 0)
        return out


def segment(n_steps: int) -> int:
    """Steps between the gradient kernels' checkpoints: 16, doubled while
    its square is under n_steps, up to MAX_SEG."""
    seg = 16
    while seg * seg < n_steps and seg < MAX_SEG:
        seg *= 2
    return seg


def guard_pass(env: I.Env, x, y):
    """Per ray, whether the sphere guard of the forward kernels lets the
    sphere quadratics of the segment x -> y run: the segment's radial band
    reaches some sphere's shell."""
    rb = I.radius(y)
    L = torch.linalg.norm(y - x, dim=-1)
    c, rad = env.spheres
    ck = torch.linalg.norm(c, dim=-1)
    return ((rb[..., None] - L[..., None] <= ck + rad)
            & (rb[..., None] + L[..., None] >= ck - rad)).any(-1)


@dataclasses.dataclass
class Replay:
    """What the reference's loop did on the traced rays: rays, ray-steps
    (or trips), those past the sphere guard, and the work per ray-step."""

    n_steps: int
    rays: int = 0
    steps: int = 0
    guard: int = 0
    spheres: int = 0
    step_ops: int = 0
    quad_ops: int = 0
    guard_ops: int = 0
    adj_ops: int = 0


def _live(s: I.State, k: int = 64) -> I.State:
    """The first k rays, all made ACTIVE: the batch the operations per ray
    are counted on."""
    idx = torch.arange(min(k, s.E.numel()), device=s.x.device)
    few = I._compact(s, idx)
    few.status = torch.zeros_like(few.status)
    return few


def _per_ray_ops(env: I.Env, cfg: I.Integrator, s0: I.State, rep: Replay):
    few = _live(s0)
    n = few.E.numel()
    h = torch.full_like(few.E, 0.5)

    def step(x, p, E, mass, centers, radii):
        e = dataclasses.replace(
            env, mass=mass,
            spheres=None if env.spheres is None else (centers, radii))
        s = dataclasses.replace(few, x=x, p=p, E=E)
        if cfg.method == "dopri":
            out, _, _ = I.dopri_trip(e, cfg, s, h)
        else:
            out = I.fixed_step(e, cfg, s)
        return out.x, out.p

    centers, radii = (env.spheres if env.spheres is not None
                      else (torch.zeros(0, 3, device=s0.x.device),
                            torch.zeros(0, device=s0.x.device)))
    args = (few.x, few.p, few.E, env.mass, centers, radii)
    with OpCount(n) as c:
        step(*args)
    rep.step_ops = c.ops
    if env.spheres is not None:
        y = few.x + 0.1 * few.p
        with OpCount(n) as c:
            I.sphere_events(env, few.x, y)
        rep.quad_ops = c.ops
        with OpCount(n) as c:
            guard_pass(env, few.x, y)
        rep.guard_ops = c.ops
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    outs = step(*leaves)
    with BackwardOpCount(n) as c:
        torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs],
                            allow_unused=True)
    rep.adj_ops = c.ops


@torch.no_grad()
def replay(launches) -> Replay | None:
    """The reference's loop over each (env, integrator, flat initial state)
    of ``launches``, counting as it goes; None without a launch."""
    rep = None
    for env, cfg, s in launches:
        if rep is None:
            rep = Replay(n_steps=cfg.n_steps,
                         spheres=0 if env.spheres is None
                         else int(env.spheres[0].shape[0]))
            with torch.enable_grad():
                _per_ray_ops(env, cfg, s, rep)
        rep.rays += s.E.numel()
        h = None
        if cfg.method == "dopri":
            h = torch.full(s.E.shape, min(cfg.dt, cfg.max_step),
                           dtype=s.x.dtype, device=s.x.device)
        for _ in range(cfg.n_steps):
            idx = torch.nonzero(s.active).squeeze(-1)
            if idx.numel() == 0:
                break
            rep.steps += idx.numel()
            sub = I._compact(s, idx)
            if h is None:
                dt = I.dt_eff(env, cfg, sub)
                x1, p1 = I.rk4_step(env, sub.x, sub.p, sub.E, dt)
                if env.spheres is not None:
                    rep.guard += int(guard_pass(env, sub.x, x1).sum())
                sub = I.apply_events(env, sub, x1, p1, dt)
            else:
                if env.spheres is not None:
                    y = I.dopri_step(env, sub.x, sub.p, sub.E, h[idx])[0]
                    rep.guard += int(guard_pass(env, sub.x, y).sum())
                sub, h_sub, _ = I.dopri_trip(env, cfg, sub, h[idx])
                h = h.index_put((idx,), h_sub)
            s = I._scatter(s, idx, sub)
    return rep


def bound_ms(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3


def tables(rep: Replay) -> int:
    """Bytes of the scalar vector and the sphere table."""
    return 4 * (10 + 4 * rep.spheres)


def forward_ops(rep: Replay) -> int:
    """A forward kernel's operations: every live step with its guard, the
    sphere quadratics only where the guard passes."""
    return (rep.steps * (rep.step_ops - rep.quad_ops + rep.guard_ops)
            + rep.guard * rep.quad_ops)


def adjoint_ops(rep: Replay) -> int:
    """An adjoint kernel's operations: each live step recomputed onto the
    tape, then differentiated."""
    return rep.steps * (rep.step_ops + rep.adj_ops)
