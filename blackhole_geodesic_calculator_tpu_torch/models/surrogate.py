"""Learned geodesic surrogate (PyTorch port of models/surrogate.py).

Kerr breaks the spherical symmetry that makes the Schwarzschild scattering
table of ``render/limited.py`` exact: the map from a photon's entry into
the sphere of influence (position, direction) to its exit (position,
direction, captured) depends on four irreducible degrees of freedom.  Here
that map is learned: an MLP trained against the live integrator, each
optimizer step labelling a fresh random batch through ``launch`` (the CUDA
kernel rk4_fwd on the card, the plain loop on the CPU), so there is no
stored dataset.

The two exact symmetries of Kerr in Kerr-Schild Cartesian form --
rotations about the spin (+z) axis and the reflection z -> -z -- are
canonicalized out in closed form (entry azimuth rotated to 0, entry z
reflected to >= 0), so ``trace`` is equivariant by construction.

The network predicts residuals on top of the straight chord (zero output =
flat space).  ``precision="f32"`` runs its matrix products in IEEE float32
(never TF32: the JAX package runs them at ``Precision.HIGHEST``);
``"bf16"`` rounds each product's operands to bfloat16 and multiplies and
sums them in float32, as ``preferred_element_type=float32`` does.
``NeuralSurrogate.trace`` has ``SurrogateTable.trace``'s protocol, so a
trained model drops into ``render_limited(..., table=...)``.

Weights keep the JAX package's orientation, W of shape (fan_in, fan_out),
so the npz files of ``save_surrogate``/``load_surrogate`` are the JAX
package's format and either package loads the other's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import states
from ..ops.integrate import (GeodesicEnv, IntegratorConfig, final_direction,
                             launch)
from ..scene.scene import on_device
from .kerr import horizon_radius


# =============================================================================
# Configuration.
# =============================================================================
@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    """Architecture and labelling-integrator budget of one surrogate."""

    width: int = 256
    depth: int = 5              # hidden layers
    r_influence: float = 20.0   # sphere-of-influence radius (units of M)
    exit_tolerance: float = 0.1  # exit shell at r_influence (1 + this)
    precision: str = "f32"      # 'f32' | 'bf16' (matrix products)
    # the integrator that labels training batches (and evaluates)
    n_steps: int = 512
    dt: float = 0.05
    lam_max: float = 200.0
    dt_boost: float = 4.0
    backend: str = "auto"       # the integrate dispatch: auto|cuda|torch

    @property
    def n_features(self) -> int:
        return 11

    @property
    def n_outputs(self) -> int:
        return 7  # exit dir (3) + exit loc / R (3) + capture logit (1)


# =============================================================================
# Exact symmetry canonicalization.
# =============================================================================
def _rz(phi: torch.Tensor) -> torch.Tensor:
    """Batched active rotation about +z by ``phi``: (..., 3, 3)."""
    c, s = torch.cos(phi), torch.sin(phi)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _apply(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """rot @ v per ray, as products and sums (no TF32 setting touches it)."""
    return torch.sum(rot * v[..., None, :], dim=-1)


def _flip_z(v: torch.Tensor, sgn: torch.Tensor) -> torch.Tensor:
    return torch.cat([v[..., :2], v[..., 2:3] * sgn[..., None]], dim=-1)


def canonicalize(entry, d):
    """(entry_c, d_c, phi, flip): (entry, d) rotated to entry azimuth 0 and
    reflected to entry_c z >= 0; ``decanonicalize`` inverts it."""
    phi = torch.atan2(entry[..., 1], entry[..., 0])
    rot = _rz(-phi)
    entry_c = _apply(rot, entry)
    d_c = _apply(rot, d)
    flip = entry_c[..., 2] < 0.0
    sgn = torch.where(flip, -1.0, 1.0)
    return _flip_z(entry_c, sgn), _flip_z(d_c, sgn), phi, flip


def decanonicalize(v, phi, flip):
    """Undo ``canonicalize`` on a canonical-frame vector field ``v``."""
    return _apply(_rz(phi), _flip_z(v, torch.where(flip, -1.0, 1.0)))


def _features(entry_c, d_c, R):
    """The 11 canonical-frame input features: the entry's polar sine and
    cosine, the direction, the impact-parameter vector e x d, the radial
    rate e . d, |b| (a smooth norm: a radial entry has e x d = 0, whose
    plain norm has a 0/0 derivative) and log(|b| + 1e-4), which resolves
    the -log(b - b_c) divergence of the deflection."""
    e = entry_c / R
    cross = torch.linalg.cross(e, d_c, dim=-1)
    dot = torch.sum(e * d_c, dim=-1, keepdim=True)
    bmag = torch.sqrt(torch.sum(cross * cross, dim=-1, keepdim=True) + 1e-8)
    logb = torch.log(bmag + 1e-4)
    return torch.cat([e[..., 0:1], e[..., 2:3], d_c, cross, dot, bmag, logb],
                     dim=-1)


def _straight_exit(entry_c, d_c, R):
    """Where a straight ray entering at ``entry_c`` leaves the sphere,
    entry - 2 (entry . d) d, over R: the baseline of the residuals."""
    t = -2.0 * torch.sum(entry_c * d_c, dim=-1, keepdim=True)
    return (entry_c + t * d_c) / R


# =============================================================================
# MLP.
# =============================================================================
def init_params(generator: torch.Generator, cfg: SurrogateConfig):
    """He-initialised [(W, b), ...] for ``depth`` hidden layers and the
    head, W of shape (fan_in, fan_out), on the generator's device."""
    dims = [cfg.n_features] + [cfg.width] * cfg.depth + [cfg.n_outputs]
    dev = generator.device
    params = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((fan_in, fan_out), generator=generator,
                        dtype=torch.float32, device=dev)
        params.append((w * math.sqrt(2.0 / fan_in),
                       torch.zeros(fan_out, dtype=torch.float32,
                                   device=dev)))
    return params


@contextlib.contextmanager
def _ieee_matmul():
    """Matrix products in IEEE float32 inside the block, whatever the
    process's TF32 setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def mlp_apply(params, feats, precision: str = "f32"):
    """The dense stack, tanh-form GELU between layers (``jax.nn.gelu``'s
    default).  'f32': IEEE float32 products; 'bf16': each product's
    operands rounded to bfloat16, multiplied and summed in float32, the
    activations rounded to bfloat16 after each GELU."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}; expected 'f32' "
                         "or 'bf16'")
    rnd = _bf16 if precision == "bf16" else (lambda t: t)
    with _ieee_matmul():
        h = rnd(feats)
        for w, b in params[:-1]:
            h = rnd(F.gelu(h @ rnd(w) + b, approximate="tanh"))
        w, b = params[-1]
        return h @ rnd(w) + b


# =============================================================================
# The surrogate (SurrogateTable's trace protocol).
# =============================================================================
def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               1e-20)


def _project(loc, r_exit):
    """Points ``loc`` moved along their rays onto the exit shell."""
    return loc * (r_exit / torch.clamp_min(
        torch.linalg.norm(loc, dim=-1, keepdim=True), 1e-20))


class NeuralSurrogate(nn.Module):
    """A trained scattering map with ``SurrogateTable.trace``'s protocol.

    ``params`` is [(W, b), ...]; the mass, spin, influence radius and exit
    radius (default 1.1 R: predicted exit points are projected onto it, so
    the hybrid's flat re-cast never re-enters the influence sphere) are
    float32 buffers on the weights' device; ``precision`` is 'f32' or
    'bf16'."""

    def __init__(self, params, mass, spin, r_influence, r_exit=None,
                 precision: str = "f32"):
        super().__init__()
        self.weights = nn.ParameterList()
        for w, b in params:
            for t in (w, b):
                self.weights.append(nn.Parameter(
                    torch.as_tensor(t).detach(), requires_grad=False))
        dev = self.weights[0].device

        def scalar(v):
            return torch.as_tensor(v, dtype=torch.float32, device=dev)

        self.register_buffer("mass", scalar(mass))
        self.register_buffer("spin", scalar(spin))
        self.register_buffer("r_influence", scalar(r_influence))
        self.register_buffer("r_exit", scalar(
            1.1 * float(r_influence) if r_exit is None else r_exit))
        self.precision = precision

    @property
    def params(self):
        """[(W, b), ...], the JAX package's layout."""
        ws = list(self.weights)
        return list(zip(ws[0::2], ws[1::2]))

    def raw(self, entry, d):
        """Canonical-frame network outputs (dir, loc/R, logit), phi, flip."""
        entry_c, d_c, phi, flip = canonicalize(entry, d)
        out = mlp_apply(self.params, _features(entry_c, d_c,
                                               self.r_influence),
                        self.precision)
        return out, phi, flip

    def trace(self, entry, d):
        """(exit_loc, exit_dir, captured) of rays entering at ``entry``
        (BH-centred) with directions ``d``, in world coordinates."""
        if entry.device != self.mass.device:
            raise ValueError(f"rays on {entry.device}, the surrogate on "
                             f"{self.mass.device}")
        dn = _unit(d)
        entry_c, d_c, phi, flip = canonicalize(entry, dn)
        R = self.r_influence
        out = mlp_apply(self.params, _features(entry_c, d_c, R),
                        self.precision)
        exit_dir = _unit(d_c + out[..., 0:3])
        exit_loc = _project(
            (_straight_exit(entry_c, d_c, R) + out[..., 3:6]) * R,
            self.r_exit)
        captured = out[..., 6] > 0.0
        return (decanonicalize(exit_loc, phi, flip),
                decanonicalize(exit_dir, phi, flip), captured)

    def capture_prob(self, entry, d):
        out, _, _ = self.raw(entry, d)
        return torch.sigmoid(out[..., 6])


# =============================================================================
# Labelling with the real integrator.
# =============================================================================
def _label_env(mass, spin, cfg: SurrogateConfig,
               device=None) -> GeodesicEnv:
    """The labels' environment on ``device`` (the card unless told
    otherwise): capture at 2M, or at the outer horizon r_+ for a spin (a
    spin of 0 integrates as Schwarzschild), escape at R (1 + tol)."""
    f32 = dict(dtype=torch.float32, device=on_device(device))
    m = torch.as_tensor(mass, **f32)
    if spin is None:
        r_cap, sp = 2.0 * m, None
    else:
        sp = torch.as_tensor(spin, **f32)
        r_cap = horizon_radius(m, sp)
        sp = None if float(spin) == 0.0 else sp
    return GeodesicEnv(
        mass=m, r_capture=r_cap,
        r_escape=torch.tensor(cfg.r_influence * (1.0 + cfg.exit_tolerance),
                              **f32),
        lam_max=torch.tensor(cfg.lam_max, **f32), spin=sp)


def label_rays(env: GeodesicEnv, cfg: SurrogateConfig, entry, d):
    """(captured, exit_loc, exit_dir, escaped) of (entry, d) integrated to
    termination: the training labels.  BUDGET rays are in neither mask.
    The entry is nudged inward by 1e-4 so the shell does not trip
    r_escape; non-finite final directions and positions (a Kerr capture
    frozen by the ring singularity) become 0, since a masked NaN would
    still poison the loss."""
    icfg = IntegratorConfig(n_steps=cfg.n_steps, dt=cfg.dt,
                            dt_boost=cfg.dt_boost, backend=cfg.backend)
    s = launch(env, entry * (1.0 - 1e-4), d, icfg)
    captured = ((s.status == states.CAPTURED)
                | (s.status == states.INSIDE_HORIZON))
    escaped = s.status == states.ESCAPED
    fin_d = final_direction(env, s)
    fin_d = torch.where(torch.isfinite(fin_d), fin_d, 0.0)
    x_fin = torch.where(torch.isfinite(s.x), s.x, 0.0)
    return captured, x_fin, fin_d, escaped


def sample_entries(generator: torch.Generator, n: int, cfg: SurrogateConfig,
                   mass):
    """n entry states on the influence sphere, on the generator's device:
    uniform positions; each direction, with probability 1/2, uniform on
    the inward hemisphere or at impact parameter b ~ U[0, 8M] from the
    inward radial with a uniform azimuth (a uniform sampler puts only
    ~(b_c/R)^2 of the rays in the capture cone)."""
    dev = generator.device
    f32 = dict(generator=generator, dtype=torch.float32, device=dev)
    R = cfg.r_influence
    entry = torch.randn((n, 3), **f32)
    entry = R * entry / torch.linalg.norm(entry, dim=-1, keepdim=True)
    inward = -entry / R

    d_uni = torch.randn((n, 3), **f32)
    d_uni = d_uni / torch.linalg.norm(d_uni, dim=-1, keepdim=True)
    s = torch.sign(torch.sum(d_uni * inward, dim=-1, keepdim=True))
    d_uni = d_uni * torch.where(s == 0, 1.0, s)

    b = torch.rand((n,), **f32) * (8.0 * float(mass))
    alpha = torch.asin(torch.clamp(b / R, 0.0, 1.0))
    psi = torch.rand((n,), **f32) * (2.0 * math.pi)
    ref = torch.where(torch.abs(inward[..., 0:1]) < 0.9,
                      inward.new_tensor([1.0, 0.0, 0.0]),
                      inward.new_tensor([0.0, 1.0, 0.0]))
    u = torch.linalg.cross(inward, ref, dim=-1)
    u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
    v = torch.linalg.cross(inward, u, dim=-1)
    d_imp = (torch.cos(alpha)[..., None] * inward
             + (torch.sin(alpha) * torch.cos(psi))[..., None] * u
             + (torch.sin(alpha) * torch.sin(psi))[..., None] * v)

    pick = torch.rand((n, 1), **f32) < 0.5
    return entry, torch.where(pick, d_imp, d_uni)


# =============================================================================
# Training.
# =============================================================================
def surrogate_loss(params, cfg: SurrogateConfig, R, entry, d,
                   captured, exit_loc, exit_dir, escaped):
    """(bce + 10 dir_mse + loc_mse, (bce, dir_mse, loc_mse)): the capture
    BCE over the rays with a resolved fate, and the escape state's
    residuals (in the canonical frame, exit points projected onto the exit
    shell) over the escaped rays."""
    entry_c, d_c, phi, flip = canonicalize(entry, d)
    out = mlp_apply(params, _features(entry_c, d_c, R), cfg.precision)
    sgn = torch.where(flip, -1.0, 1.0)
    rot = _rz(-phi)

    def to_canon(v):
        return _flip_z(_apply(rot, v), sgn)

    exit_loc = _project(exit_loc, R * (1.0 + cfg.exit_tolerance))
    dir_t = to_canon(exit_dir) - d_c
    loc_t = to_canon(exit_loc) / R - _straight_exit(entry_c, d_c, R)

    labeled = (captured | escaped).to(torch.float32)
    bce_ray = F.binary_cross_entropy_with_logits(
        out[..., 6], captured.to(torch.float32), reduction="none")
    bce = (labeled * bce_ray).sum() / torch.clamp_min(labeled.sum(), 1.0)
    m = escaped.to(torch.float32)
    denom = torch.clamp_min(m.sum(), 1.0)
    dir_mse = (m * torch.sum((out[..., 0:3] - dir_t) ** 2, -1)).sum() / denom
    loc_mse = (m * torch.sum((out[..., 3:6] - loc_t) ** 2, -1)).sum() / denom
    return bce + 10.0 * dir_mse + loc_mse, (bce, dir_mse, loc_mse)


def warmup_cosine(lr: float, warmup: int, steps: int, end: float):
    """The learning rate at update ``t`` (counted from 0) of optax's
    ``warmup_cosine_decay_schedule(0, lr, warmup, steps, end)``: linear
    from 0 to ``lr`` over ``warmup`` updates, then a cosine to ``end`` at
    ``steps``."""
    decay = steps - warmup
    alpha = end / lr if lr else 0.0

    def at(t: int) -> float:
        if t < warmup:
            return lr * t / warmup
        k = min(t - warmup, decay)
        cos = 0.5 * (1.0 + math.cos(math.pi * k / decay)) if decay else 1.0
        return lr * ((1.0 - alpha) * cos + alpha)

    return at


def _optimizer(leaves, lr: float, steps: int):
    """(AdamW, its LambdaLR): optax.adamw(weight_decay=1e-5) at the rate of
    ``warmup_cosine(lr, max(steps // 20, 1), steps, lr * 1e-2)``, the
    LambdaLR stepped after each update so update t runs at rate(t)."""
    opt = torch.optim.AdamW(leaves, lr=lr, weight_decay=1e-5)
    rate = warmup_cosine(lr, max(steps // 20, 1), steps, lr * 1e-2)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: rate(t) / lr if lr else 0.0)
    return opt, sched


def train_surrogate(generator: torch.Generator, mass=0.5, spin=0.45,
                    cfg: SurrogateConfig | None = None, steps=2000,
                    batch=8192, lr=3e-3, log_every=0):
    """Train a NeuralSurrogate against the live integrator on the
    generator's device (the card: labels through rk4_fwd).

    Each step samples a fresh batch (``sample_entries``), labels it with
    ``label_rays`` under no_grad and takes one AdamW update (weight decay
    1e-5, torch's decoupled decay equal to optax.adamw's) at the rate of
    optax's ``warmup_cosine_decay_schedule(0, lr, max(steps // 20, 1),
    steps, lr * 1e-2)``, which the first update reads at its count 0:
    lr = 0.  Returns (NeuralSurrogate, history of the logged losses)."""
    cfg = cfg or SurrogateConfig()
    dev = generator.device
    env = _label_env(mass, spin, cfg, dev)
    R = torch.tensor(cfg.r_influence, dtype=torch.float32, device=dev)
    params = [(w.requires_grad_(True), b.requires_grad_(True))
              for w, b in init_params(generator, cfg)]
    opt, sched = _optimizer([t for pair in params for t in pair], lr, steps)

    history = {"loss": [], "bce": [], "dir_mse": [], "loc_mse": []}
    for i in range(steps):
        entry, d = sample_entries(generator, batch, cfg, mass)
        with torch.no_grad():
            captured, exit_loc, exit_dir, escaped = label_rays(env, cfg,
                                                               entry, d)
        loss, aux = surrogate_loss(params, cfg, R, entry, d, captured,
                                   exit_loc, exit_dir, escaped)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        if log_every and (i % log_every == 0 or i == steps - 1):
            for k, v in zip(history, (loss, *aux)):
                history[k].append(float(v.detach()))
    if not history["loss"]:
        history["loss"].append(float(loss.detach()))
    sur = NeuralSurrogate(
        [(w.detach(), b.detach()) for w, b in params], mass=mass,
        spin=0.0 if spin is None else spin, r_influence=cfg.r_influence,
        r_exit=cfg.r_influence * (1.0 + cfg.exit_tolerance),
        precision=cfg.precision)
    return sur, history


def evaluate_surrogate(generator: torch.Generator, sur: NeuralSurrogate,
                       cfg: SurrogateConfig, n=65536):
    """Held-out accuracy against the integrator on a fresh batch: capture
    accuracy over the rays with a resolved fate, median and p95 escape
    direction error (rad) and median exit-point error over the rays both
    call escaped, and the escaped share."""
    spin = float(sur.spin)
    env = _label_env(float(sur.mass), spin if spin != 0.0 else None, cfg,
                     generator.device)
    entry, d = sample_entries(generator, n, cfg, float(sur.mass))
    with torch.no_grad():
        captured, exit_loc, exit_dir, escaped = label_rays(env, cfg, entry,
                                                           d)
        ploc, pdir, pcap = sur.trace(entry, d)
    labeled = captured | escaped
    cap_acc = float(((pcap == captured) & labeled).sum()) / max(
        float(labeled.sum()), 1.0)
    both = (escaped & ~pcap).cpu().numpy()
    cosang = torch.clamp(torch.sum(pdir * exit_dir, -1), -1.0, 1.0)
    ang = torch.arccos(cosang).cpu().numpy()[both]
    exit_loc = _project(exit_loc, cfg.r_influence * (1.0 + cfg.exit_tolerance))
    locerr = torch.linalg.norm(ploc - exit_loc, dim=-1).cpu().numpy()[both]

    def stat(f, a, *args):
        return float(f(a, *args)) if a.size else float("nan")

    return {
        "capture_acc": cap_acc,
        "dir_err_median_rad": stat(np.median, ang),
        "dir_err_p95_rad": stat(np.percentile, ang, 95),
        "loc_err_median": stat(np.median, locerr),
        "escaped_frac": float(escaped.to(torch.float32).mean()),
    }


# =============================================================================
# Persistence: the JAX package's npz format.
# =============================================================================
def save_surrogate(path, sur: NeuralSurrogate):
    """``w{i}``, ``b{i}``, ``depth``, ``mass``, ``spin``, ``r_influence``,
    ``r_exit`` and ``precision`` in one npz."""
    flat = {"mass": sur.mass.cpu().numpy(), "spin": sur.spin.cpu().numpy(),
            "r_influence": sur.r_influence.cpu().numpy(),
            "r_exit": sur.r_exit.cpu().numpy(),
            "depth": np.asarray(len(sur.params) - 1),
            "precision": np.asarray(sur.precision)}
    for i, (w, b) in enumerate(sur.params):
        flat[f"w{i}"] = w.detach().cpu().numpy()
        flat[f"b{i}"] = b.detach().cpu().numpy()
    np.savez(path, **flat)


def load_surrogate(path, device=None) -> NeuralSurrogate:
    """A surrogate saved by either package, on ``device`` (the card unless
    told otherwise).  Files without ``precision`` were trained in bf16;
    files without ``r_exit`` exit at 1.1 R."""
    dev = on_device(device)
    with np.load(path) as z:
        depth = int(z["depth"])
        params = [(torch.as_tensor(z[f"w{i}"], device=dev),
                   torch.as_tensor(z[f"b{i}"], device=dev))
                  for i in range(depth + 1)]
        n_feat = int(params[0][0].shape[0])
        want = SurrogateConfig().n_features
        if n_feat != want:
            raise ValueError(
                f"surrogate {path!r} was trained with {n_feat} input "
                f"features but this version uses {want} (the feature set "
                f"gained |b|/log|b| in round 5); retrain with "
                f"`bhgc-tpu train-surrogate` or models.surrogate"
                f".train_surrogate")
        r_exit = (z["r_exit"] if "r_exit" in z.files
                  else 1.1 * z["r_influence"])
        precision = (str(z["precision"]) if "precision" in z.files
                     else "bf16")
        sur = NeuralSurrogate(params, mass=z["mass"], spin=z["spin"],
                              r_influence=z["r_influence"], r_exit=r_exit,
                              precision=precision)
    return sur
