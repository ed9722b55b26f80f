"""Sharded differentiable-rendering optimization: inverse rendering
(PyTorch port of parallel/train.py).

Fits physical scene parameters (the hole's mass, the camera pose,
textures) to target images by gradient descent through the renderer.  Each
rank renders its ray slots (``render.local_slots``) and its share of the
samples in one batch (the renderer's ``render_samples``), as the JAX
package's vmap does,
differentiates its loss -- on the card through RK4Adjoint: the
CUDA kernels rk4_ckpt forward and rk4_bwd backward (dopri_ckpt and
dopri_bwd for a Dormand-Prince integrator) -- and the gradients and the
loss are averaged over every rank of the mesh (``all_reduce`` of the sum,
divided by the ranks: gloo has no average) before the optimizer's update,
so every rank holds the same parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..camera.pinhole import Camera
from ..models.kerr import critical_weights
from ..ops.geodesic import null_init
from ..render.renderer import (RenderConfig, camera_rays, render_samples,
                               sample_draws)
from ..scene.scene import Scene
from ..utils.profiling import annotate
from .mesh import Mesh, make_mesh
from .render import local_samples, local_slots, slot_jitter


def default_loss(rendered: torch.Tensor, target: torch.Tensor
                 ) -> torch.Tensor:
    """Mean-squared pixel error over the flat ray batch (N, 3)."""
    return torch.mean((rendered - target) ** 2)


def frame_draws(cfg: RenderConfig, frame: int, device) -> torch.Tensor:
    """Frame ``frame``'s fixed jitter draws: ``sample_draws`` from a
    generator seeded from (cfg.seed, frame).  ``fit_frames(...,
    reuse_keys=True)`` takes them; render the targets with them."""
    return sample_draws(dataclasses.replace(
        cfg, seed=cfg.seed * 2**20 + frame), device)


@dataclasses.dataclass
class OptState:
    """What optax's opt_state holds: the optimizer over the learned
    tensors (its moments and step counts) and its schedule, if any."""

    optimizer: torch.optim.Optimizer
    scheduler: Any = None

    def state_dict(self) -> dict:
        out = {"optimizer": self.optimizer.state_dict()}
        if self.scheduler is not None:
            out["scheduler"] = self.scheduler.state_dict()
        return out

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(state["scheduler"])


@dataclasses.dataclass
class Trainer:
    """Optimizes a dict of (scene, camera) parameter tensors against
    targets.

    ``param_fn(params) -> (scene, cam)`` rebuilds the scene from the
    learned tensors, so callers choose what is trainable by how they close
    over frozen parts.  ``optimizer(tensors) -> torch.optim.Optimizer``
    builds the optimizer over them; ``scheduler(optimizer)``, if given, its
    learning-rate schedule, stepped after every update; ``clip_norm``, if
    given, scales the averaged gradients to that global L2 norm when they
    exceed it (optax.clip_by_global_norm).

    Fitting guidance: use ``cfg.samples >= 4`` (jittered pixel-area
    integration) and clipping.  Pointwise pixel-centre gradients are exact
    but pathological near the critical curve, where a ray's exit direction
    spins with the parameters; jittered samples estimate the smooth
    derivative of the pixel-integrated intensity.
    """

    cfg: RenderConfig
    param_fn: Callable[[Any], tuple[Scene, Camera]]
    optimizer: Callable[[list], torch.optim.Optimizer]
    loss_fn: Callable[[torch.Tensor, torch.Tensor],
                      torch.Tensor] = default_loss
    mesh: Mesh | None = None
    # Multi-frame fitting (BASELINE config 4): builds the frame's (scene,
    # camera) from the learned params and the frame's phase.
    frame_param_fn: Callable[[Any, torch.Tensor],
                             tuple[Scene, Camera]] | None = None
    # Critical-curve loss masking: rays whose angular momentum
    # ell = |x cross p| / E lies within this relative band of the critical
    # ell_c = 3 sqrt(3) M wind around the photon sphere, and their pixel
    # values oscillate on tiny parameter scales.  e.g. 0.25 drops
    # |ell / ell_c - 1| <= 0.25 from a weighted MSE that replaces loss_fn;
    # a Kerr hole is masked by the distance from its own critical curve
    # (``_critical_weights``).
    mask_critical: float | None = None
    scheduler: Callable[[torch.optim.Optimizer], Any] | None = None
    clip_norm: float | None = None

    def __post_init__(self):
        if self.mesh is None:
            self.mesh = make_mesh()
        local_samples(self.cfg, self.mesh)   # samples divisible: raises

    def init(self, params: dict) -> OptState:
        """The optimizer (and schedule) over ``params``' tensors."""
        opt = self.optimizer(list(params.values()))
        return OptState(opt, None if self.scheduler is None
                        else self.scheduler(opt))

    def shard_target(self, target_image: torch.Tensor):
        """(H, W, >= 3) target -> this rank's (target (slots, 3), ys, xs),
        in ray-slot order, on the target's device."""
        ys, xs = local_slots(self.cfg, self.mesh, target_image.device)
        return target_image[ys, xs, :3], ys, xs

    def step(self, params, opt_state, target_flat, ys, xs, draws=None):
        """One optimization step; returns (params, opt_state, loss), the
        params updated in place.  ``draws`` (samples, 2, Hc, Wc), the same
        on every rank, jitter a multisampled render."""
        return self._step_body(self.param_fn, params, opt_state,
                               target_flat, ys, xs, draws)

    def _step_body(self, build, params, opt_state, target_flat, ys, xs,
                   draws):
        """This rank's render and loss, the gradients of its loss, their
        average and the loss's over the mesh, the clip, then the update.
        ``build(p)`` makes the frame's (scene, camera) from the learned
        tensors.  The step and each of its phases run in a profiler span
        (``bhgc.step`` and ``bhgc.step.*``)."""
        cfg = self.cfg
        with annotate("bhgc.step"):
            with annotate("bhgc.step.scene"):
                scene, cam = build(params)
            with annotate("bhgc.step.render"):
                rgb = render_samples(scene, cam, cfg, ys, xs, slot_jitter(
                    cfg, draws, ys, xs, local_samples(cfg, self.mesh)))
            with annotate("bhgc.step.loss"):
                if self.mask_critical is not None:
                    w = self._critical_weights(scene, cam, ys, xs)[..., None]
                    loss = torch.sum(w * (rgb - target_flat) ** 2) / (
                        torch.clamp_min(torch.sum(w), 1.0) * rgb.shape[-1])
                else:
                    loss = self.loss_fn(rgb, target_flat)

            leaves = list(params.values())
            with annotate("bhgc.step.backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves, grads)]
            with annotate("bhgc.step.update"):
                loss = loss.detach()
                if self.mesh.size > 1:
                    for t in grads + [loss]:
                        dist.all_reduce(t)
                        t.div_(self.mesh.size)
                if self.clip_norm is not None:
                    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                    grads = [torch.where(norm < self.clip_norm, g,
                                         g / norm * self.clip_norm)
                             for g in grads]
                for p, g in zip(leaves, grads):
                    p.grad = g
                opt_state.optimizer.step()
                opt_state.optimizer.zero_grad(set_to_none=True)
                if opt_state.scheduler is not None:
                    opt_state.scheduler.step()
        return params, opt_state, loss

    def _critical_weights(self, scene, cam, ys, xs):
        """0/1 ray weights leaving out the critical band (mask_critical),
        from the pixel-centre rays and the current params, constant under
        the gradient.

        Schwarzschild: |ell / (3 sqrt(3) M) - 1| <= band.  Kerr: the same
        rule on the Kerr critical curve, where the JAX package keeps
        Schwarzschild's "coarse" ell_c for every spin (JAX
        parallel/train.py:84-86), which at a/M = 0.9 brackets neither of
        the shadow's equatorial edges.  Each ray's Carter constants
        (lambda, eta) = (L_z / E, Q / E^2) are taken from its initial
        state, and |rho / rho_c - 1| <= band is left out, rho =
        sqrt(eta + lambda^2) against the critical curve's rho_c at the
        same angle atan2(sqrt(eta), lambda) (models/kerr.py
        ``critical_weights``, on a table of the curve made from the current
        mass and spin).  Rays with eta < 0 do not come near the curve and
        are kept.  At a = 0 this is the Schwarzschild rule."""
        with torch.no_grad():
            _, d, o_rel = camera_rays(scene, cam, self.cfg, ys, xs)
            bh = scene.bh
            p0, e0 = null_init(o_rel, d, bh.mass, bh.spin)
            if bh.spin is not None:
                return critical_weights(o_rel, p0, e0, bh.mass, bh.spin,
                                        self.mask_critical)
            ell = torch.linalg.norm(torch.linalg.cross(o_rel, p0, dim=-1),
                                    dim=-1) / e0
            ell_c = 3.0 * math.sqrt(3.0) * scene.bh.mass
            w = torch.abs(ell / torch.clamp_min(ell_c, 1e-6) - 1.0) > (
                self.mask_critical)
            return w.to(torch.float32)

    def _leaves(self, params, device) -> dict:
        return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                .detach().clone().requires_grad_(True)
                for k, v in params.items()}

    def _draws(self, generator, device):
        """A step's fresh (samples, 2, Hc, Wc) draws; None at one sample."""
        if self.cfg.samples == 1:
            return None
        x0, x1, y0, y1 = self.cfg.crop()
        return torch.rand((self.cfg.samples, 2, y1 - y0, x1 - x0),
                          generator=generator, dtype=torch.float32,
                          device=device)

    def _generator(self, generator, device):
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(self.cfg.seed)
        return generator

    def fit(self, params, target_image: torch.Tensor, n_steps: int,
            generator: torch.Generator | None = None, log_every: int = 0):
        """Shard once, then ``n_steps`` steps, each multisampled step on
        fresh draws from ``generator`` (default: seeded with cfg.seed on
        the target's device).  Returns (params, losses)."""
        device = target_image.device
        generator = self._generator(generator, device)
        target_flat, ys, xs = self.shard_target(target_image)
        params = self._leaves(params, device)
        opt_state = self.init(params)
        losses = []
        for i in range(n_steps):
            params, opt_state, loss = self.step(
                params, opt_state, target_flat, ys, xs,
                self._draws(generator, device))
            losses.append(float(loss))
            if log_every and i % log_every == 0:
                print(f"step {i:5d}  loss {losses[-1]:.6e}")
        return {k: v.detach() for k, v in params.items()}, losses

    def fit_frames(self, params, target_images, phases, n_epochs,
                   generator: torch.Generator | None = None,
                   log_every: int = 0, reuse_keys: bool = False):
        """Multi-frame orbit fit (BASELINE config 4): each epoch sweeps
        every frame once, ``frame_param_fn(params, phase)`` building frame
        f's scene and camera.  ``reuse_keys=True`` gives frame f the same
        draws every epoch, ``frame_draws(cfg, f, device)`` (common random
        numbers: the loss becomes a deterministic function of the
        params; render the targets with those draws); otherwise each step
        draws afresh from ``generator``.  Returns (params, losses)."""
        if self.frame_param_fn is None:
            raise ValueError("fit_frames requires frame_param_fn")
        device = target_images[0].device
        generator = self._generator(generator, device)
        targets = [self.shard_target(t)[0] for t in target_images]
        _, ys, xs = self.shard_target(target_images[0])
        params = self._leaves(params, device)
        opt_state = self.init(params)
        fixed = ([frame_draws(self.cfg, f, device)
                  for f in range(len(targets))]
                 if reuse_keys and self.cfg.samples > 1 else None)
        losses = []
        for e in range(n_epochs):
            for f, (target_flat, ph) in enumerate(zip(targets, phases)):
                phase = torch.as_tensor(ph, dtype=torch.float32,
                                        device=device)
                draws = (fixed[f] if fixed is not None
                         else self._draws(generator, device))
                params, opt_state, loss = self._step_body(
                    lambda p, ph=phase: self.frame_param_fn(p, ph), params,
                    opt_state, target_flat, ys, xs, draws)
                losses.append(float(loss))
                if log_every and len(losses) % log_every == 1:
                    print(f"epoch {e:4d} frame {f}  loss {losses[-1]:.6e}")
        return {k: v.detach() for k, v in params.items()}, losses
