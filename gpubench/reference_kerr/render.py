"""Plain rendering and the plain inverse-rendering step of the Kerr cells:
the frozen reference.

A copy of ``reference/render.py`` extended to a spinning hole: the camera
of camera/pinhole.py, the ray path of render/renderer.py and the step of
parallel/train.py (``Trainer.step`` on one rank: the critical-curve mask,
the masked mean-squared error, the clip by global norm) with Adam written
out as torch.optim.Adam computes it, as the port stood when the Kerr cell
was written.  Gradients, the spin's among them, come from autograd
through the plain loop of ``integrate``; rays go through in blocks, whose
losses and gradients add up, so that a 1024^2 x 5-sample step fits in
memory.  TF32 is off: nothing here multiplies matrices, but no float32
product may run in a lower precision.

The critical-curve mask is the port's rule written anew: each
pixel-centre ray's Carter constants lambda = L_z / E and eta = Q / E^2
from its initial state, and rho = sqrt(eta + lambda^2) against the Kerr
critical curve's rho_c at the same angle psi = atan2(sqrt(eta), lambda),
the curve's spherical photon orbit found by bisection in float64 for each
ray (the port interpolates a table).  Departures from the published
curve: |a| is held in [1e-4, 1 - 1e-4] M, and eta < 0 reads as 0 in psi
and rho (those rays are kept whatever their rho).

A scene is a dict: ``mass``, ``spin`` and ``loc`` of the hole,
``background`` (H, W, 3), ``disk`` (a dict of r_in, r_out, phase, mean,
stddev, intensity, texture, beaming) or None.  A camera is a dict of
``position``, ``euler`` and ``fov``.  A render config is a dict of width,
height, samples, lam_max, r_escape (0: twice the camera's distance plus
20 r_s) and the ``Integrator``.
"""

from __future__ import annotations

import math

import torch

from . import integrate as I
from .shading import shade

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def euler_matrix(euler):
    a, b, c = euler[0], euler[1], euler[2]
    ca, sa, cb, sb = torch.cos(a), torch.sin(a), torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    one, zero = torch.ones_like(a), torch.zeros_like(a)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    def mm(u, v):
        return torch.sum(u[..., :, :, None] * v[..., None, :, :], dim=-2)

    rx = mat([[one, zero, zero], [zero, ca, -sa], [zero, sa, ca]])
    ry = mat([[cb, zero, sb], [zero, one, zero], [-sb, zero, cb]])
    rz = mat([[cc, -sc, zero], [sc, cc, zero], [zero, zero, one]])
    return mm(mm(rz, ry), rx)


def generate_rays(cam, width, height, ys, xs, jitter=None):
    """Origins and unit directions through pixels (ys, xs), moved by one
    sample's draws (u, v) in [0, 1) or through the pixel centres."""
    aspect = height / width
    fov = cam["fov"]
    x_render = fov[0] * (xs - width // 2) / width
    y_render = fov[1] * (ys - height // 2) / height * aspect
    if jitter is not None:
        ju, jv = jitter - 0.5
        x_render = x_render + ju / width
        y_render = y_render + jv * aspect / height
    d_cam = torch.stack([x_render, y_render, -torch.ones_like(x_render)], -1)
    d = torch.sum(d_cam[..., None, :] * euler_matrix(cam["euler"]), dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return cam["position"].expand(d.shape), d


def geodesic_env(scene, cam, cfg) -> I.Env:
    rs = 2.0 * scene["mass"]
    if cfg["r_escape"] > 0:
        r_escape = torch.tensor(cfg["r_escape"], dtype=rs.dtype,
                                device=rs.device)
    else:
        r_escape = 2.0 * torch.linalg.norm(cam["position"] - scene["loc"]) \
            + 20.0 * rs
    disk = scene.get("disk")
    return I.Env(
        mass=scene["mass"], spin=scene["spin"],
        r_capture=I.horizon(scene["mass"], scene["spin"]),
        r_escape=r_escape,
        lam_max=torch.tensor(cfg["lam_max"], dtype=rs.dtype,
                             device=rs.device),
        disk=None if disk is None else (disk["r_in"], disk["r_out"]))


def initial_state(scene, cam, cfg, ys, xs, draws=None):
    """(env, flat initial state) of the rays through pixels (ys, xs): one
    ray a pixel through its centre, or one a sample and pixel, jittered by
    draws (samples, 2) + ys.shape, samples first."""
    if draws is None:
        o, d = generate_rays(cam, cfg["width"], cfg["height"], ys, xs)
    else:
        rays = [generate_rays(cam, cfg["width"], cfg["height"], ys, xs, j)
                for j in draws]
        o = torch.stack([r[0] for r in rays])
        d = torch.stack([r[1] for r in rays])
    env = geodesic_env(scene, cam, cfg)
    return env, I.start(env, (o - scene["loc"]).reshape(-1, 3),
                        d.reshape(-1, 3))


def render_pixels(scene, cam, cfg, ys, xs, draws=None, segment=0):
    """RGB of pixels (ys, xs), ys.shape + (3,): the mean of the jittered
    samples ``draws`` (samples, 2) + ys.shape, or the pixel centres, every
    ray of them in one integration."""
    env, s0 = initial_state(scene, cam, cfg, ys, xs, draws)
    s = I.integrate(env, cfg["integrator"], s0, segment=segment)
    rgb = shade(scene, s, I.final_direction(env, s))
    return rgb.reshape((-1,) + tuple(ys.shape) + (3,)).mean(0)


def pixels(cfg, device, rows=None):
    """(ys, xs) of the whole frame, or of the rows in ``rows`` (a slice)."""
    ys = torch.arange(cfg["height"], device=device)
    if rows is not None:
        ys = ys[rows]
    xs = torch.arange(cfg["width"], device=device)
    return torch.meshgrid(ys, xs, indexing="ij")


def render_rgb(scene, cam, cfg, draws=None):
    """The (H, W, 3) image: the mean of the jittered samples (draws
    (samples, 2, H, W)) or the pixel centres."""
    ys, xs = pixels(cfg, scene["mass"].device)
    return render_pixels(scene, cam, cfg, ys, xs, draws)


def carter(x, p, E, a):
    """(lambda, eta) of photons at x (the hole's frame) with covariant
    momentum p and energy E.  With cos(theta) = z / r and sin^2(theta) =
    1 - cos^2(theta) of the Kerr-Schild r, p_theta = cot(theta) (x p_x +
    y p_y) - r sin(theta) p_z, and Q = p_theta^2 + cos^2(theta) (L_z^2 /
    sin^2(theta) - a^2 E^2), whose two terms with a pole on the axis sum
    to cos^2(theta) (r^2 + a^2)(p_x^2 + p_y^2) - 2 r cos(theta) p_z
    (x p_x + y p_y) + r^2 sin^2(theta) p_z^2."""
    r = I.ks_radius(x, a)
    c = x[..., 2] / r
    s2 = 1.0 - c * c
    lz = x[..., 0] * p[..., 1] - x[..., 1] * p[..., 0]
    radial = x[..., 0] * p[..., 0] + x[..., 1] * p[..., 1]
    k = (c * c * (r * r + a * a) * (p[..., 0] ** 2 + p[..., 1] ** 2)
         - 2.0 * r * c * p[..., 2] * radial + r * r * s2 * p[..., 2] ** 2)
    return lz / E, (k - (a * E * c) ** 2) / E ** 2


def _orbit(r, m, a):
    """(lambda_c, eta_c) of the spherical photon orbit of radius r."""
    lam = -(r ** 3 - 3.0 * m * r ** 2 + a * a * r + a * a * m) / (a * (r - m))
    eta = -(r ** 3) * (r ** 3 - 6.0 * m * r ** 2 + 9.0 * m * m * r
                       - 4.0 * a * a * m) / (a * a * (r - m) ** 2)
    return lam, eta


def critical_rho(psi, mass, a, iters=64):
    """rho_c of the Kerr critical curve at the angles psi (float64): the
    spherical photon orbit between the prograde and retrograde equatorial
    ones whose (lambda_c, eta_c) lies at angle psi, by bisection on r
    (psi_c rises with r)."""
    m = mass.double()
    aa = torch.clamp(a.double().abs(), 1e-4 * float(m), (1.0 - 1e-4)
                     * float(m))
    lo = 2.0 * m * (1.0 + torch.cos(2.0 / 3.0 * torch.arccos(-aa / m)))
    hi = 2.0 * m * (1.0 + torch.cos(2.0 / 3.0 * torch.arccos(aa / m)))
    lo, hi = lo.expand(psi.shape).clone(), hi.expand(psi.shape).clone()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        lam, eta = _orbit(mid, m, aa)
        below = torch.atan2(torch.sqrt(torch.clamp_min(eta, 0.0)), lam) < psi
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    lam, eta = _orbit(0.5 * (lo + hi), m, aa)
    return torch.sqrt(torch.clamp_min(eta, 0.0) + lam * lam)


def critical_weights(scene, cam, cfg, ys, xs, band):
    """0/1 weights that leave out the rays within ``band`` of the Kerr
    critical curve, |rho / rho_c - 1| <= band, from the pixel-centre rays;
    rays with eta < 0 are kept; no gradient."""
    with torch.no_grad():
        o, d = generate_rays(cam, cfg["width"], cfg["height"], ys, xs)
        o_rel = o - scene["loc"]
        a = scene["spin"]
        p0, e0 = I.null_init(o_rel, d, scene["mass"], a)
        lam, eta = carter(o_rel, p0, e0, a)
        lam, eta = lam.double(), eta.double()
        if float(a) < 0:
            lam = -lam
        eta0 = torch.clamp_min(eta, 0.0)
        rho_c = critical_rho(torch.atan2(torch.sqrt(eta0), lam),
                             scene["mass"], a)
        ratio = torch.sqrt(eta0 + lam * lam) / rho_c
        w = (torch.abs(ratio - 1.0) > band) | (eta < 0)
        return w.to(o.dtype)


def step_loss_and_grads(build, params, cfg, target, draws, mask_band,
                        block_rows, segment):
    """The masked mean-squared error of the frame that ``build(params)``
    gives against ``target`` (H, W, 3), and its gradients to each tensor
    of ``params``, summed over row blocks, each integrated in checkpointed
    pieces of ``segment`` steps: (loss, {name: gradient})."""
    leaves = list(params.values())
    grads = [torch.zeros_like(p) for p in leaves]
    with torch.no_grad():
        scene, cam = build(params)
        ys, xs = pixels(cfg, target.device)
        w = (critical_weights(scene, cam, cfg, ys, xs, mask_band)
             if mask_band is not None
             else torch.ones(ys.shape, dtype=target.dtype,
                             device=target.device))
        denom = torch.clamp_min(torch.sum(w), 1.0) * 3.0
    loss = 0.0
    h = cfg["height"]
    for r0 in range(0, h, block_rows):
        rows = slice(r0, min(r0 + block_rows, h))
        scene, cam = build(params)
        yb, xb = pixels(cfg, target.device, rows)
        rgb = render_pixels(scene, cam, cfg, yb, xb,
                            None if draws is None else draws[:, :, rows],
                            segment)
        part = torch.sum(w[rows][..., None] * (rgb - target[rows]) ** 2) \
            / denom
        gs = torch.autograd.grad(part, leaves, allow_unused=True)
        for acc, g in zip(grads, gs):
            if g is not None:
                acc += g
        loss = loss + float(part.detach())
    return loss, dict(zip(params, grads))


def clip_by_global_norm(grads, clip):
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    return {k: torch.where(norm < clip, g, g / norm * clip)
            for k, g in grads.items()}


class Adam:
    """torch.optim.Adam's update, written out: moments, bias corrections,
    p -= lr / bc1 * m / (sqrt(v) / sqrt(bc2) + eps).  ``state`` ({name:
    (m, v, steps taken)}) resumes from moments that another optimizer
    kept."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8,
                 state=None):
        self.lr, self.betas, self.eps, self.t = lr, betas, eps, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        for k, (m, v, t) in (state or {}).items():
            self.m[k], self.v[k], self.t = m.clone(), v.clone(), int(t)

    def step(self, params, grads):
        b1, b2 = self.betas
        self.t += 1
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1.0 - b1) * g
            self.v[k] = b2 * self.v[k] + (1.0 - b2) * g * g
            denom = torch.sqrt(self.v[k]) / math.sqrt(bc2) + self.eps
            out[k] = (p - self.lr / bc1 * self.m[k] / denom).detach() \
                .requires_grad_(True)
        return out
