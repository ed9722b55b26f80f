"""The CUDA kernels of the PyTorch port against their plain PyTorch versions:
rk4_fwd, rk4_ckpt and rk4_bwd, and the adaptive Dormand-Prince dopri_fwd,
dopri_ckpt and dopri_bwd, event-free and with disk and sphere events,
Schwarzschild and Kerr, photons and massive particles, and renders --
multisampled and progressive too -- and their gradients through them;
the Stokes frame, the Schwarzschild polarization map, the Gen-1 hybrid
(its pre-set rays through rk4_fwd bit for bit) and its surrogate table;
the texture backward tex_bwd; the shading kernels shade_fwd and
shade_bwd against autograd of the plain shading; the Trainer's Kerr
critical-curve mask on the card.

Needs a CUDA device and nvcc, and skips without them (decided in a fixture
when each test runs, never at import).  This file imports
nothing of JAX, so it also runs where JAX is not installed; the tests'
``conftest.py`` imports JAX, so there run it without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparison at the flagship's full size.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import blackhole_geodesic_calculator_tpu_torch as P  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import _build, cuda_kernel  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import integrate as tint  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import states  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.models.kerr import horizon_radius  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import geodesic as tgeo  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops.geodesic import null_init  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.scene import texture  # noqa: E402
import shade_cases  # noqa: E402
import torch_particles  # noqa: E402


@pytest.fixture(autouse=True)
def _needs_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

# Statuses equal; x and lam within 1e-3, p within 1e-4, final directions
# within 1e-4 rad (an eighth of the flagship's 7.8e-4 rad pixel).  Both
# sides are float32 and differ by rsqrtf and fused multiply-adds.
TOL_X, TOL_P, TOL_DIR = 1e-3, 1e-4, 1e-4
# Gradients, kernels against autograd of the plain loop: largest |diff| over
# largest |value|, per cotangent (x, p, E, mass) and, for a whole render,
# per parameter (mass, camera position, sky).
TOL_GRAD = 1e-3
TOL_RENDER_GRAD = 1e-3
FLAGSHIP = dict(n_steps=100, dt=0.12, dt_boost=64.0, dt_boost_r_ref=1.7,
                dt_power=1.5)
DEV = torch.device("cuda")


def env():
    return tint.GeodesicEnv(
        mass=torch.tensor(0.5, device=DEV),
        r_capture=torch.tensor(1.0, device=DEV),
        r_escape=torch.tensor(70.0, device=DEV),
        lam_max=torch.tensor(100.0, device=DEV))


def events_env(e, center=((2.0, 0.0, 10.0), (-7.0, 1.0, 0.5)),
               radius=(3.0, 0.6)):
    """``e`` with the z = 0 disk (r_in 2, r_out 6) and two spheres: the one
    of tests/test_pallas.py's make_env and a moon at radius 7."""
    return dataclasses.replace(
        e, disk=tint.DiskGeom(r_in=torch.tensor(2.0, device=DEV),
                              r_out=torch.tensor(6.0, device=DEV)),
        spheres=tint.SphereGeom(
            center=torch.tensor(center, device=DEV),
            radius=torch.tensor(radius, device=DEV)))


def fan(n=1500, n_inside=36):
    """The bench's camera fan (b in [1.5, 2.45] u [2.75, 12] at z = 25,
    direction -z) plus ``n_inside`` rays that start inside the horizon."""
    b = np.concatenate([np.linspace(1.5, 2.45, n // 2),
                        np.linspace(2.75, 12.0, n - n // 2)])
    ang = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    x0 = np.stack([b * np.cos(ang), b * np.sin(ang), np.full(n, 25.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))
    rng = np.random.default_rng(7)
    xin = rng.uniform(-0.5, 0.5, (n_inside, 3))
    din = rng.normal(size=(n_inside, 3))
    din /= np.linalg.norm(din, axis=-1, keepdims=True)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEV)  # noqa
    return f(np.concatenate([x0, xin])), f(np.concatenate([d0, din]))


@pytest.mark.parametrize("power", [1.5, 1.0, 2.0, 1.3])
def test_kernel_matches_plain_on_cuda(power):
    e = env()
    x0, d0 = fan()
    cfg = tint.IntegratorConfig(**{**FLAGSHIP, "dt_power": power})
    before = counts()
    sk = tint.launch(e, x0, d0, cfg)
    sp = tint.launch(e, x0, d0, dataclasses.replace(cfg, backend="torch"))
    assert launched(before) == {"rk4_fwd": 1}
    assert torch.equal(sk.status, sp.status)
    inside = sk.status == states.INSIDE_HORIZON
    assert int(inside.sum()) == 36
    assert torch.equal(sk.x[inside], x0[inside])
    assert float((sk.x - sp.x).abs().max()) <= TOL_X
    assert float((sk.lam - sp.lam).abs().max()) <= TOL_X
    assert float((sk.p - sp.p).abs().max()) <= TOL_P
    chord = (tint.final_direction(e, sk)
             - tint.final_direction(e, sp)).norm(dim=-1).double()
    assert float((2 * torch.asin((chord / 2).clamp(max=1))).max()) <= TOL_DIR


def counts():
    """A copy of ops/cuda_kernel.py's launch counts."""
    return dict(cuda_kernel.LAUNCHES)


TEXTURE_KERNELS = ("tex_bwd", "tex_bwd_dtex")


def _kind(name):
    if name.startswith("shade_"):
        return "shading"
    return "texture" if name in TEXTURE_KERNELS else "integrator"


def launched(before, texture=False, shading=False):
    """The launches of each integrator kernel variant since ``before``
    (counts()); with ``texture``, of the texture backward's instead, with
    ``shading`` of the shading kernels'."""
    want = "shading" if shading else "texture" if texture else "integrator"
    now = cuda_kernel.LAUNCHES
    return {k: now[k] - before.get(k, 0) for k in now
            if now[k] != before.get(k, 0) and _kind(k) == want}


def initial_state(e, x0, d0):
    p0, E0 = null_init(x0, d0, e.mass)
    s0 = states.init_state(x0, p0, E0)
    s0.status = s0.status.masked_fill(x0.norm(dim=-1) <= e.r_capture,
                                      states.INSIDE_HORIZON)
    return s0


@pytest.mark.parametrize("power", [1.5, 1.0, 2.0, 1.3])
def test_ckpt_matches_fwd_and_the_plain_loop(power):
    """rk4_ckpt's final state equals rk4_fwd's (the same step code), and its
    checkpoint rows hold the plain loop's states before steps 0, seg, ...;
    60 steps leave a partial last segment (60 = 3 x 16 + 12)."""
    e = env()
    s0 = initial_state(e, *fan())
    cfg = tint.IntegratorConfig(**{**FLAGSHIP, "dt_power": power,
                                   "n_steps": 60})
    scal = cuda_kernel._scalars(e, cfg, DEV)
    seg = cuda_kernel.segment(cfg.n_steps)
    args = (scal, s0.x, s0.p, s0.E, s0.lam, s0.status)
    before = counts()
    fwd = cuda_kernel.rk4_fwd(*args, cfg.n_steps, power)
    *fin, (cx, cp, clam, cst, live) = cuda_kernel.rk4_ckpt(
        *args, cfg.n_steps, seg, power)
    assert launched(before) == {"rk4_fwd": 1, "rk4_ckpt": 1}
    for a, b in zip(fin, fwd):
        assert torch.equal(a, b)
    assert torch.equal(live, cuda_kernel.live_segments(cst))
    _, rows = cuda_kernel.integrate_ckpt_plain(e, s0, cfg, seg)
    assert cx.shape[0] == len(rows) == 4
    for k, row in enumerate(rows):
        assert torch.equal(cst[k], row.status)
        assert float((cx[k] - row.x).abs().max()) <= TOL_X
        assert float((cp[k] - row.p).abs().max()) <= TOL_P
        assert float((clam[k] - row.lam).abs().max()) <= TOL_X


def cotangents(e, s0, cfg, wx, kernel):
    """Cotangents of (x, p, E) and the mass for the loss of
    tests/test_pallas.py:82-92, through the kernels or the plain loop."""
    mass = e.mass.clone().requires_grad_(True)
    ee = dataclasses.replace(e, mass=mass)
    x, p, E = (t.clone().requires_grad_(True) for t in (s0.x, s0.p, s0.E))
    s = dataclasses.replace(s0, x=x, p=p, E=E)
    out = (cuda_kernel.integrate_cuda(ee, s, cfg) if kernel
           else cuda_kernel.integrate_plain(ee, s, cfg))
    ok = (out.status != states.CAPTURED) & (out.status != states.ERROR)
    torch.where(ok[..., None], wx * out.x, 0.0).sum().backward()
    return x.grad, p.grad, E.grad, mass.grad


@pytest.mark.parametrize("power,n_steps", [(1.5, 100), (1.5, 40), (1.0, 100),
                                           (2.0, 100), (1.3, 100)])
def test_bwd_matches_autograd_of_the_plain_loop(power, n_steps):
    """rk4_bwd's cotangents against autograd of the plain loop; at 40 steps
    rays are still ACTIVE at the end of a partial last segment."""
    e = env()
    s0 = initial_state(e, *fan())
    cfg = tint.IntegratorConfig(**{**FLAGSHIP, "dt_power": power,
                                   "n_steps": n_steps})
    wx = torch.as_tensor(np.random.default_rng(2).normal(size=(1536, 3)),
                         dtype=torch.float32, device=DEV)
    before = counts()
    gk = cotangents(e, s0, cfg, wx, kernel=True)
    assert launched(before) == {"rk4_ckpt": 1, "rk4_bwd": 1}
    gp = cotangents(e, s0, cfg, wx, kernel=False)
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max() / b.abs().max()) <= TOL_GRAD


def test_bwd_is_deterministic():
    """The scalar cotangents are summed without atomics: two backward
    passes give the same bits."""
    e = env()
    s0 = initial_state(e, *fan())
    cfg = tint.IntegratorConfig(**FLAGSHIP)
    wx = torch.ones_like(s0.x)
    g1 = cotangents(e, s0, cfg, wx, kernel=True)
    g2 = cotangents(e, s0, cfg, wx, kernel=True)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def plain_shading():
    """Within the block, render_rays shades through the plain path,
    final_direction + shade, as the CPU does: the reference of a render's
    whole kernel path."""
    from unittest import mock

    from blackhole_geodesic_calculator_tpu_torch.render import renderer
    from blackhole_geodesic_calculator_tpu_torch.scene import shading

    return mock.patch.object(renderer, "shade_rays", lambda env, scene, s: (
        shading.shade(scene, s, tint.final_direction(env, s))))


def test_render_gradient_launches_ckpt_and_bwd():
    """A 32x32 flagship frame's gradient goes through rk4_ckpt and rk4_bwd
    once each, never rk4_fwd, and its shading through shade_fwd and
    shade_bwd once each, the sky's texture cotangent through their scatter
    (never tex_bwd); it agrees with the plain path (the plain integrator
    and the plain shading)."""
    v, u = np.meshgrid(np.arange(256), np.arange(512), indexing="ij")
    sky = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * u / 512)
                    * np.sin(np.pi * v / 256), v / 256,
                    ((u // 16 + v // 16) % 2).astype(np.float32)], -1)
    cfg = P.RenderConfig(width=32, height=32, lam_max=100.0,
                         integrator=P.IntegratorConfig(**FLAGSHIP))

    def grads(c):
        scene = P.Scene(bh=P.BlackHole.make(mass=0.5, device=DEV),
                        background=torch.as_tensor(sky, dtype=torch.float32,
                                                   device=DEV))
        cam = P.Camera.make(position=(0.0, 0.0, 25.0), fov=(0.8, 0.8),
                            device=DEV)
        leaves = (scene.bh.mass, cam.position, scene.background)
        for t in leaves:
            t.requires_grad_(True)
        P.render_image(scene, cam, c)[..., :3].pow(2).mean().backward()
        return [t.grad for t in leaves]

    before = counts()
    gk = grads(cfg)
    assert launched(before) == {"rk4_ckpt": 1, "rk4_bwd": 1}
    assert launched(before, texture=True) == {}
    assert launched(before, shading=True) == SHADE_STEP
    with plain_shading():
        gp = grads(dataclasses.replace(cfg, integrator=dataclasses.replace(
            cfg.integrator, backend="torch")))
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max() / b.abs().max()) <= TOL_RENDER_GRAD


# jax.vjp of the JAX package's sample_bpy on the inputs of
# tests/test_torch_grad.py::test_sample_bpy_backward_matches_jax, written by
# tests/test_torch_grad.py::test_sample_bpy_backward_golden on the CPU
TEX_GOLDEN = Path(__file__).parent / "golden" / "sample_bpy_backward.npz"


@pytest.mark.parametrize("where", ["interior", "seam", "poles"])
def test_tex_bwd_matches_plain(where):
    """csrc/tex_bwd.cu, through sample_bpy's backward on the card, against
    jax.vjp of the JAX sample_bpy (TEX_GOLDEN) within 1e-5 of the largest
    |value|, as the CPU path is held; its dtex bit for bit against the
    fixed-point sum at cuda_kernel.tex_bwd_exponent's scale; against
    sample_bpy_bwd_plain: dx and dy within two ulp of their largest value
    (the channels may add in another order), dtex within 1e-5 of its
    largest value (the plain path's float32 sums of about 1,000 terms a
    texel); two runs bit for bit; NaN and infinite g entries give
    non-finite texels where the plain path's are; one launch a call."""
    with np.load(TEX_GOLDEN) as z:
        tex, x, y, g, jtex, jx, jy = (
            torch.as_tensor(z[f"{where}_{k}"], device=DEV)
            for k in ("tex", "x", "y", "g", "dtex", "dx", "dy"))
    leaves = [t.clone().requires_grad_(True) for t in (tex, x, y)]
    out = texture.sample_bpy(*leaves)
    saved = out.grad_fn.saved_tensors
    before = counts()
    out.backward(g)
    assert launched(before, texture=True) == {"tex_bwd_dtex": 1}
    for got, want in zip((leaf.grad for leaf in leaves), (jtex, jx, jy)):
        assert float((got - want).abs().max()
                     / want.abs().max().clamp(min=1e-30)) <= 1e-5
    # the same sum in int64 at the host mirror's scale
    _, _, _, _, tx, ty, xi0, xi1, yi0, yi1 = saved
    h, w, nc = tex.shape
    k = cuda_kernel.tex_bwd_exponent(float(g.abs().max()), x.numel())
    acc = torch.zeros(h * w * nc, dtype=torch.int64, device=DEV)
    txe, tye = tx[:, None], ty[:, None]
    for yi, xi, wgt in ((yi0, xi0, (1.0 - txe) * (1.0 - tye)),
                        (yi0, xi1, txe * (1.0 - tye)),
                        (yi1, xi0, (1.0 - txe) * tye), (yi1, xi1, txe * tye)):
        idx = ((yi * w + xi)[:, None] * nc + torch.arange(nc, device=DEV))
        acc.index_add_(0, idx.reshape(-1), torch.round(
            (g * wgt).reshape(-1).double() * 2.0 ** k).to(torch.int64))
    fixed = (acc.double() * 2.0 ** -k).float().reshape(h, w, nc)
    assert torch.equal(leaves[0].grad.view(torch.int32),
                       fixed.view(torch.int32))
    # against the plain path, with NaN and infinite entries of g
    g = g.clone()
    g[::97, 1] = float("nan")
    g[5::89, 0] = float("inf")
    before = counts()
    got = cuda_kernel.tex_bwd(*saved, g, tex.shape, True)
    again = cuda_kernel.tex_bwd(*saved, g, tex.shape, True)
    assert launched(before, texture=True) == {"tex_bwd_dtex": 2}
    want = texture.sample_bpy_bwd_plain(*saved, g, tex.shape, True)
    for a, b, c, tol in zip(got, again, want, (1e-5, 2 ** -22, 2 ** -22)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(torch.isnan(a), torch.isnan(c))
        assert torch.equal(torch.isinf(a), torch.isinf(c))
        fin = torch.isfinite(c)
        assert float((a - c)[fin].abs().max()
                     / c[fin].abs().max().clamp(min=1e-30)) <= tol


def test_render_image_launches_the_kernel():
    """A 32x32 render at the flagship config goes through the kernel once
    and agrees with the plain render by the golden rule."""
    v, u = np.meshgrid(np.arange(256), np.arange(512), indexing="ij")
    sky = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * u / 512)
                    * np.sin(np.pi * v / 256), v / 256,
                    ((u // 16 + v // 16) % 2).astype(np.float32)], -1)
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, device=DEV),
                    background=torch.as_tensor(sky, dtype=torch.float32,
                                               device=DEV))
    cam = P.Camera.make(position=(0.0, 0.0, 25.0), fov=(0.8, 0.8),
                        device=DEV)
    cfg = P.RenderConfig(width=32, height=32, lam_max=100.0,
                         integrator=P.IntegratorConfig(**FLAGSHIP))
    before = counts()
    img = P.render_image(scene, cam, cfg)
    assert launched(before) == {"rk4_fwd": 1}
    plain = P.render_image(scene, cam, dataclasses.replace(
        cfg, integrator=dataclasses.replace(cfg.integrator,
                                            backend="torch")))
    assert img.shape == (32, 32, 4) and bool(torch.isfinite(img).all())
    diff = (img - plain).abs()
    assert float(diff.mean()) < 2e-3
    assert float((diff > 0.1).float().mean()) < 0.01


# =============================================================================
# The event variants (a z = 0 disk and spheres).
# =============================================================================
def event_rays():
    """The fan and tests/test_pallas.py's rays (from z = 25 across the
    disk and the spheres)."""
    rng = np.random.default_rng(0)
    n = 1500
    x0 = np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                   np.full(n, 25.0)], -1)
    d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  np.full(n, -1.0)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xf, df = fan()
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEV)  # noqa
    return torch.cat([xf, f(x0)]), torch.cat([df, f(d)])


def assert_event_states_agree(sk, sp):
    assert torch.equal(sk.status, sp.status)
    assert torch.equal(sk.hit_obj, sp.hit_obj)
    for st in (states.DISK, states.OBJECT):
        assert int((sk.status == st).sum()) >= 20
    assert float((sk.x - sp.x).abs().max()) <= TOL_X
    assert float((sk.lam - sp.lam).abs().max()) <= TOL_X
    assert float((sk.p - sp.p).abs().max()) <= TOL_P


@pytest.mark.parametrize("power", [1.5, 1.0, 2.0, 1.3])
def test_event_kernel_matches_plain_on_cuda(power):
    """rk4_fwd's event variant against the plain loop: statuses and hit
    ids equal, states within tolerance; the event-free counter stays."""
    e = events_env(env())
    x0, d0 = event_rays()
    cfg = tint.IntegratorConfig(**{**FLAGSHIP, "dt_power": power})
    before = counts()
    sk = tint.launch(e, x0, d0, cfg)
    sp = tint.launch(e, x0, d0, dataclasses.replace(cfg, backend="torch"))
    assert launched(before) == {"rk4_fwd_events": 1}
    assert_event_states_agree(sk, sp)
    assert set(sk.hit_obj.tolist()) == {-1, 0, 1}


def test_event_ckpt_matches_fwd_and_the_plain_loop():
    """rk4_ckpt's event variant: its final state (hit ids included) equals
    rk4_fwd's bit for bit, and its checkpoint rows hold the plain loop's
    states; 60 steps leave a partial last segment."""
    e = events_env(env())
    s0 = initial_state(e, *event_rays())
    cfg = tint.IntegratorConfig(**{**FLAGSHIP, "n_steps": 60})
    scal = cuda_kernel._scalars(e, cfg, DEV)
    sph = cuda_kernel._sphere_table(e, DEV)
    seg = cuda_kernel.segment(cfg.n_steps)
    args = (scal, s0.x, s0.p, s0.E, s0.lam, s0.status)
    kw = dict(sph=sph, has_disk=True, obj=s0.hit_obj)
    before = counts()
    fwd = cuda_kernel.rk4_fwd(*args, cfg.n_steps, 1.5, **kw)
    *fin, (cx, cp, clam, cst, live) = cuda_kernel.rk4_ckpt(
        *args, cfg.n_steps, seg, 1.5, **kw)
    assert launched(before) == {"rk4_fwd_events": 1, "rk4_ckpt_events": 1}
    for a, b in zip(fin, fwd):
        assert torch.equal(a, b)
    assert torch.equal(live, cuda_kernel.live_segments(cst))
    assert int((fin[3] == states.OBJECT).sum()) >= 20
    _, rows = cuda_kernel.integrate_ckpt_plain(e, s0, cfg, seg)
    for k, row in enumerate(rows):
        assert torch.equal(cst[k], row.status)
        assert float((cx[k] - row.x).abs().max()) <= TOL_X
        assert float((cp[k] - row.p).abs().max()) <= TOL_P
        assert float((clam[k] - row.lam).abs().max()) <= TOL_X


def event_cotangents(s0, cfg, wx, kernel):
    """Cotangents of (x, p, E), the mass, the sphere centres and radii for
    the loss of tests/test_pallas.py:82-92, through the kernels or the
    plain loop."""
    e = events_env(env())
    mass = e.mass.clone().requires_grad_(True)
    center = e.spheres.center.clone().requires_grad_(True)
    radius = e.spheres.radius.clone().requires_grad_(True)
    ee = dataclasses.replace(e, mass=mass, spheres=tint.SphereGeom(
        center=center, radius=radius))
    x, p, E = (t.clone().requires_grad_(True) for t in (s0.x, s0.p, s0.E))
    s = dataclasses.replace(s0, x=x, p=p, E=E)
    out = (cuda_kernel.integrate_cuda(ee, s, cfg) if kernel
           else cuda_kernel.integrate_plain(ee, s, cfg))
    ok = (out.status != states.CAPTURED) & (out.status != states.ERROR)
    torch.where(ok[..., None], wx * out.x, 0.0).sum().backward()
    return x.grad, p.grad, E.grad, mass.grad, center.grad, radius.grad


@pytest.mark.parametrize("power,n_steps", [(1.5, 100), (1.5, 40), (1.0, 100),
                                           (2.0, 100), (1.3, 100)])
def test_event_bwd_matches_autograd_of_the_plain_loop(power, n_steps):
    """rk4_bwd's event variant against autograd of the plain loop,
    including the sphere cotangent; at 40 steps rays are still ACTIVE at
    the end of a partial last segment."""
    e = events_env(env())
    s0 = initial_state(e, *event_rays())
    cfg = tint.IntegratorConfig(**{**FLAGSHIP, "dt_power": power,
                                   "n_steps": n_steps})
    wx = torch.as_tensor(np.random.default_rng(2).normal(size=(3036, 3)),
                         dtype=torch.float32, device=DEV)
    before = counts()
    gk = event_cotangents(s0, cfg, wx, kernel=True)
    assert launched(before) == {"rk4_ckpt_events": 1, "rk4_bwd_events": 1}
    gp = event_cotangents(s0, cfg, wx, kernel=False)
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max() / b.abs().max()) <= TOL_GRAD


def test_event_bwd_is_deterministic():
    """The sphere cotangent, like the scalar ones, is summed without
    atomics: two backward passes give the same bits."""
    e = events_env(env())
    s0 = initial_state(e, *event_rays())
    cfg = tint.IntegratorConfig(**FLAGSHIP)
    wx = torch.ones_like(s0.x)
    g1 = event_cotangents(s0, cfg, wx, kernel=True)
    g2 = event_cotangents(s0, cfg, wx, kernel=True)
    assert float(g1[4].abs().max()) > 0
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def events_scene(spin=None):
    """bench.py's make_scene('events', spin=spin) (:111-141): the flagship
    sky, a z = 0 disk (r_in 2, r_out 6) and four one-colour moons."""
    v, u = np.meshgrid(np.arange(256), np.arange(512), indexing="ij")
    sky = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * u / 512)
                    * np.sin(np.pi * v / 256), v / 256,
                    ((u // 16 + v // 16) % 2).astype(np.float32)], -1)
    vv, uu = np.meshgrid(np.arange(64), np.arange(256), indexing="ij")
    disk_tex = np.stack([0.9 + 0 * uu, 0.5 + 0.3 * np.sin(8 * np.pi * uu / 256),
                         0.2 + 0 * uu], -1)
    ang = np.array([0.3, 1.9, 3.6, 5.2])
    centers = np.stack([7 * np.cos(ang), 7 * np.sin(ang),
                        0.8 * np.sin(2 * ang)], -1)
    return P.Scene(
        bh=P.BlackHole.make(mass=0.5, spin=spin, device=DEV),
        background=torch.as_tensor(sky, dtype=torch.float32, device=DEV),
        disk=P.Disk.make(r_in=2.0, r_out=6.0, texture=disk_tex, device=DEV),
        spheres=P.Spheres.make(
            center=centers, radius=[0.6, 0.5, 0.7, 0.4], device=DEV,
            texture=np.tile(np.float32([0.3, 0.9, 0.4]), (4, 16, 32, 1))))


def events_cam():
    """bench.py's camera for the events rows (:1023-1027)."""
    return P.Camera.make(position=(0.0, 0.0, 25.0), euler=(0.25, 0.0, 0.0),
                         fov=(0.8, 0.8), device=DEV)


def test_events_render_launches_the_event_variants():
    """A 32x32 frame of bench.py's events scene renders through rk4_fwd's
    event variant alone, and its gradient through those of rk4_ckpt and
    rk4_bwd; both agree with the plain path."""
    cfg = P.RenderConfig(width=32, height=32, lam_max=100.0,
                         integrator=P.IntegratorConfig(**FLAGSHIP))
    scene, cam = events_scene, events_cam()
    plain = dataclasses.replace(cfg, integrator=dataclasses.replace(
        cfg.integrator, backend="torch"))

    before = counts()
    with torch.no_grad():
        img = P.render_image(scene(), cam, cfg)
    assert launched(before) == {"rk4_fwd_events": 1}
    diff = (img - P.render_image(scene(), cam, plain)).abs()
    assert float(diff.mean()) < 2e-3
    assert float((diff > 0.1).float().mean()) < 0.01

    def grads(c):
        sc = scene()
        leaves = (sc.bh.mass, cam.position.clone(), sc.background,
                  sc.disk.texture)
        for t in leaves:
            t.requires_grad_(True)
        c_cam = dataclasses.replace(cam, position=leaves[1])
        P.render_image(sc, c_cam, c)[..., :3].pow(2).mean().backward()
        return [t.grad for t in leaves]

    before = counts()
    gk = grads(cfg)
    assert launched(before) == {"rk4_ckpt_events": 1, "rk4_bwd_events": 1}
    gp = grads(plain)
    # mass and camera: the frame's gradient to them is a sum of parts of
    # both signs that float32 moves (a reading of 1.4e-2 for the mass on
    # an H100); the sky and the disk texture are per texel
    for a, b, tol in zip(gk, gp, (5e-2, 5e-2, 1e-2, 1e-2)):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max() / b.abs().max()) <= tol


# =============================================================================
# The Kerr variants.
# =============================================================================
def kerr_env(spin, events):
    """A hole of spin ``spin`` (capture at its outer horizon), with the
    disk and the two spheres of events_env when ``events``."""
    e = env()
    e.spin = torch.tensor(spin, device=DEV)
    e.r_capture = horizon_radius(e.mass, e.spin)
    return events_env(e) if events else e


def kerr_rays(spin, n=3000):
    """Rays from z = 25 along -z at distances b in [1.5, 9] from the axis
    (across the disk and the spheres), leaving out b within 0.5 M of the
    critical sky radius of such rays (L_z = 0): sqrt(eta + a^2) at the
    spherical photon orbit r^3 - 3 M r^2 + a^2 r + a^2 M = 0, M = 0.5,
    where rays circle and two correct float32 paths part (chip_smoke.py
    KERR_BAND)."""
    m, a2 = 0.5, spin * spin
    r = max(z.real for z in np.roots([1.0, -3.0 * m, a2, a2 * m])
            if abs(z.imag) < 1e-9 and z.real > m)
    eta = -r ** 3 * (r ** 3 - 6 * m * r * r + 9 * m * m * r - 4 * a2 * m) / (
        a2 * (r - m) ** 2)
    rho_c = np.sqrt(eta + a2)
    rng = np.random.default_rng(4)
    b = rng.uniform(1.5, 9.0, 2 * n)
    b = b[np.abs(b - rho_c) > 0.5 * m][:n]
    ang = rng.uniform(0.0, 2 * np.pi, n)
    x0 = np.stack([b * np.cos(ang), b * np.sin(ang), np.full(n, 25.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))
    f = lambda v: torch.as_tensor(v, dtype=torch.float32, device=DEV)  # noqa
    return f(x0), f(d0)


def kerr_dp(pk, pp):
    """Largest |dp| of a Kerr hole's momenta, relative to max(1, |p|): its
    captured rays end with |p| up to 5.5 (chip_smoke.py holds it so)."""
    return float(((pk - pp).abs()
                  / pp.norm(dim=-1, keepdim=True).clamp_min(1.0)).max())


def kerr_state(e, x0, d0):
    p0, E0 = null_init(x0, d0, e.mass, e.spin)
    s0 = states.init_state(x0, p0, E0)
    s0.status = s0.status.masked_fill(e.radius(x0) <= e.r_capture,
                                      states.INSIDE_HORIZON)
    return s0


@pytest.mark.parametrize("spin,events", [(0.45, False), (0.45, True),
                                         (-0.3, False), (-0.3, True)])
def test_kerr_kernel_matches_plain_on_cuda(spin, events):
    """rk4_fwd's Kerr variant against the plain Kerr loop: statuses and hit
    ids equal, states within tolerance; only the Kerr counter moves."""
    e = kerr_env(spin, events)
    s0 = kerr_state(e, *kerr_rays(spin))
    cfg = tint.IntegratorConfig(**FLAGSHIP)
    before = counts()
    with torch.no_grad():
        sk = cuda_kernel.integrate_cuda(e, s0, cfg)
        sp = cuda_kernel.integrate_plain(e, s0, cfg)
    assert launched(before) == {cuda_kernel.variant("rk4_fwd", True,
                                                    events): 1}
    assert torch.equal(sk.status, sp.status)
    assert torch.equal(sk.hit_obj, sp.hit_obj)
    assert float((sk.x - sp.x).abs().max()) <= TOL_X
    assert float((sk.lam - sp.lam).abs().max()) <= TOL_X
    assert kerr_dp(sk.p, sp.p) <= TOL_P
    if events:
        for st in (states.DISK, states.OBJECT):
            assert int((sk.status == st).sum()) >= 20


@pytest.mark.parametrize("spin", [0.45, -0.3])
def test_kerr_ckpt_matches_fwd_and_the_plain_loop(spin):
    """rk4_ckpt's Kerr variant: its final state equals rk4_fwd's Kerr
    variant bit for bit and its checkpoint rows hold the plain loop's
    states; 60 steps leave a partial last segment."""
    e = kerr_env(spin, True)
    s0 = kerr_state(e, *event_rays())
    cfg = tint.IntegratorConfig(**{**FLAGSHIP, "n_steps": 60})
    scal = cuda_kernel._scalars(e, cfg, DEV)
    seg = cuda_kernel.segment(cfg.n_steps)
    kw = dict(sph=cuda_kernel._sphere_table(e, DEV), has_disk=True,
              obj=s0.hit_obj, kerr=True)
    args = (scal, s0.x, s0.p, s0.E, s0.lam, s0.status)
    fwd = cuda_kernel.rk4_fwd(*args, cfg.n_steps, 1.5, **kw)
    *fin, (cx, cp, clam, cst, live) = cuda_kernel.rk4_ckpt(
        *args, cfg.n_steps, seg, 1.5, **kw)
    for a, b in zip(fin, fwd):
        assert torch.equal(a, b)
    assert torch.equal(live, cuda_kernel.live_segments(cst))
    _, rows = cuda_kernel.integrate_ckpt_plain(e, s0, cfg, seg)
    for k, row in enumerate(rows):
        assert torch.equal(cst[k], row.status)
        assert float((cx[k] - row.x).abs().max()) <= TOL_X
        assert kerr_dp(cp[k], row.p) <= TOL_P


def kerr_cotangents(spin, events, s0, cfg, wx, kernel):
    """Cotangents of (x, p, E), the mass and the spin (and with events the
    sphere centres and radii) for the loss of tests/test_pallas.py:82-92."""
    e = kerr_env(spin, events)
    mass = e.mass.clone().requires_grad_(True)
    a = e.spin.clone().requires_grad_(True)
    ee = dataclasses.replace(e, mass=mass, spin=a)
    leaves = [mass, a]
    if events:
        center = e.spheres.center.clone().requires_grad_(True)
        radius = e.spheres.radius.clone().requires_grad_(True)
        ee.spheres = tint.SphereGeom(center=center, radius=radius)
        leaves += [center, radius]
    x, p, E = (t.clone().requires_grad_(True) for t in (s0.x, s0.p, s0.E))
    s = dataclasses.replace(s0, x=x, p=p, E=E)
    out = (cuda_kernel.integrate_cuda(ee, s, cfg) if kernel
           else cuda_kernel.integrate_plain(ee, s, cfg))
    ok = (out.status != states.CAPTURED) & (out.status != states.ERROR)
    torch.where(ok[..., None], wx * out.x, 0.0).sum().backward()
    return [t.grad for t in (x, p, E, *leaves)]


@pytest.mark.parametrize("spin,events,n_steps", [
    (0.45, False, 100), (0.45, True, 40), (-0.3, True, 100),
    (-0.3, False, 40)])
def test_kerr_bwd_matches_autograd_of_the_plain_loop(spin, events, n_steps):
    """rk4_bwd's Kerr variant against autograd of the plain Kerr loop,
    the spin cotangent included; at 40 steps rays are still ACTIVE at the
    end of a partial last segment."""
    e = kerr_env(spin, events)
    s0 = kerr_state(e, *event_rays())
    cfg = tint.IntegratorConfig(**{**FLAGSHIP, "n_steps": n_steps})
    wx = torch.as_tensor(np.random.default_rng(2).normal(size=(3036, 3)),
                         dtype=torch.float32, device=DEV)
    before = counts()
    gk = kerr_cotangents(spin, events, s0, cfg, wx, kernel=True)
    assert launched(before) == {
        cuda_kernel.variant(k, True, events): 1 for k in ("rk4_ckpt",
                                                          "rk4_bwd")}
    gp = kerr_cotangents(spin, events, s0, cfg, wx, kernel=False)
    assert float(gp[4].abs()) > 0
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max() / b.abs().max()) <= TOL_GRAD


def test_kerr_events_render_launches_the_kerr_variants():
    """A 32x32 frame of bench.py's Kerr events scene (a = 0.45) renders
    through rk4_fwd's Kerr variant alone, and its gradient through those of
    rk4_ckpt and rk4_bwd; both agree with the plain path."""
    cfg = P.RenderConfig(width=32, height=32, lam_max=100.0,
                         integrator=P.IntegratorConfig(**FLAGSHIP))
    plain = dataclasses.replace(cfg, integrator=dataclasses.replace(
        cfg.integrator, backend="torch"))
    cam = events_cam()

    def scene():
        return events_scene(spin=0.45)

    before = counts()
    with torch.no_grad():
        img = P.render_image(scene(), cam, cfg)
    assert launched(before) == {"rk4_fwd_kerr_events": 1}
    diff = (img - P.render_image(scene(), cam, plain)).abs()
    assert float(diff.mean()) < 2e-3
    assert float((diff > 0.1).float().mean()) < 0.01

    def grads(c):
        sc = scene()
        leaves = (sc.bh.mass, sc.bh.spin, sc.background)
        for t in leaves:
            t.requires_grad_(True)
        P.render_image(sc, cam, c)[..., :3].pow(2).mean().backward()
        return [t.grad for t in leaves]

    before = counts()
    gk = grads(cfg)
    assert launched(before) == {"rk4_ckpt_kerr_events": 1,
                                "rk4_bwd_kerr_events": 1}
    gp = grads(plain)
    # the mass and the spin: sums of parts of both signs that float32
    # moves, as in the Schwarzschild events frame; the sky is per texel
    for a, b, tol in zip(gk, gp, (5e-2, 5e-2, 1e-2)):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max() / b.abs().max()) <= tol


# =============================================================================
# Adaptive Dormand-Prince: dopri_fwd, dopri_ckpt, dopri_bwd.
# =============================================================================
# The holes the Dormand-Prince kernels are held on, by test id: (Kerr,
# events) -- Schwarzschild, with the disk and the spheres, Kerr, and Kerr
# with the disk and the spheres.
DOPRI_HOLES = {"dopri": (False, False), "events": (False, True),
               "spin": (True, False), "spin-events": (True, True)}
DOPRI = dict(n_steps=400, dt=0.05, method="dopri", rtol=1e-5, atol=1e-8,
             max_step=4.0)
# The reference's invariants between two implementations of the adaptive
# integrator (tests/test_pallas.py:187-206): statuses equal on >= 99.8% of
# the rays, lam within max_step, final directions within 2e-3 rad.  Two
# float32 controllers part on accept and reject where the error norm sits
# at 1 (its float32 rounding is ~1e-3 of it), and then sample the same path
# at other points.
MIN_AGREE, TOL_ANGLE = 0.998, 2e-3


def dopri_env(case):
    kerr, events = DOPRI_HOLES[case]
    return kerr_env(0.45, events) if kerr else (
        events_env(env()) if events else env())


def dopri_rays(n=1500, seed=11):
    """tests/test_pallas.py's rays(): z = 25, offsets in [-8, 8],
    directions within 0.3 of -z."""
    rng = np.random.default_rng(seed)
    x0 = np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                   np.full(n, 25.0)], -1)
    d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  np.full(n, -1.0)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEV)  # noqa
    return f(x0), f(d)


def angle(e, a, b):
    chord = (tint.final_direction(e, a)
             - tint.final_direction(e, b)).norm(dim=-1).double()
    return 2 * torch.asin((chord / 2).clamp(max=1))


@pytest.mark.parametrize("case", list(DOPRI_HOLES))
def test_dopri_kernel_matches_plain_on_cuda(case):
    """dopri_fwd against integrate_adaptive on the card: the reference's
    invariants (the directions of the rays that end on the sky), and the
    event points of the rays that end on the disk or a sphere within 1e-2
    (where the chord of the last step meets the event: two samplings of
    one path put it apart by the chords' error, 2.3e-3 on an H100); only
    the variant's counter moves."""
    e = dopri_env(case)
    s0 = kerr_state(e, *dopri_rays())
    cfg = tint.IntegratorConfig(**DOPRI)
    before = counts()
    with torch.no_grad():
        sk = tint.integrate(e, s0, cfg)
        sp, _ = tint.integrate_adaptive(e, s0, cfg)
    kerr, events = DOPRI_HOLES[case]
    assert launched(before) == {cuda_kernel.variant("dopri_fwd", kerr,
                                                    events): 1}
    same = (sk.status == sp.status) & (sk.hit_obj == sp.hit_obj)
    assert float(same.float().mean()) >= MIN_AGREE
    dlam = (sk.lam - sp.lam).abs()
    assert float(dlam[same].max()) <= DOPRI["max_step"] + 1e-3
    sky = same & ((sp.status == states.ESCAPED)
                  | (sp.status == states.BUDGET))
    assert int(sky.sum()) >= 500
    assert float(angle(e, sk, sp)[sky].max()) < TOL_ANGLE
    if events:
        for st in (states.DISK, states.OBJECT):
            hit = same & (sp.status == st)
            assert int(hit.sum()) >= 20
            assert float((sk.x - sp.x)[hit].abs().max()) <= 1e-2


@pytest.mark.parametrize("case", list(DOPRI_HOLES))
def test_dopri_ckpt_matches_fwd_and_the_plain_loop(case):
    """dopri_ckpt's final state equals dopri_fwd's bit for bit (the same
    trip code), and its checkpoint rows hold the plain trip loop's statuses
    (on >= 99.8% of the rays) and, before the first checkpoint, its h;
    90 trips leave a partial last segment (90 = 5 x 16 + 10)."""
    e = dopri_env(case)
    s0 = kerr_state(e, *dopri_rays(seed=2))
    cfg = tint.IntegratorConfig(**{**DOPRI, "n_steps": 90})
    kerr, events = DOPRI_HOLES[case]
    scal = cuda_kernel._scalars(e, cfg, DEV)
    seg = cuda_kernel.segment(cfg.n_steps)
    h = torch.full_like(s0.E, tint.dopri_h0(cfg))
    ctl = cuda_kernel.controller(cfg)
    kw = dict(sph=cuda_kernel._sphere_table(e, DEV), has_disk=events,
              obj=s0.hit_obj, kerr=kerr)
    args = (scal, s0.x, s0.p, s0.E, h, s0.lam, s0.status, cfg.n_steps)
    before = counts()
    fwd = cuda_kernel.dopri_fwd(*args, ctl, **kw)
    *fin, (cx, cp, ch, clam, cst, live) = cuda_kernel.dopri_ckpt(
        *args, seg, ctl, **kw)
    assert launched(before) == {cuda_kernel.variant(k, kerr, events): 1
                                for k in ("dopri_fwd", "dopri_ckpt")}
    for a, b in zip(fin, fwd):
        assert torch.equal(a, b)
    assert torch.equal(live, cuda_kernel.live_segments(cst))
    _, rows, hs = cuda_kernel.integrate_adaptive_ckpt_plain(e, s0, cfg, seg)
    assert cx.shape[0] == len(rows) == 6
    assert torch.equal(ch[0], hs[0])
    for k, row in enumerate(rows):
        assert float((cst[k] == row.status).float().mean()) >= MIN_AGREE
        close = (clam[k] - row.lam).abs() <= TOL_X
        assert float((cx[k] - row.x)[close].abs().max()) <= 1e-2


def weak_fan(n=640, seed=3):
    """The weak-field fan of tests/test_pallas.py's dopri gradient tests
    (:241-250): b in [6.5, 12] at z = 25, direction -z."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(6.5, 12.0, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    x0 = np.stack([b * np.cos(ang), b * np.sin(ang), np.full(n, 25.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=DEV)  # noqa
    return f(x0), f(d0), f(rng.normal(size=(n, 3)))


def dopri_cotangents(case, s0, cfg, w, kernel):
    """Cotangents of (x, p, E), the mass, (Kerr) the spin and (events) the
    sphere table for the reference's loss (tests/test_pallas.py:262-275),
    weighted event points and weighted final directions, here of every ray
    not captured (ESCAPED, BUDGET and still ACTIVE)."""
    kerr, events = DOPRI_HOLES[case]
    e = dopri_env(case)
    leaf = lambda t: t.clone().requires_grad_(True)  # noqa: E731
    ee = dataclasses.replace(e, mass=leaf(e.mass),
                             spin=leaf(e.spin) if kerr else None)
    if events:
        ee.spheres = tint.SphereGeom(center=leaf(e.spheres.center),
                                     radius=leaf(e.spheres.radius))
    x, p, E = (leaf(t) for t in (s0.x, s0.p, s0.E))
    s = dataclasses.replace(s0, x=x, p=p, E=E)
    out = (cuda_kernel.integrate_cuda(ee, s, cfg) if kernel
           else cuda_kernel.integrate_plain(ee, s, cfg))
    ev = ((out.status == states.DISK)
          | (out.status == states.OBJECT))[..., None]
    sky = ((out.status != states.CAPTURED) & (out.status != states.ERROR)
           )[..., None] & ~ev
    (torch.where(sky, w * tint.final_direction(ee, out), 0.0)
     + torch.where(ev, w * out.x, 0.0)).sum().backward()
    grads = [x.grad, p.grad, E.grad, ee.mass.grad]
    if kerr:
        grads.append(ee.spin.grad)
    if events:
        grads += [ee.spheres.center.grad, ee.spheres.radius.grad]
    return out, grads


@pytest.mark.parametrize("case,n_steps", [
    ("dopri", 96), ("dopri", 20), ("events", 96), ("spin", 80),
    ("spin-events", 20)])
def test_dopri_bwd_matches_autograd_of_the_plain_loop(case, n_steps):
    """dopri_ckpt and dopri_bwd against autograd of integrate_adaptive_scan
    on the weak-field fan: per-ray cotangents of the rays whose lam agrees
    (the same trips) and the scalar and sphere cotangents, to the
    reference's 5e-2; at 20 trips rays are still ACTIVE at the end."""
    kerr, events = DOPRI_HOLES[case]
    e = dopri_env(case)
    x0, d0, w = weak_fan()
    s0 = kerr_state(e, x0, d0)
    cfg = tint.IntegratorConfig(**{**DOPRI, "n_steps": n_steps})
    before = counts()
    out_k, gk = dopri_cotangents(case, s0, cfg, w, kernel=True)
    assert launched(before) == {cuda_kernel.variant(k, kerr, events): 1
                                for k in ("dopri_ckpt", "dopri_bwd")}
    out_p, gp = dopri_cotangents(case, s0, cfg, w, kernel=False)
    if n_steps == 20:
        assert int((out_p.status == states.ACTIVE).sum()) > 0
    same = (out_k.lam - out_p.lam).abs() <= TOL_X
    for i, (a, b) in enumerate(zip(gk, gp)):
        assert torch.isfinite(a).all()
        if i < 3:
            a, b = a[same], b[same]
        assert float((a - b).abs().max() / b.abs().max()) <= 5e-2


def test_dopri_einstein_ring_launches_the_dopri_kernels():
    """A 32x32 Einstein ring (BASELINE config 2: a moon behind the hole,
    Dormand-Prince) renders through dopri_fwd's event variant once and
    agrees with the plain render; its gradient goes through dopri_ckpt and
    dopri_bwd once each and agrees with the plain path's."""
    v, u = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    sky = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * u / 128)
                    * np.sin(np.pi * v / 64), v / 64,
                    ((u // 8 + v // 8) % 2).astype(np.float32)], -1)
    moon = np.zeros((1, 8, 16, 3), np.float32)
    moon[..., 1] = 1.0
    cfg = P.RenderConfig(width=32, height=32, lam_max=120.0,
                         integrator=P.IntegratorConfig(
                             n_steps=2000, dt=0.5, method="dopri",
                             rtol=1e-5, atol=1e-8, max_step=2.0))
    plain = dataclasses.replace(cfg, integrator=dataclasses.replace(
        cfg.integrator, backend="torch"))
    cam = P.Camera.make(position=(0.0, 0.0, 20.0), fov=(0.9, 0.9),
                        device=DEV)

    def scene():
        return P.Scene(
            bh=P.BlackHole.make(mass=0.5, device=DEV),
            background=torch.as_tensor(sky, dtype=torch.float32, device=DEV),
            spheres=P.Spheres.make(center=[[0.0, 0.0, -12.0]], radius=[1.0],
                                   texture=moon, device=DEV))

    before = counts()
    with torch.no_grad():
        img = P.render_image(scene(), cam, cfg)
    assert launched(before) == {"dopri_fwd_events": 1}
    diff = (img - P.render_image(scene(), cam, plain)).abs()
    assert float(diff.mean()) < 2e-3
    assert float((diff > 0.1).float().mean()) < 0.01
    assert float(img[16, 22:32, 1].max()) > 0.5

    def grads(c):
        sc = scene()
        leaves = (sc.bh.mass, sc.background)
        for t in leaves:
            t.requires_grad_(True)
        P.render_image(sc, cam, c)[..., :3].pow(2).mean().backward()
        return [t.grad for t in leaves]

    before = counts()
    gk = grads(cfg)
    assert launched(before) == {"dopri_ckpt_events": 1,
                                "dopri_bwd_events": 1}
    gp = grads(plain)
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max() / b.abs().max()) <= 5e-2


# =============================================================================
# The adjoints' ray order (cuda_kernel.ray_order, IntegratorConfig.tile_order).
# =============================================================================
@pytest.mark.parametrize("kernel,spin", [("rk4", None), ("rk4", 0.45),
                                         ("dopri", None), ("dopri", 0.45)])
def test_adjoint_orders_agree(kernel, spin):
    """rk4_bwd and dopri_bwd with the disk and the spheres, Schwarzschild
    and Kerr, in cost order and in input order: the per-ray cotangents are
    the same bit for bit (a thread's arithmetic does not depend on its
    neighbours), the scalar and sphere cotangents, summed in another order,
    agree within 1e-3 of the largest (chip_smoke.py's limit against the
    plain path), and two runs in one order give the same bits."""
    e = events_env(env()) if spin is None else kerr_env(spin, True)
    x0, d0 = (event_rays() if kernel == "rk4" else dopri_rays())
    s0 = kerr_state(e, x0, d0)
    n = s0.E.numel()
    scal_cfg = tint.IntegratorConfig(**(FLAGSHIP if kernel == "rk4"
                                        else {**DOPRI, "n_steps": 96}))
    scal = cuda_kernel._scalars(e, scal_cfg, DEV)
    sph = cuda_kernel._sphere_table(e, DEV)
    kw = dict(sph=sph, has_disk=True, kerr=spin is not None)
    seg = cuda_kernel.segment(scal_cfg.n_steps)
    rng = np.random.default_rng(5)
    gx, gp = (torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32,
                              device=DEV) for _ in range(2))
    with torch.no_grad():
        if kernel == "rk4":
            ck = cuda_kernel.rk4_ckpt(scal, s0.x, s0.p, s0.E, s0.lam,
                                      s0.status, scal_cfg.n_steps, seg, 1.5,
                                      obj=s0.hit_obj, **kw)[-1]
            bwd = lambda o: cuda_kernel.rk4_bwd(  # noqa: E731
                scal, ck, s0.E, gx, gp, scal_cfg.n_steps, seg, 1.5,
                tile_order=o, **kw)
        else:
            h = torch.full_like(s0.E, tint.dopri_h0(scal_cfg))
            ctl = cuda_kernel.controller(scal_cfg)
            ck = cuda_kernel.dopri_ckpt(scal, s0.x, s0.p, s0.E, h, s0.lam,
                                        s0.status, scal_cfg.n_steps, seg,
                                        ctl, obj=s0.hit_obj, **kw)[-1]
            bwd = lambda o: cuda_kernel.dopri_bwd(  # noqa: E731
                scal, ck, s0.E, gx, gp, scal_cfg.n_steps, seg, ctl,
                tile_order=o, **kw)
        cost, again, plain_order = bwd("cost"), bwd("cost"), bwd("none")
    order = cuda_kernel.ray_order(ck[-1], "cost")
    assert not torch.equal(order, torch.arange(n, device=DEV))
    for a, b, c in zip(cost, again, plain_order):
        assert torch.equal(a, b)
    for a, c in zip(cost[:3], plain_order[:3]):
        assert torch.equal(a, c)
    for a, c in zip(cost[3:], plain_order[3:]):
        assert float(c.abs().max()) > 0
        assert float((a - c).abs().max() / c.abs().max()) <= 1e-3


# =============================================================================
# The sphere guard against a build without it (rk4_step.cuh
# BHGC_SPHERE_GUARD=0, _build.built_with).
# =============================================================================
@pytest.mark.parametrize("kernel", ["rk4", "dopri"])
@pytest.mark.parametrize("spin", [None, 0.45, -0.3])
def test_sphere_guard_changes_no_bit(spin, kernel):
    """The forward kernels' outputs, checkpoints and live counts on the
    event rays -- rk4_fwd and rk4_ckpt, or dopri_fwd and dopri_ckpt --
    equal those of the build without the sphere guard bit for bit: the
    guard skips only sphere quadratics that find no entry."""
    e = events_env(env()) if spin is None else kerr_env(spin, True)
    kw = dict(sph=cuda_kernel._sphere_table(e, DEV), has_disk=True,
              kerr=spin is not None)
    if kernel == "rk4":
        s0 = kerr_state(e, *event_rays())
        cfg = tint.IntegratorConfig(**{**FLAGSHIP, "n_steps": 60})
        args = (cuda_kernel._scalars(e, cfg, DEV), s0.x, s0.p, s0.E,
                s0.lam, s0.status, cfg.n_steps)
        fwd, ckpt, tail = cuda_kernel.rk4_fwd, cuda_kernel.rk4_ckpt, (1.5,)
    else:
        s0 = kerr_state(e, *dopri_rays())
        cfg = tint.IntegratorConfig(**DOPRI)
        args = (cuda_kernel._scalars(e, cfg, DEV), s0.x, s0.p, s0.E,
                torch.full_like(s0.E, tint.dopri_h0(cfg)), s0.lam,
                s0.status, cfg.n_steps)
        fwd, ckpt = cuda_kernel.dopri_fwd, cuda_kernel.dopri_ckpt
        tail = (cuda_kernel.controller(cfg),)
    seg = cuda_kernel.segment(cfg.n_steps)

    def run():
        out = fwd(*args, *tail, obj=s0.hit_obj, **kw)
        *fin, ck = ckpt(*args, seg, *tail, obj=s0.hit_obj, **kw)
        return (*out, *fin, *ck)

    with torch.no_grad():
        guarded = run()
        with _build.built_with("BHGC_SPHERE_GUARD=0"):
            unguarded = run()
    assert int((guarded[3] == states.OBJECT).sum()) >= 20
    for a, b in zip(guarded, unguarded):
        assert torch.equal(a, b)


# =============================================================================
# Massive particles (launch(..., time_like=True)) through K1-K6, and the
# multisampled and progressive renders.
# =============================================================================
def particle_fan(n=1500, seed=0):
    """tests/torch_particles.py's fan of massive particles on the card."""
    return tuple(torch.as_tensor(a, device=DEV)
                 for a in torch_particles.particle_fan(n, seed))


def particle_env(lam_max):
    return dataclasses.replace(env(), lam_max=torch.tensor(lam_max,
                                                           device=DEV))


def particle_state(e, x0, v0):
    p0, E0 = tgeo.timelike_init(x0, v0, e.mass)
    s0 = states.init_state(x0, p0, E0)
    s0.status = s0.status.masked_fill(x0.norm(dim=-1) <= e.r_capture,
                                      states.INSIDE_HORIZON)
    return s0


PARTICLE_RK4 = dict(FLAGSHIP)
PARTICLE_DOPRI = dict(n_steps=400, dt=0.05, method="dopri", rtol=1e-5,
                      atol=1e-8, max_step=4.0)


@pytest.mark.parametrize("method", ["rk4", "dopri"])
def test_timelike_kernels_match_plain(method):
    """launch(..., time_like=True) of the particle fan through rk4_fwd or
    dopri_fwd against the plain loop: RK4 statuses equal, x and lam within
    1e-3 and p within 1e-4 of max(1, |p|) (bound orbits ACTIVE at the
    end, Hh = -1/2 within 5e-4 there); Dormand-Prince statuses on >=
    99.8%, the particles on the same trips (lam within 1e-4) that do not
    fall in to those tolerances, the angular momentum x cross p of all
    that do not fall in to 1e-4.  Inside-horizon particles never move."""
    rk4 = method == "rk4"
    e = particle_env(1000.0 if rk4 else 60.0)
    x0, v0 = particle_fan()
    cfg = tint.IntegratorConfig(**(PARTICLE_RK4 if rk4 else PARTICLE_DOPRI))
    before = counts()
    sk = tint.launch(e, x0, v0, cfg, time_like=True)
    assert launched(before) == {f"{method}_fwd": 1}
    sp = tint.launch(e, x0, v0, dataclasses.replace(cfg, backend="torch"),
                     time_like=True)
    inside = sk.status == states.INSIDE_HORIZON
    assert int(inside.sum()) > 50 and torch.equal(sk.x[inside], x0[inside])
    for s in (sk, sp):
        assert torch.isfinite(s.x).all() and torch.isfinite(s.p).all()
    agree = sk.status == sp.status
    out = agree & (sp.status != states.CAPTURED) & ~inside
    dlam = (sk.lam - sp.lam).abs()
    held = out & (dlam <= 1e-4) if not rk4 else agree
    if rk4:
        assert bool(agree.all())
        H = tgeo.hamiltonian(sk.x, sk.p, sk.E, e.mass)
        act = sk.status == states.ACTIVE
        assert int(act.sum()) > 500
        assert float((H[act] + 0.5).abs().max()) < 5e-4
    else:
        assert float(agree.float().mean()) >= MIN_AGREE
        assert float(dlam[agree].max()) <= PARTICLE_DOPRI["max_step"] + 1e-3
        assert int(held.sum()) > int(out.sum()) // 3
        L = lambda s: torch.linalg.cross(s.x, s.p, dim=-1)  # noqa: E731
        dL = (L(sk) - L(sp)).abs().amax(-1) / L(sp).norm(dim=-1).clamp_min(1)
        assert float(dL[out].max()) <= 1e-4
    assert float((sk.x - sp.x)[held].abs().max()) <= TOL_X
    assert float(dlam[held].max()) <= TOL_X
    dp = (sk.p - sp.p).abs() / sp.p.norm(dim=-1, keepdim=True).clamp_min(1)
    assert float(dp[held].max()) <= TOL_P


@pytest.mark.parametrize("method", ["rk4", "dopri"])
def test_timelike_gradients_match_autograd(method):
    """The gradient of sum(x^2) over the particles that do not fall in, to
    the initial velocities and the mass, through rk4_ckpt and rk4_bwd (or
    dopri_ckpt and dopri_bwd) against autograd of the plain loop: finite
    everywhere, the inside-horizon band's zero; RK4 per particle to 1e-3
    of the largest and the mass to 1e-3; Dormand-Prince the median over
    the particles on the same trips to 2e-4 and the mass to 5e-2 (the
    limits of chip_smoke.py's dopri_bwd phase)."""
    rk4 = method == "rk4"
    e0 = particle_env(1000.0 if rk4 else 60.0)
    x0, v0 = particle_fan(seed=1)
    cfg = tint.IntegratorConfig(**(dict(PARTICLE_RK4, n_steps=60) if rk4
                                   else dict(PARTICLE_DOPRI, n_steps=120)))

    def grads(c):
        mass = e0.mass.clone().requires_grad_(True)
        e = dataclasses.replace(e0, mass=mass)
        v = v0.clone().requires_grad_(True)
        s = tint.launch(e, x0, v, c, time_like=True)
        keep = (s.status != states.CAPTURED) & (s.status != states.ERROR)
        torch.where(keep[..., None], s.x ** 2, 0.0).sum().backward()
        return s, v.grad, mass.grad

    before = counts()
    sk, gk, mk = grads(cfg)
    assert launched(before) == {f"{method}_ckpt": 1, f"{method}_bwd": 1}
    sp, gp, mp = grads(dataclasses.replace(cfg, backend="torch"))
    inside = sk.status == states.INSIDE_HORIZON
    assert torch.isfinite(gk).all() and torch.isfinite(mk)
    assert float(gk[inside].abs().max()) == 0.0
    same = (sk.status == sp.status) & ((sk.lam - sp.lam).abs() <= 1e-4)
    if rk4:
        assert float((gk - gp)[same].abs().max() / gp.abs().max()) <= 1e-3
        assert abs(float(mk) / float(mp) - 1.0) <= 1e-3
    else:
        nb = gp.norm(dim=-1)
        rel = (gk - gp).norm(dim=-1) / (nb + 1e-3 * nb.max())
        assert float(rel[same & ~inside].median()) <= 2e-4
        assert abs(float(mk) / float(mp) - 1.0) <= 5e-2


def anim_scene():
    """bench.py's events scene (a disk and four moons) at a small size."""
    v, u = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    sky = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * u / 128)
                    * np.sin(np.pi * v / 64), v / 64,
                    ((u // 8 + v // 8) % 2).astype(np.float32)], -1)
    scene = events_scene()
    return dataclasses.replace(scene, background=torch.as_tensor(
        sky, dtype=torch.float32, device=DEV))


def test_multisample_render_launches_per_sample():
    """A 3-sample 32x32 frame of the events scene from config 4's orbit
    camera: the forward launches rk4_fwd's event variant once for all
    three samples, its gradient rk4_ckpt's and rk4_bwd's once each, and
    both agree with the plain path on the same draws; render_image_u8
    equals the host quantization of the float frame."""
    scene = anim_scene()
    phi = 2 * np.pi / 10
    cam = P.Camera.make(position=(25 * np.sin(phi), 0.0, 25 * np.cos(phi)),
                        euler=(0.0, phi, 0.0), fov=(0.8, 0.8), device=DEV)
    cfg = P.RenderConfig(width=32, height=32, samples=3, lam_max=100.0,
                         integrator=P.IntegratorConfig(**FLAGSHIP))
    plain = dataclasses.replace(cfg, integrator=dataclasses.replace(
        cfg.integrator, backend="torch"))
    before = counts()
    img = P.render_image(scene, cam, cfg)
    assert launched(before) == {"rk4_fwd_events": 1}
    ref = P.render_image(scene, cam, plain)
    d = (img - ref).abs()
    assert float(d.mean()) < 2e-3 and float((d > 0.1).float().mean()) < 0.01
    u8 = P.render_image_u8(scene, cam, cfg)
    host = (img.clamp(0, 1) * 255 + 0.5).to(torch.uint8)
    assert torch.equal(u8, host)

    def grads(c):
        leaves = (scene.bh.mass, cam.position, scene.background)
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        P.render_image(scene, cam, c)[..., :3].pow(2).mean().backward()
        out = [t.grad.clone() for t in leaves]
        for t in leaves:
            t.requires_grad_(False)
        return out

    before = counts()
    gk = grads(cfg)
    assert launched(before) == {"rk4_ckpt_events": 1, "rk4_bwd_events": 1}
    gp = grads(plain)
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all()
    assert float((gk[2] - gp[2]).abs().max() / gp[2].abs().max()) <= 1e-2


def test_progressive_bands_equal_the_frame():
    """render_progressive at one sample, 16 bands over 200 rows of a 200 x
    240 events frame: each band's rows equal the whole frame's bit for bit
    (one thread per ray, no reduction), one rk4_fwd launch per band; at 3
    samples its last yield equals render_image within 1e-5."""
    scene = anim_scene()
    cam = P.Camera.make(position=(0.0, 0.0, 25.0), euler=(0.25, 0.0, 0.0),
                        fov=(0.8, 0.8), device=DEV)
    cfg = P.RenderConfig(width=240, height=200, lam_max=100.0,
                         integrator=P.IntegratorConfig(**FLAGSHIP))
    with torch.no_grad():
        full = P.render_image(scene, cam, cfg)
        before = counts()
        frames = list(P.render_progressive(scene, cam, cfg, row_bands=16))
        assert launched(before) == {"rk4_fwd_events": len(frames)}
        band = -(-200 // 16)
        for i, frame in frames:
            y0, y1 = i * band, min((i + 1) * band, 200)
            assert torch.equal(frame[y0:y1], full[y0:y1])
        assert torch.equal(frames[-1][1], full)
        cfg3 = dataclasses.replace(cfg, samples=3)
        img3 = P.render_image(scene, cam, cfg3)
        last = list(P.render_progressive(scene, cam, cfg3))[-1][1]
        assert float((last - img3).abs().max()) <= 1e-5


def hybrid_scene(spin=None):
    """A Gen-1 scene: the small events scene (a disk and four moons at
    radius 7) with a lamp lighting non-emissive moons."""
    scene = anim_scene()
    spheres = dataclasses.replace(
        scene.spheres, emission=torch.tensor([0.0, 1.0, 0.0, 1.0],
                                             device=DEV))
    return dataclasses.replace(
        scene, bh=P.BlackHole.make(mass=0.5, spin=spin, device=DEV),
        spheres=spheres,
        lights=P.Lights.make([[30.0, 0.0, 40.0]], device=DEV))


@pytest.mark.parametrize("spin", [None, 0.45])
def test_hybrid_preset_statuses_come_back_unchanged(spin):
    """The Gen-1 hybrid's initial state: rays that miss the influence
    sphere start ESCAPED and, with the sphere inside the capture radius,
    the entering rays INSIDE_HORIZON; rk4_fwd returns both equal to their
    input bit for bit and the entering rays as the plain loop does."""
    from blackhole_geodesic_calculator_tpu_torch.camera.pinhole import (
        generate_rays, pixel_grid)
    from blackhole_geodesic_calculator_tpu_torch.render import limited

    scene = hybrid_scene(spin)
    cam = P.Camera.make((0.0, 12.0, 38.0), euler=(-0.3, 0.0, 0.0),
                        fov=(1.2, 1.2), device=DEV)
    cfg = P.RenderConfig(width=96, height=96, lam_max=200.0,
                         integrator=P.IntegratorConfig(n_steps=400, dt=0.1))
    ys, xs = pixel_grid(96, 96, device=DEV)
    o, d = generate_rays(cam, 96, 96, ys, xs)
    for r_influence, preset_status in ((10.0, states.ESCAPED),
                                       (0.5, states.INSIDE_HORIZON)):
        lcfg = P.LimitedConfig(r_influence=r_influence)
        t1, _, enters = limited._flat_cast(scene, lcfg, o, d)
        x1 = o + d * torch.where(torch.isfinite(t1), t1, 0.0)[..., None]
        env, s0 = limited.geodesic_state(scene, cfg, lcfg,
                                         (x1 - scene.bh.loc) * (1 - 1e-4), d,
                                         enters)
        preset = s0.status != states.ACTIVE
        assert bool((s0.status == preset_status).any())
        before = counts()
        sk = tint.integrate(env, s0, cfg.integrator)
        assert launched(before) == {cuda_kernel.variant(
            "rk4_fwd", spin is not None, True): 1}
        for name in ("x", "p", "lam", "status", "hit_obj"):
            assert torch.equal(getattr(sk, name)[preset],
                               getattr(s0, name)[preset]), name
        sp = tint.integrate(env, s0, dataclasses.replace(cfg.integrator,
                                                         backend="torch"))
        assert int((sk.status != sp.status).sum()) <= 8


def test_stokes_and_polarization_map_match_plain():
    """render_stokes at 128^2 (the disk with pol_frac 0.7) launches
    rk4_fwd's event variant and shade_fwd once each, its rgb is
    render_image's bit for bit, and it agrees with the plain render; the
    Schwarzschild polarization map launches rk4_fwd once and agrees with
    the plain map (NaN patterns and angles, but a few escape-edge rays)."""
    scene = anim_scene()
    scene = dataclasses.replace(scene, spheres=None, disk=dataclasses.replace(
        scene.disk, pol_frac=torch.tensor(0.7, device=DEV)))
    cam = P.Camera.make((0.0, 0.0, 25.0), euler=(0.25, 0.0, 0.0),
                        fov=(0.8, 0.8), device=DEV)
    cfg = P.RenderConfig(width=128, height=128, lam_max=100.0,
                         integrator=P.IntegratorConfig(**FLAGSHIP))
    plain = dataclasses.replace(cfg, integrator=dataclasses.replace(
        cfg.integrator, backend="torch"))
    before = counts()
    rgb, Q, U = P.render_stokes(scene, cam, cfg)
    assert {**launched(before), **launched(before, shading=True)} == {
        "rk4_fwd_events": 1, "shade_fwd": 1}
    assert torch.equal(rgb, P.render_image(scene, cam, cfg)[..., :3])
    rgb_p, Q_p, U_p = P.render_stokes(scene, cam, plain)
    assert float((rgb - rgb_p).abs().mean()) < 1e-4
    assert float((torch.hypot(Q_p, U_p) > 1e-4).sum()) > 500
    dq = torch.maximum((Q - Q_p).abs(), (U - U_p).abs())
    assert int((dq > 1e-3).sum()) <= 8

    sky = dataclasses.replace(scene, disk=None)
    before = counts()
    m = P.polarization_map(sky, cam, cfg)
    assert launched(before) == {"rk4_fwd": 1}
    mp = P.polarization_map(sky, cam, plain)
    assert int((torch.isnan(m) != torch.isnan(mp)).sum()) <= 8
    both = ~torch.isnan(m) & ~torch.isnan(mp)
    wrapped = torch.remainder(m - mp + np.pi, 2 * np.pi) - np.pi
    assert int((wrapped[both].abs() > 1e-3).sum()) <= 8


@pytest.mark.parametrize("spin", [None, 0.45])
def test_hybrid_render_matches_plain(spin):
    """render_limited at 128^2 with the disk, a lit moon and debug colours
    launches rk4_fwd's event variant (Kerr's for a spin) once and agrees
    with the plain render: image mean |d| < 1e-3, the shadow pixel count
    within 4."""
    scene = hybrid_scene(spin)
    cam = P.Camera.make((0.0, 12.0, 38.0), euler=(-0.3, 0.0, 0.0),
                        fov=(0.6, 0.6), device=DEV)
    cfg = P.RenderConfig(width=128, height=128, lam_max=200.0,
                         integrator=P.IntegratorConfig(n_steps=400, dt=0.1))
    lcfg = P.LimitedConfig(r_influence=10.0)
    plain = dataclasses.replace(cfg, integrator=dataclasses.replace(
        cfg.integrator, backend="torch"))
    before = counts()
    img = P.render_limited(scene, cam, cfg, lcfg)
    assert launched(before) == {cuda_kernel.variant(
        "rk4_fwd", spin is not None, True): 1}
    ref = P.render_limited(scene, cam, plain, lcfg)
    assert float((img - ref).abs().mean()) < 1e-3
    black = (img[..., :3].amax(-1) < 1e-3).sum()
    black_p = (ref[..., :3].amax(-1) < 1e-3).sum()
    assert abs(int(black) - int(black_p)) <= 4


def test_surrogate_table_build_matches_plain():
    """SurrogateTable.build through rk4_fwd on the card against the plain
    build on the CPU: captured equal, exit directions within 1e-4 rad away
    from the critical impact parameter."""
    before = counts()
    tk = P.SurrogateTable.build(mass=0.5, r_influence=10.0, device=DEV)
    assert launched(before) == {"rk4_fwd": 1}
    tp = P.SurrogateTable.build(mass=0.5, r_influence=10.0, device="cpu")
    assert torch.equal(tk.captured.cpu(), tp.captured)
    calm = ~tp.captured & ((tp.b - 1.5 * 3 ** 0.5).abs() > 0.25)
    chord = (tk.end_dir.cpu() - tp.end_dir).norm(dim=-1)[calm]
    assert float(chord.max()) <= 1e-4


@pytest.mark.parametrize("a_over_m", [0.9, -0.6])
def test_kerr_mask_matches_plain(a_over_m):
    """The Trainer's Kerr critical-curve mask on the card against the same
    PyTorch operations on the CPU, on the pixel-centre rays of a 1024^2
    frame seen from the benchmark's Kerr orbit: the weights equal but for
    rays within 1e-5 of the band's edge (the card's fused multiply-adds
    move a ratio's last bits); the band drops rays; the mask launches none
    of the port's kernels."""
    from blackhole_geodesic_calculator_tpu_torch.camera.pinhole import (
        generate_rays, pixel_grid)
    from blackhole_geodesic_calculator_tpu_torch.models import kerr

    n = 1024
    cam = P.Camera.make((24.0, 0.0, 6.0), euler=(0.0, 1.33, 0.1),
                        fov=(0.8, 0.8), device=DEV)
    cfg = P.RenderConfig(width=n, height=n)
    tr = P.Trainer(cfg=cfg, param_fn=None, optimizer=None,
                   mask_critical=0.25)
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, spin=a_over_m * 0.5,
                                        device=DEV),
                    background=torch.zeros(4, 8, 3, device=DEV))
    ys, xs = pixel_grid(n, n, 0, n, 0, n, device=DEV)
    before = counts()
    got = tr._critical_weights(scene, cam, ys, xs)
    assert counts() == before
    cpu = lambda t: torch.as_tensor(t).cpu()  # noqa: E731
    scene_c = P.Scene(bh=P.BlackHole.make(mass=0.5, spin=a_over_m * 0.5,
                                          device="cpu"),
                      background=torch.zeros(4, 8, 3))
    cam_c = P.Camera(position=cpu(cam.position), euler=cpu(cam.euler),
                     fov=cpu(cam.fov))
    want = tr._critical_weights(scene_c, cam_c, ys.cpu(), xs.cpu())
    o, d = generate_rays(cam_c, n, n, ys.cpu(), xs.cpu())
    p0, e0 = null_init(o, d, scene_c.bh.mass, scene_c.bh.spin)
    lam, eta = kerr.carter_constants(o, p0, e0, scene_c.bh.spin)
    ratio = kerr.critical_ratio(lam, eta, scene_c.bh.mass, scene_c.bh.spin)
    edge = ((ratio - 1.0).abs() - 0.25).abs() < 1e-5
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got.cpu()[~edge], want[~edge])
    assert 0.0 < float(want.mean()) < 1.0


# The launches of one shading forward and backward with a texture
# cotangent: the forward, the backward (its kernel and the column sums),
# the texture scatter (the scatter and its finish).
SHADE_STEP = {"shade_fwd": 1, "shade_bwd": 1, "shade_tex": 1}
SHADE_RAYS = 1 << 20
# Tolerances of the shading kernels against autograd of the plain shading
# on the card, on tests/shade_cases.py's rays at SHADE_RAYS (readings on
# an H100: PERF.md).  Both sides are float32.  The colours differ by the
# last bits of the direction -- rhs's reciprocal square roots and fused
# multiply-adds against ks_fields' and the plain kernels' forms -- which
# the longitude near the sky's pole turns by 1 / |(d_x, d_y)|: colours
# within TOL_SHADE_COLOUR (readings 2.9e-6-9.3e-6 away from the pole).  A
# ray's cotangents of x, p and E within TOL_SHADE_RAY of its own scale
# (shade_cases.ray_gaps; readings up to 5.5e-5).  A ray that parts --
# colour beyond TOL_SHADE_COLOUR or a cotangent beyond TOL_SHADE_RAY:
# near the pole, or whose bilinear cell moves with those bits (the colour
# is continuous there, its coordinate cotangents are not) -- is counted,
# and the parted rays held to MAX_SHADE_PARTED of the rays (readings: 1 in
# 2^20 on the Kerr cases without spheres, none elsewhere).  The scene's
# cotangents -- sums over 1M rays -- are compared without the parted rays'
# terms (their colour cotangent set to 0 on both sides), within
# TOL_SHADE_SCENE of each leaf's largest entry, a table's row by row
# (shade_cases.leaf_gap; readings up to 2.1e-5).
TOL_SHADE_COLOUR = 2e-5
TOL_SHADE_RAY = 1e-4
MAX_SHADE_PARTED = 1e-5
TOL_SHADE_SCENE = 1e-3


def shade_both(case):
    """(plain colours, plain gradients, kernel colours, kernel gradients,
    the shading kernels' launches) of sum(g * colour) on a case."""
    from blackhole_geodesic_calculator_tpu_torch.scene import shading

    ref_out, ref = shade_cases.autograd_grads(
        case, lambda c: shading.shade(c.scene, c.state,
                                      tint.final_direction(c.env, c.state)))
    before = counts()
    out, got = shade_cases.autograd_grads(
        case, lambda c: shading.shade_rays(c.env, c.scene, c.state))
    return ref_out, ref, out, got, launched(before, shading=True)


def parted_rays(ref_out, ref, out, got):
    """The rays whose colour or whose cotangent of x, p or E part from the
    plain path's (TOL_SHADE_COLOUR, TOL_SHADE_RAY); the kernel's per-ray
    cotangents must be finite."""
    parted = (out - ref_out).abs().max(-1).values > TOL_SHADE_COLOUR
    for k in ("x", "p", "E"):
        assert torch.isfinite(got[k]).all(), k
        parted |= shade_cases.ray_gaps(got[k], ref[k]) > TOL_SHADE_RAY
    return parted


@pytest.mark.parametrize("features", shade_cases.feature_matrix(),
                         ids=shade_cases.case_id)
def test_shade_kernel_matches_plain(features):
    """shade_fwd's colours and shade_bwd's cotangents -- of x, p, E and
    every leaf of the scene -- against autograd of final_direction + shade
    on 1M rays of every status (the sky's seam and poles, shadowed lights,
    both redshift zeros): one launch each way (and the texture scatter);
    the rays that part counted and limited."""
    case = shade_cases.make_case(*features, n=SHADE_RAYS, device=DEV,
                                 seed=7)
    ref_out, ref, out, got, runs = shade_both(case)
    kerr = features[0]
    step = dict(SHADE_STEP)
    if kerr:
        step["shade_fwd_kerr"] = step.pop("shade_fwd")
        step["shade_bwd_kerr"] = step.pop("shade_bwd")
    assert runs == step
    parted = parted_rays(ref_out, ref, out, got)
    assert int(parted.sum()) <= MAX_SHADE_PARTED * SHADE_RAYS
    case.g[parted] = 0.0
    _, ref, _, got, _ = shade_both(case)
    for k, want in ref.items():
        if k in ("x", "p", "E"):
            continue
        assert torch.isfinite(got[k]).all(), k
        gap = shade_cases.leaf_gap(got[k], want)
        assert gap <= TOL_SHADE_SCENE, (k, gap)


@pytest.mark.parametrize("features", [(False, True, "plain", 4, 2),
                                      (True, True, "beam+", 0, 0)],
                         ids=shade_cases.case_id)
def test_shade_backward_is_deterministic(features):
    """The scene's and the textures' cotangents are fixed-order and
    fixed-point sums: two backward passes give the same bits."""
    from blackhole_geodesic_calculator_tpu_torch.scene import shading

    case = shade_cases.make_case(*features, n=SHADE_RAYS, device=DEV)
    run = lambda: shade_cases.autograd_grads(  # noqa: E731
        case, lambda c: shading.shade_rays(c.env, c.scene, c.state))[1]
    a, b = run(), run()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_trainer_step_shades_once(monkeypatch):
    """A multisampled Trainer step of the events scene learning the mass
    and the sky shades all its samples' rays in one shade_fwd launch and
    differentiates them in shade_bwd's: no texture lookup through
    sample_bpy, no tex_bwd."""
    calls = []
    apply = texture._SampleBpy.apply
    monkeypatch.setattr(texture._SampleBpy, "apply", staticmethod(
        lambda *a: (calls.append(1), apply(*a))[1]))
    scene0 = anim_scene()
    cam = P.Camera.make(position=(0.0, 3.0, 25.0), fov=(0.8, 0.8),
                        device=DEV)
    cfg = P.RenderConfig(width=32, height=32, samples=3, lam_max=100.0,
                         integrator=P.IntegratorConfig(**FLAGSHIP))

    def param_fn(params):
        bh = dataclasses.replace(scene0.bh, mass=params["mass"])
        return dataclasses.replace(scene0, bh=bh,
                                   background=params["sky"]), cam

    tr = P.Trainer(cfg=cfg, param_fn=param_fn,
                   optimizer=lambda ts: torch.optim.Adam(ts, lr=1e-3))
    params = tr._leaves({"mass": 0.5, "sky": scene0.background}, DEV)
    opt = tr.init(params)
    target, ys, xs = tr.shard_target(torch.zeros(32, 32, 3, device=DEV))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    before = counts()
    _, _, loss = tr.step(params, opt, target, ys, xs, tr._draws(gen, DEV))
    assert torch.isfinite(loss)
    assert launched(before, shading=True) == SHADE_STEP
    assert launched(before, texture=True) == {}
    assert launched(before) == {"rk4_ckpt_events": 1, "rk4_bwd_events": 1}
    assert calls == []
