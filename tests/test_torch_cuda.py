"""The CUDA kernels of the PyTorch port against their plain PyTorch versions:
rk4_fwd, rk4_ckpt and rk4_bwd, event-free and with disk and sphere events,
and renders and their gradients through them.

Needs a CUDA device and nvcc, and skips without them.  This file imports
nothing of JAX, so it also runs where JAX is not installed; the tests'
``conftest.py`` imports JAX, so there run it without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparison at the flagship's full size.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import blackhole_geodesic_calculator_tpu_torch as P  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import cuda_kernel  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import integrate as tint  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import states  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops.geodesic import null_init  # noqa: E402

pytestmark = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA device")

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
    before = cuda_kernel.LAUNCHES
    sk = tint.launch(e, x0, d0, cfg)
    assert cuda_kernel.LAUNCHES == before + 1
    sp = tint.launch(e, x0, d0, dataclasses.replace(cfg, backend="torch"))
    assert cuda_kernel.LAUNCHES == before + 1
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


@pytest.mark.parametrize("case", ["spin-events", "spin", "dopri"])
def test_out_of_slice_raises_on_cuda(case):
    e = env()
    x0, d0 = fan(64, 0)
    p0, E0 = null_init(x0, d0, e.mass)
    s0 = states.init_state(x0, p0, E0)
    cfg = tint.IntegratorConfig(**FLAGSHIP, backend="cuda")
    if case.startswith("spin"):
        e.spin = torch.tensor(0.45, device=DEV)
    if case == "spin-events":
        e = events_env(e)
    elif case == "dopri":
        cfg = dataclasses.replace(cfg, method="dopri")
    before = (cuda_kernel.LAUNCHES, cuda_kernel.LAUNCHES_EV)
    with pytest.raises(NotImplementedError):
        tint.integrate(e, s0, cfg)
    with pytest.raises(NotImplementedError):
        cuda_kernel.integrate_cuda(e, s0, cfg)
    assert (cuda_kernel.LAUNCHES, cuda_kernel.LAUNCHES_EV) == before


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
    before = (cuda_kernel.LAUNCHES, cuda_kernel.LAUNCHES_CKPT)
    fwd = cuda_kernel.rk4_fwd(*args, cfg.n_steps, power)
    *fin, (cx, cp, clam, cst) = cuda_kernel.rk4_ckpt(*args, cfg.n_steps,
                                                      seg, power)
    assert (cuda_kernel.LAUNCHES, cuda_kernel.LAUNCHES_CKPT) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(fin, fwd):
        assert torch.equal(a, b)
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
    before = cuda_kernel.LAUNCHES_BWD
    gk = cotangents(e, s0, cfg, wx, kernel=True)
    assert cuda_kernel.LAUNCHES_BWD == before + 1
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


def test_render_gradient_launches_ckpt_and_bwd():
    """A 32x32 flagship frame's gradient goes through rk4_ckpt and rk4_bwd
    once each, never rk4_fwd, and agrees with the plain path."""
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

    before = (cuda_kernel.LAUNCHES, cuda_kernel.LAUNCHES_CKPT,
              cuda_kernel.LAUNCHES_BWD)
    gk = grads(cfg)
    assert (cuda_kernel.LAUNCHES, cuda_kernel.LAUNCHES_CKPT,
            cuda_kernel.LAUNCHES_BWD) == (before[0], before[1] + 1,
                                          before[2] + 1)
    gp = grads(dataclasses.replace(cfg, integrator=dataclasses.replace(
        cfg.integrator, backend="torch")))
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max() / b.abs().max()) <= TOL_RENDER_GRAD


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
    before = cuda_kernel.LAUNCHES
    img = P.render_image(scene, cam, cfg)
    assert cuda_kernel.LAUNCHES == before + 1
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
    before = (cuda_kernel.LAUNCHES, cuda_kernel.LAUNCHES_EV)
    sk = tint.launch(e, x0, d0, cfg)
    sp = tint.launch(e, x0, d0, dataclasses.replace(cfg, backend="torch"))
    assert (cuda_kernel.LAUNCHES, cuda_kernel.LAUNCHES_EV) == (
        before[0], before[1] + 1)
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
    before = cuda_kernel.LAUNCHES_CKPT_EV
    fwd = cuda_kernel.rk4_fwd(*args, cfg.n_steps, 1.5, **kw)
    *fin, (cx, cp, clam, cst) = cuda_kernel.rk4_ckpt(*args, cfg.n_steps, seg,
                                                      1.5, **kw)
    assert cuda_kernel.LAUNCHES_CKPT_EV == before + 1
    for a, b in zip(fin, fwd):
        assert torch.equal(a, b)
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
    before = (cuda_kernel.LAUNCHES_BWD, cuda_kernel.LAUNCHES_BWD_EV)
    gk = event_cotangents(s0, cfg, wx, kernel=True)
    assert (cuda_kernel.LAUNCHES_BWD, cuda_kernel.LAUNCHES_BWD_EV) == (
        before[0], before[1] + 1)
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


def test_events_render_launches_the_event_variants():
    """A 32x32 frame of bench.py's events scene renders through rk4_fwd's
    event variant alone, and its gradient through those of rk4_ckpt and
    rk4_bwd; both agree with the plain path."""
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
    cfg = P.RenderConfig(width=32, height=32, lam_max=100.0,
                         integrator=P.IntegratorConfig(**FLAGSHIP))

    def scene():
        return P.Scene(
            bh=P.BlackHole.make(mass=0.5, device=DEV),
            background=torch.as_tensor(sky, dtype=torch.float32, device=DEV),
            disk=P.Disk.make(r_in=2.0, r_out=6.0, texture=disk_tex,
                             device=DEV),
            spheres=P.Spheres.make(
                center=centers, radius=[0.6, 0.5, 0.7, 0.4], device=DEV,
                texture=np.tile(np.float32([0.3, 0.9, 0.4]),
                                (4, 16, 32, 1))))

    cam = P.Camera.make(position=(0.0, 0.0, 25.0), euler=(0.25, 0.0, 0.0),
                        fov=(0.8, 0.8), device=DEV)
    plain = dataclasses.replace(cfg, integrator=dataclasses.replace(
        cfg.integrator, backend="torch"))

    def counts():
        return (cuda_kernel.LAUNCHES, cuda_kernel.LAUNCHES_CKPT,
                cuda_kernel.LAUNCHES_BWD, cuda_kernel.LAUNCHES_EV,
                cuda_kernel.LAUNCHES_CKPT_EV, cuda_kernel.LAUNCHES_BWD_EV)

    before = counts()
    with torch.no_grad():
        img = P.render_image(scene(), cam, cfg)
    assert counts() == before[:3] + (before[3] + 1,) + before[4:]
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
    assert counts() == before[:4] + (before[4] + 1, before[5] + 1)
    gp = grads(plain)
    # mass and camera: the frame's gradient to them is a sum of parts of
    # both signs that float32 moves (a reading of 1.4e-2 for the mass on
    # an H100); the sky and the disk texture are per texel
    for a, b, tol in zip(gk, gp, (5e-2, 5e-2, 1e-2, 1e-2)):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max() / b.abs().max()) <= tol
