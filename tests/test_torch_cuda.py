"""The CUDA kernel of the PyTorch port against its plain PyTorch version.

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
FLAGSHIP = dict(n_steps=100, dt=0.12, dt_boost=64.0, dt_boost_r_ref=1.7,
                dt_power=1.5)
DEV = torch.device("cuda")


def env():
    return tint.GeodesicEnv(
        mass=torch.tensor(0.5, device=DEV),
        r_capture=torch.tensor(1.0, device=DEV),
        r_escape=torch.tensor(70.0, device=DEV),
        lam_max=torch.tensor(100.0, device=DEV))


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


@pytest.mark.parametrize("case", ["disk", "spheres", "spin", "dopri",
                                  "grad"])
def test_out_of_slice_raises_on_cuda(case):
    e = env()
    x0, d0 = fan(64, 0)
    if case == "grad":
        x0.requires_grad_(True)
    p0, E0 = null_init(x0, d0, e.mass)
    s0 = states.init_state(x0, p0, E0)
    cfg = tint.IntegratorConfig(**FLAGSHIP, backend="cuda")
    if case == "disk":
        e.disk = tint.DiskGeom(r_in=torch.tensor(2.0, device=DEV),
                               r_out=torch.tensor(6.0, device=DEV))
    elif case == "spheres":
        e.spheres = tint.SphereGeom(
            center=torch.zeros(1, 3, device=DEV),
            radius=torch.ones(1, device=DEV))
    elif case == "spin":
        e.spin = torch.tensor(0.45, device=DEV)
    elif case == "dopri":
        cfg = dataclasses.replace(cfg, method="dopri")
    before = cuda_kernel.LAUNCHES
    with pytest.raises(NotImplementedError):
        tint.integrate(e, s0, cfg)
    with pytest.raises(NotImplementedError):
        cuda_kernel.integrate_cuda(e, s0, cfg)
    assert cuda_kernel.LAUNCHES == before


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
