"""The adjoint kernels' ray order and the port's default device, on the CPU.

``cuda_kernel.ray_order`` is the order in which the threads of rk4_bwd and
dopri_bwd take the rays: under ``tile_order="cost"`` (the JAX package's
switch and default) a stable sort of the rays by their count of ACTIVE
checkpoint rows, most first; under ``"none"`` the input order.  The count
(``live_segments``, the plain version of what rk4_ckpt and dopri_ckpt
write beside their checkpoints) is held against the checkpoints of the
plain loops (``integrate_ckpt_plain``, ``integrate_adaptive_ckpt_plain``)
on a fan with captured, escaped, disk and sphere rays: it is each ray's
number of live segments, the steps (or trips) it took while ACTIVE over
the segment length, rounded up.

Scenes and cameras are built on the card unless the caller names another
device; on a host without CUDA that raises (decided inside each test).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import blackhole_geodesic_calculator_tpu_torch as P  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import convert  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import cuda_kernel  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import integrate as tint  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import states  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops.geodesic import null_init  # noqa: E402

RK4 = dict(n_steps=100, dt=0.12, dt_boost=64.0, dt_boost_r_ref=1.7,
           dt_power=1.5)
DOPRI = dict(n_steps=96, dt=0.05, method="dopri", rtol=1e-5, atol=1e-8,
             max_step=4.0)


def events_env():
    """A hole of mass 0.5 with the z = 0 disk (r_in 2, r_out 6) and two
    spheres, one across the fan's path and a moon at radius 7."""
    f = lambda v: torch.tensor(v)  # noqa: E731
    return tint.GeodesicEnv(
        mass=f(0.5), r_capture=f(1.0), r_escape=f(70.0), lam_max=f(100.0),
        disk=tint.DiskGeom(r_in=f(2.0), r_out=f(6.0)),
        spheres=tint.SphereGeom(center=f([[2.0, 0.0, 10.0], [-7.0, 1.0, 0.5]]),
                                radius=f([3.0, 0.6])))


def fan(env, n=400, seed=0):
    """Rays from z = 25 tilted up to 0.3 rad off -z at offsets in [-8, 8]:
    some are captured, some escape, some end on the disk or a sphere."""
    rng = np.random.default_rng(seed)
    x0 = np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                   np.full(n, 25.0)], -1)
    d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  np.full(n, -1.0)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x0 = torch.as_tensor(x0, dtype=torch.float32)
    d0 = torch.as_tensor(d, dtype=torch.float32)
    p0, E0 = null_init(x0, d0, env.mass)
    return states.init_state(x0, p0, E0)


def active_steps(env, cfg, s0):
    """Each ray's steps (or trips) taken while ACTIVE, replayed."""
    count = torch.zeros_like(s0.E, dtype=torch.int32)
    s, h = s0, torch.full_like(s0.E, tint.dopri_h0(cfg))
    for _ in range(cfg.n_steps):
        count += s.active.int()
        if cfg.method == "dopri":
            s, h, _ = tint._dopri_trip(env, cfg, s, h)
        else:
            s = tint._fixed_step(env, cfg, s)
    return count, s


@pytest.mark.parametrize("method", ["rk4", "dopri"])
def test_cost_key_is_each_rays_live_segments(method):
    """The key of the cost order, the ACTIVE rows of the checkpoints' status
    (what rk4_ckpt and dopri_ckpt write, here from their plain versions),
    is each ray's live segments; the order sorts by it, most first, ties
    in input order."""
    env = events_env()
    cfg = tint.IntegratorConfig(**(RK4 if method == "rk4" else DOPRI))
    s0 = fan(env)
    seg = cuda_kernel.segment(cfg.n_steps)
    with torch.no_grad():
        if method == "rk4":
            _, rows = cuda_kernel.integrate_ckpt_plain(env, s0, cfg, seg)
        else:
            _, rows, _ = cuda_kernel.integrate_adaptive_ckpt_plain(
                env, s0, cfg, seg)
        count, final = active_steps(env, cfg, s0)
    cst = torch.stack([row.status for row in rows])
    live = -(-count // seg)
    key = cuda_kernel.live_segments(cst)
    assert key.dtype == torch.uint8
    assert torch.equal(key.int(), live)
    ended = set(final.status.tolist())
    assert {states.CAPTURED, states.ESCAPED, states.DISK,
            states.OBJECT} <= ended
    assert len(set(live.tolist())) >= 3
    order = cuda_kernel.ray_order(key, "cost")
    assert order.dtype == torch.int64
    assert np.array_equal(order.numpy(),
                          np.argsort(-live.numpy(), kind="stable"))


def test_cost_order_is_a_stable_sort_and_repeats():
    """Many ties: rays of one count keep their input order, and repeated
    calls give the same permutation."""
    rng = np.random.default_rng(1)
    cst = torch.as_tensor(rng.choice([states.ACTIVE, states.ESCAPED,
                                      states.DISK], size=(7, 5000),
                                     p=[0.6, 0.3, 0.1]), dtype=torch.int32)
    # live segments form a prefix: a ray frozen at row k stays frozen
    cst = torch.where(torch.cummax((cst != states.ACTIVE).int(), 0).values
                      .bool(), states.ESCAPED, states.ACTIVE).int()
    live = cuda_kernel.live_segments(cst)
    key = (cst == states.ACTIVE).sum(0).numpy()
    assert np.array_equal(live.numpy(), key)
    first = cuda_kernel.ray_order(live, "cost")
    assert np.array_equal(first.numpy(), np.argsort(-key, kind="stable"))
    for _ in range(3):
        assert torch.equal(cuda_kernel.ray_order(live, "cost"), first)
    assert np.all(np.diff(key[first.numpy()]) <= 0)


def test_order_none_is_the_input_order():
    cst = torch.zeros((4, 37), dtype=torch.int32)
    cst[2:, ::3] = states.CAPTURED
    order = cuda_kernel.ray_order(cuda_kernel.live_segments(cst), "none")
    assert order.dtype == torch.int64
    assert torch.equal(order, torch.arange(37))


def test_unknown_order_raises():
    with pytest.raises(ValueError):
        cuda_kernel.ray_order(torch.zeros(3, dtype=torch.uint8), "rows")


def test_live_count_caps_at_a_byte():
    """Past 255 live segments (n_steps > 16,320 at seg 64) the count
    saturates at 255: those rays tie and keep their input order."""
    cst = torch.full((300, 4), states.ACTIVE, dtype=torch.int32)
    cst[254:, 1] = states.ESCAPED
    cst[10:, 3] = states.CAPTURED
    live = cuda_kernel.live_segments(cst)
    assert live.tolist() == [255, 254, 255, 10]
    assert cuda_kernel.ray_order(live, "cost").tolist() == [0, 2, 1, 3]


def test_config_default_is_cost_order():
    assert tint.IntegratorConfig().tile_order == "cost"


def cpu_scene():
    return P.Scene(
        bh=P.BlackHole.make(mass=0.5, device="cpu"),
        background=torch.rand(4, 8, 3),
        disk=P.Disk.make(r_in=2.0, r_out=6.0, texture=np.ones((4, 8, 3)),
                         device="cpu"),
        spheres=P.Spheres.make(center=[[0.0, 0.0, -12.0]], radius=[1.0],
                               texture=np.ones((4, 8, 3)), device="cpu"),
        lights=P.Lights.make(position=[[0.0, 0.0, 12.0]], device="cpu"))


# Each constructor, called with no device; the scene and camera converters
# take this package's own trees as well as the JAX package's.
CONSTRUCTORS = {
    "BlackHole": lambda: P.BlackHole.make(mass=0.5).mass,
    "Disk": lambda: P.Disk.make(r_in=2.0, r_out=6.0,
                                texture=np.ones((4, 8, 3))).texture,
    "Spheres": lambda: P.Spheres.make(center=[[0.0, 0.0, -12.0]],
                                      radius=[1.0],
                                      texture=np.ones((4, 8, 3))).albedo,
    "Lights": lambda: P.Lights.make(position=[[0.0, 0.0, 12.0]]).intensity,
    "Camera": lambda: P.Camera.make((0.0, 0.0, 20.0)).position,
    "scene_from_reference":
        lambda: convert.scene_from_reference(cpu_scene()).bh.mass,
    "camera_from_reference": lambda: convert.camera_from_reference(
        P.Camera.make((0.0, 0.0, 20.0), device="cpu")).fov,
}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructors_default_to_the_card(name):
    """No device named: the card.  Without one, building raises rather
    than carrying on on the CPU."""
    if torch.cuda.is_available():
        assert CONSTRUCTORS[name]().device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            CONSTRUCTORS[name]()


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_cpu_callers_name_the_cpu(name):
    """``device="cpu"`` keeps every constructor on the CPU."""
    t = {
        "BlackHole": lambda: P.BlackHole.make(mass=0.5, device="cpu").mass,
        "Disk": lambda: cpu_scene().disk.texture,
        "Spheres": lambda: cpu_scene().spheres.albedo,
        "Lights": lambda: cpu_scene().lights.intensity,
        "Camera": lambda: P.Camera.make((0.0, 0.0, 20.0),
                                        device="cpu").position,
        "scene_from_reference": lambda: convert.scene_from_reference(
            cpu_scene(), device="cpu").spheres.center,
        "camera_from_reference": lambda: convert.camera_from_reference(
            P.Camera.make((0.0, 0.0, 20.0), device="cpu"),
            device="cpu").euler,
    }[name]()
    assert t.device.type == "cpu" and t.dtype == torch.float32
