"""The Trainer on a spinning hole: the Kerr critical-curve mask, the spin as
a learned leaf, and the disk's redshift span, held to the plain Kerr
reference of the benchmark (``gpubench/reference_kerr``).

* Without a spin the mask is the Schwarzschild rule, bit for bit; with
  one it is the distance from the Kerr critical curve in the plane of the
  Carter constants (lambda, eta), on which the equatorial critical impact
  parameters of ``bardeen_edges`` lie, and across which equatorial rays
  part between capture and escape.
* lambda and eta are conserved along a plain Kerr integration.
* ``Trainer.step`` with a learned mass, spin, roll and sky equals the
  reference's step; the reference's spin gradient equals a float64 central
  difference.
"""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import blackhole_geodesic_calculator_tpu_torch as P  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.camera.pinhole import generate_rays  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.examples.parameter_study import (  # noqa: E402
    bardeen_edges)
from blackhole_geodesic_calculator_tpu_torch.models.kerr import (  # noqa: E402
    carter_constants, critical_curve, critical_ratio)
from blackhole_geodesic_calculator_tpu_torch.ops.geodesic import null_init  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops.integrate import (  # noqa: E402
    GeodesicEnv, IntegratorConfig, _init, launch, trajectory)
from blackhole_geodesic_calculator_tpu_torch.parallel.render import local_slots  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.scene.shading import (  # noqa: E402
    disk_redshift, shade_disk)
from blackhole_geodesic_calculator_tpu_torch.utils import profiling  # noqa: E402
from gpubench.reference_kerr import integrate as RI  # noqa: E402
from gpubench.reference_kerr import render as RR  # noqa: E402
from gpubench.reference_kerr import shading as RS  # noqa: E402

M, A = 0.5, 0.45          # the benchmark's hole: a/M = 0.9
BAND = 0.25


def t32(v):
    return torch.as_tensor(v, dtype=torch.float32)


def orbit_camera(phase, roll=0.0, radius=24.74):
    ph = t32(phase)
    zero = torch.zeros(())
    return P.Camera(position=torch.stack([radius * torch.sin(ph), zero,
                                          radius * torch.cos(ph)]),
                    euler=torch.stack([zero, ph, t32(roll)]),
                    fov=t32((0.8, 0.8)))


def trainer(width, height, samples=1, n_steps=120):
    cfg = P.RenderConfig(
        width=width, height=height, samples=samples, lam_max=100.0,
        integrator=P.IntegratorConfig(n_steps=n_steps, dt=0.1, dt_boost=64.0,
                                      dt_boost_r_ref=1.7, dt_power=1.5))
    return P.Trainer(cfg=cfg, param_fn=None, optimizer=None,
                     mask_critical=BAND)


def hole(spin):
    return P.Scene(bh=P.BlackHole.make(mass=M, spin=spin, device="cpu"),
                   background=torch.zeros(4, 8, 3))


def pixels(tr):
    ys, xs = local_slots(tr.cfg, tr.mesh, "cpu")
    return ys, xs


# -- the mask ----------------------------------------------------------------

@pytest.mark.parametrize("phase,roll", [(0.0, 0.0), (0.07, -0.06),
                                        (math.pi / 2, 0.3)])
def test_mask_without_spin_is_the_schwarzschild_rule(phase, roll):
    """spin None: the weights are today's |ell / (3 sqrt(3) M) - 1| > band
    rule, bit for bit."""
    tr = trainer(48, 40)
    ys, xs = pixels(tr)
    scene, cam = hole(None), orbit_camera(phase, roll)
    got = tr._critical_weights(scene, cam, ys, xs)
    o, d = generate_rays(cam, 48, 40, ys, xs)
    o_rel = o - scene.bh.loc
    p0, e0 = null_init(o_rel, d, scene.bh.mass, None)
    ell = torch.linalg.norm(torch.linalg.cross(o_rel, p0, dim=-1),
                            dim=-1) / e0
    ell_c = 3.0 * math.sqrt(3.0) * scene.bh.mass
    want = (torch.abs(ell / torch.clamp_min(ell_c, 1e-6) - 1.0)
            > BAND).to(torch.float32)
    assert torch.equal(got, want)
    assert 0 < float(got.mean()) < 1


@pytest.mark.parametrize("a_over_m", [0.3, 0.6, 0.9, -0.9])
@pytest.mark.parametrize("side", ["prograde", "retrograde"])
def test_bardeen_edges_lie_on_the_critical_curve(a_over_m, side):
    """The equatorial critical impact parameters read rho / rho_c = 1 within
    1e-3: given directly as (lambda, 0), and from the initial state of an
    equatorial ray aimed at them from afar."""
    a = a_over_m * M
    b_pro, b_retro = bardeen_edges(M, abs(a))
    # prograde rays orbit with the hole: L_z of a's sign
    lam = (b_pro if side == "prograde" else -b_retro) * math.copysign(1.0, a)
    got = critical_ratio(t32([lam]), t32([0.0]), t32(M), t32(a))
    assert abs(float(got) - 1.0) < 1e-3
    x0 = torch.tensor([[lam, -2000.0, 0.0]], dtype=torch.float64)
    d0 = torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float64)
    p0, e0 = null_init(x0, d0, torch.tensor(M, dtype=torch.float64),
                       torch.tensor(a, dtype=torch.float64))
    lam0, eta0 = carter_constants(x0, p0, e0,
                                  torch.tensor(a, dtype=torch.float64))
    assert abs(float(eta0)) < 1e-9
    got = critical_ratio(lam0.float(), eta0.float(), t32(M), t32(a))
    assert abs(float(got) - 1.0) < 1e-3


@pytest.mark.parametrize("side", ["prograde", "retrograde"])
def test_equatorial_rays_part_at_the_critical_curve(side):
    """Equatorial rays 3% inside the critical curve are captured and 3%
    outside escape, on the side of L_z that the curve says: the curve's
    orientation is the integrator's."""
    b_pro, b_retro = bardeen_edges(M, A)
    b = b_pro if side == "prograde" else -b_retro
    lam = torch.tensor([0.97 * b, 1.03 * b])
    x0 = torch.stack([lam, torch.full_like(lam, -60.0),
                      torch.zeros_like(lam)], -1)
    d0 = torch.tensor([[0.0, 1.0, 0.0]]).expand(2, 3)
    r_h = M + math.sqrt(M * M - A * A)
    env = GeodesicEnv(mass=t32(M), spin=t32(A), r_capture=t32(r_h),
                      r_escape=t32(150.0), lam_max=t32(400.0))
    cfg = IntegratorConfig(n_steps=900, dt=0.05, dt_boost=64.0,
                           dt_boost_r_ref=1.7, dt_power=1.5)
    s = launch(env, x0, d0, cfg)
    assert s.status.tolist() == [P.ops.states.CAPTURED, P.ops.states.ESCAPED]
    s0 = _init(env, x0, d0, False)
    lam0, eta0 = carter_constants(x0, s0.p, s0.E, t32(A))
    ratio = critical_ratio(lam0, eta0, t32(M), t32(A))
    assert ratio[0] < 1.0 < ratio[1]


def test_critical_curve_closes_to_the_photon_sphere():
    """At a -> 0 the curve is the circle rho_c = 3 sqrt(3) M."""
    table = critical_curve(t32(M), t32(0.0))
    assert float(table[0, 0]) < 1e-3 and abs(float(table[-1, 0]) - math.pi) < 1e-3
    np.testing.assert_allclose(table[:, 1].numpy(), 3.0 * math.sqrt(3.0) * M,
                               rtol=1e-3)


@pytest.mark.parametrize("a_over_m", [0.1, 0.9, 0.99])
def test_critical_ratio_matches_the_reference_bisection(a_over_m):
    """The port's table, linear between 1,024 Chebyshev-spaced orbits,
    against the reference's bisection on each angle: within 2e-5."""
    a = a_over_m * M
    psi = torch.linspace(0.0, math.pi, 997, dtype=torch.float64)
    rho_c = RR.critical_rho(psi, torch.tensor(M, dtype=torch.float64),
                            torch.tensor(a, dtype=torch.float64))
    lam, eta = rho_c * torch.cos(psi), (rho_c * torch.sin(psi)) ** 2
    got = critical_ratio(lam.float(), eta.float(), t32(M), t32(a))
    assert float((got.double() - 1.0).abs().max()) < 2e-5


@pytest.mark.parametrize("phase", [0.0, math.pi / 2, math.pi, 4.0])
def test_kerr_mask_matches_the_reference(phase):
    """The Trainer's Kerr weights equal the reference's, written anew (its
    own Carter constants, bisection for rho_c), but for pixels within
    1e-5 of the band's edge; the band leaves out rays, on both sides of the
    shadow where the camera is off the spin axis, and keeps every ray with
    eta < 0."""
    tr = trainer(64, 64)
    ys, xs = pixels(tr)
    scene, cam = hole(A), orbit_camera(phase, 0.1)
    got = tr._critical_weights(scene, cam, ys, xs)
    ref = RR.critical_weights(
        {"mass": t32(M), "spin": t32(A), "loc": scene.bh.loc},
        {"position": cam.position, "euler": cam.euler, "fov": cam.fov},
        {"width": 64, "height": 64}, ys, xs, BAND)
    o, d = generate_rays(cam, 64, 64, ys, xs)
    p0, e0 = null_init(o, d, t32(M), t32(A))
    lam, eta = carter_constants(o, p0, e0, t32(A))
    ratio = critical_ratio(lam, eta, t32(M), t32(A))
    edge = (torch.abs(ratio - 1.0) - BAND).abs() < 1e-5
    assert torch.equal(got[~edge], ref[~edge])
    assert bool((got[eta < 0] == 1).all())
    dropped = got == 0
    assert bool(dropped.any())
    if abs(math.sin(phase)) > 0.5:
        # off the spin axis, rays are dropped by both edges of the shadow
        assert bool((lam[dropped] > 0.5).any())
        assert bool((lam[dropped] < -0.5).any())


# -- the Carter constants ----------------------------------------------------

@pytest.mark.parametrize("which", ["lambda", "eta"])
def test_carter_constants_are_conserved(which):
    """Along 120 float64 RK4 steps of a plain Kerr integration that stay
    away from the hole, lambda and eta keep their start within 1e-4
    relative (float64 keeps the rounding of Q's terms out)."""
    f64 = torch.float64
    g = torch.Generator().manual_seed(3)
    x0 = torch.tensor([0.0, 3.0, 20.0], dtype=f64).expand(48, 3).clone()
    d0 = torch.nn.functional.normalize(
        torch.tensor([0.0, -0.15, -1.0], dtype=f64)
        + 0.12 * torch.randn(48, 3, generator=g, dtype=f64), dim=-1)
    a = torch.tensor(A, dtype=f64)
    env = GeodesicEnv(mass=torch.tensor(M, dtype=f64), spin=a,
                      r_capture=torch.tensor(0.8, dtype=f64),
                      r_escape=torch.tensor(80.0, dtype=f64),
                      lam_max=torch.tensor(100.0, dtype=f64))
    xs, ps, _ = trajectory(env, x0, d0, IntegratorConfig(
        n_steps=120, dt=0.1, dt_boost=1.0))
    E = _init(env, x0, d0, False).E
    start = carter_constants(xs[0], ps[0], E, a)
    end = carter_constants(xs[-1], ps[-1], E, a)
    k = ("lambda", "eta").index(which)
    assert float(torch.linalg.norm(xs[-1], dim=-1).min()) > 5.0
    rel = (end[k] - start[k]).abs() / start[k].abs()
    assert float(rel.max()) < 1e-4


def test_carter_constants_at_zero_spin_are_the_angular_momentum():
    """a = 0: eta + lambda^2 = |x cross p|^2 / E^2 and lambda = L_z / E,
    in float64 (Q's terms cancel to a few units of float32 rounding of
    r^2 |p|^2)."""
    f64 = torch.float64
    g = torch.Generator().manual_seed(5)
    x = torch.tensor([0.3, 2.0, 24.0], dtype=f64).expand(100, 3).clone()
    d = torch.nn.functional.normalize(
        torch.randn(100, 3, generator=g, dtype=f64), dim=-1)
    zero = torch.tensor(0.0, dtype=f64)
    p, E = null_init(x, d, torch.tensor(M, dtype=f64), zero)
    lam, eta = carter_constants(x, p, E, zero)
    L = torch.linalg.cross(x, p, dim=-1) / E[:, None]
    np.testing.assert_allclose((eta + lam * lam).sqrt().numpy(),
                               torch.linalg.norm(L, dim=-1).numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(lam.numpy(), L[:, 2].numpy(), rtol=1e-10,
                               atol=1e-12)


# -- the disk's redshift -------------------------------------------------------

def test_disk_redshift_is_the_references():
    """The port's g and the reference's, bit for bit; 0 just inside the
    prograde circular photon orbit (Boyer-Lindquist r 0.78 at a/M = 0.9),
    where no orbit exists, and where E - Omega L_z <= 0, which no matter on
    the orbit emits; positive elsewhere on the disk."""
    g = torch.Generator().manual_seed(7)
    r = torch.linspace(0.3, 8.0, 400)
    ph = 2.0 * math.pi * torch.rand(400, generator=g)
    x = torch.stack([r * torch.cos(ph), r * torch.sin(ph),
                     torch.zeros_like(r)], -1)
    p = torch.randn(400, 3, generator=g)
    E = 1.0 + 0.1 * torch.rand(400, generator=g)
    got = disk_redshift(x, p, E, t32(M), t32(A), 1.0)
    want = RS.redshift(x, p, E, t32(M), t32(A))
    assert torch.equal(got, want)
    r_bl = torch.sqrt(r * r - A * A)
    assert float(got[(r_bl > 0.6) & (r_bl < 0.75)].abs().max()) == 0.0
    omega = math.sqrt(M) / (r_bl ** 1.5 + A * math.sqrt(M))
    rel = E - omega * (x[:, 0] * p[:, 1] - x[:, 1] * p[:, 0])
    assert bool((rel[r > 1.6] <= 0).any())
    assert bool((got[(r > 1.6) & (rel <= 0)] == 0).all())
    assert bool((got[(r > 1.6) & (rel > 0)] > 0).all())


@pytest.mark.parametrize("beaming", [None, 4.0])
def test_redshift_span_opens_only_for_a_beaming_disk(beaming):
    """``bhgc.render.redshift`` opens in ``shade_disk`` when the disk has a
    beaming exponent, and not otherwise: the orbit cell's operations keep
    their spans."""
    disk = P.Disk.make(r_in=1.6, r_out=6.0, texture=torch.rand(8, 16, 3),
                       beaming=beaming, device="cpu")
    scene = dataclasses.replace(hole(A), disk=disk)
    x = torch.tensor([[3.0, 1.0, 0.0], [2.0, -2.5, 0.0]])
    p = torch.tensor([[0.1, 0.9, -0.4], [0.3, 0.2, -0.9]])
    E = torch.ones(2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        shade_disk(scene, x, p, E)
    names = {e.name for e in prof.events()}
    assert ("bhgc.render.redshift" in names) == (beaming is not None)
    # with no profiler running the span is the shared no-op context
    assert profiling.annotate("bhgc.render.redshift") is profiling.annotate(
        "other")


# -- the Trainer's step against the reference ------------------------------

def _kerr_scene_and_reference(tex, sky, params, phase):
    """The program's (scene, camera) and the reference's dicts of one frame
    of the benchmark's Kerr disk from the learned tensors."""
    disk = P.Disk.make(r_in=1.6, r_out=6.0, texture=tex, intensity=1.2,
                       beaming=4.0, device="cpu")
    ph = t32(phase)
    zero = torch.zeros(())
    pos = torch.stack([24.74 * torch.sin(ph), zero, 24.74 * torch.cos(ph)])
    euler = torch.stack([zero, ph, params["roll"]])
    fov = t32((0.8, 0.8))
    scene = P.Scene(bh=P.BlackHole.make(mass=M, spin=A, device="cpu"),
                    background=sky, disk=disk)
    scene = dataclasses.replace(
        scene, bh=dataclasses.replace(scene.bh, mass=params["mass"],
                                      spin=params["spin"]),
        background=params["sky"])
    cam = P.Camera(position=pos, euler=euler, fov=fov)
    ref_disk = {"r_in": disk.r_in, "r_out": disk.r_out, "phase": disk.phase,
                "mean": disk.mean, "stddev": disk.stddev,
                "intensity": disk.intensity, "texture": tex,
                "beaming": disk.beaming}
    ref = ({"mass": params["mass"], "spin": params["spin"],
            "loc": scene.bh.loc, "background": params["sky"],
            "disk": ref_disk},
           {"position": pos, "euler": euler, "fov": fov})
    return (scene, cam), ref


class _Keep(torch.optim.Optimizer):
    """Keeps the gradients the Trainer hands it, and changes nothing."""

    def __init__(self, params):
        super().__init__(params, {})
        self.got = None

    def step(self, closure=None):
        self.got = [p.grad.detach().clone() for g in self.param_groups
                    for p in g["params"]]


@pytest.fixture(scope="module")
def kerr_step():
    """One Trainer step and the reference's on a 32 x 32 x 2-spp Kerr disk
    (a/M = 0.9, beaming 4, the cell's camera at phase 1.2), mass, spin,
    roll and sky learned from a start off the truth, seeded textures."""
    g = torch.Generator().manual_seed(11)
    tex = torch.rand(16, 32, 3, generator=g)
    sky = torch.rand(16, 32, 3, generator=g)
    truth = {"mass": t32(M), "spin": t32(A), "roll": t32(0.0), "sky": sky}
    start = {"mass": t32(M + 0.03), "spin": t32(A - 0.1),
             "roll": t32(-0.04), "sky": sky.clone()}
    w = h = 32
    samples = 2
    tr = trainer(w, h, samples, n_steps=160)
    draws = torch.rand(samples, 2, h, w, generator=g)
    phase = 1.2
    rcfg = {"width": w, "height": h, "samples": samples, "lam_max": 100.0,
            "r_escape": 0.0, "integrator": RI.Integrator(
                n_steps=160, dt=0.1, dt_boost=64.0, dt_boost_r_ref=1.7,
                dt_power=1.5)}
    _, ref_truth = _kerr_scene_and_reference(tex, sky, truth, phase)
    with torch.no_grad():
        target = RR.render_rgb(*ref_truth, rcfg, torch.rand(
            samples, 2, h, w, generator=g))

    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    tr = dataclasses.replace(
        tr, param_fn=lambda p: _kerr_scene_and_reference(tex, sky, p,
                                                         phase)[0],
        optimizer=_Keep)
    opt = tr.init(params)
    flat, ys, xs = tr.shard_target(target)
    _, _, loss = tr.step(params, opt, flat, ys, xs, draws)
    got = dict(zip(params, opt.optimizer.got))

    ref_params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    ref_loss, ref_grads = RR.step_loss_and_grads(
        lambda p: _kerr_scene_and_reference(tex, sky, p, phase)[1],
        ref_params, rcfg, target, draws, BAND, 11, 16)
    return float(loss), got, ref_loss, ref_grads


def test_trainer_step_loss_is_the_references(kerr_step):
    """The masked loss within 1e-5 relative: the same float32 operations
    on both sides, summed over the rays in another order."""
    loss, _, ref_loss, _ = kerr_step
    assert loss > 0
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)


@pytest.mark.parametrize("leaf", ["mass", "spin", "roll", "sky"])
def test_trainer_step_gradient_is_the_references(kerr_step, leaf):
    """Each leaf's gradient, the spin's included, within the reference's
    rtol of 1e-4 (tests/test_pallas.py's): the step's own float32
    arithmetic summed in another order, through K3's plain twin here; a
    texel's gradient is a sum of rays' terms that may cancel, so it is
    held to 1e-4 of the largest texel's besides."""
    _, got, _, ref = kerr_step
    g, r = got[leaf], ref[leaf]
    assert float(r.abs().max()) > 0
    np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4,
                               atol=1e-4 * float(r.abs().max())
                               if r.numel() > 1 else 0.0)


@pytest.mark.parametrize("leaf", ["spin", "mass"])
def test_reference_gradient_is_a_central_difference(leaf):
    """The reference's float64 gradient of the masked loss with respect to
    the spin (and the mass) against (L(v + h) - L(v - h)) / 2h, h = 1e-6,
    within 1e-5 relative, on a 12 x 12 x 2-spp Kerr disk."""
    f64 = torch.float64
    g = torch.Generator().manual_seed(13)
    tex = torch.rand(16, 32, 3, generator=g, dtype=f64)
    sky = torch.rand(16, 32, 3, generator=g, dtype=f64)
    w = h = 12
    samples = 2
    rcfg = {"width": w, "height": h, "samples": samples, "lam_max": 100.0,
            "r_escape": 0.0, "integrator": RI.Integrator(
                n_steps=160, dt=0.1, dt_boost=64.0, dt_boost_r_ref=1.7,
                dt_power=1.5)}
    draws = torch.rand(samples, 2, h, w, generator=g, dtype=f64)
    target = torch.rand(h, w, 3, generator=g, dtype=f64)
    disk = {"r_in": torch.tensor(1.6, dtype=f64),
            "r_out": torch.tensor(6.0, dtype=f64),
            "phase": torch.tensor(0.0, dtype=f64),
            "mean": torch.tensor(0.5, dtype=f64),
            "stddev": torch.tensor(0.2, dtype=f64),
            "intensity": torch.tensor(1.2, dtype=f64), "texture": tex,
            "beaming": torch.tensor(4.0, dtype=f64)}
    ph = 1.2

    def build(p):
        return ({"mass": p["mass"], "spin": p["spin"],
                 "loc": torch.zeros(3, dtype=f64), "background": sky,
                 "disk": disk},
                {"position": torch.tensor([24.74 * math.sin(ph), 0.0,
                                           24.74 * math.cos(ph)], dtype=f64),
                 "euler": torch.tensor([0.0, ph, 0.0], dtype=f64),
                 "fov": torch.tensor([0.8, 0.8], dtype=f64)})

    def at(**v):
        return {k: torch.tensor(v.get(k, d), dtype=f64).requires_grad_(True)
                for k, d in (("mass", M), ("spin", A))}

    _, grads = RR.step_loss_and_grads(build, at(), rcfg, target, draws,
                                      BAND, h, 0)
    step = 1e-6
    v = {"mass": M, "spin": A}[leaf]
    hi, _ = RR.step_loss_and_grads(build, at(**{leaf: v + step}), rcfg,
                                   target, draws, BAND, h, 0)
    lo, _ = RR.step_loss_and_grads(build, at(**{leaf: v - step}), rcfg,
                                   target, draws, BAND, h, 0)
    fd = (hi - lo) / (2.0 * step)
    assert abs(float(grads[leaf])) > 1e-4
    assert abs(float(grads[leaf]) - fd) <= 1e-5 * abs(fd)


def test_kerr_mask_reads_no_host_copy():
    """The Trainer's Kerr mask makes its table of the critical curve from
    the mass and spin tensors where they live: no operation copies a
    value to the host (``.item()``, ``float()``), so the step does not
    wait on the device for it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class NoHostCopy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            assert func is not torch.ops.aten._local_scalar_dense.default
            return func(*args, **(kwargs or {}))

    tr = trainer(48, 40)
    ys, xs = pixels(tr)
    scene, cam = hole(t32(A)), orbit_camera(math.pi / 2, 0.3)
    want = tr._critical_weights(scene, cam, ys, xs)
    with NoHostCopy():
        got = tr._critical_weights(scene, cam, ys, xs)
    assert torch.equal(got, want) and 0.0 < float(want.mean()) < 1.0


def test_beaming_disk_gradient_is_finite_off_the_disk():
    """A ray that ended inside the horizon, where the disk's g^beaming
    overflows to inf (here a steep exponent, 40), leaves the shading's
    gradient finite: ``shade`` hands the redshift E = 0 for it (the
    discarded branch's zero cotangent times inf was NaN); the disk ray's
    colour is the disk shader's."""
    from blackhole_geodesic_calculator_tpu_torch.ops import states
    from blackhole_geodesic_calculator_tpu_torch.scene.shading import shade

    beaming = 40.0
    x_in = torch.tensor([[0.45, 0.15, 0.3]])
    E_in = torch.tensor([0.5])
    for py in torch.linspace(0.5, 0.7, 2001).tolist():
        p_in = torch.tensor([[0.0, py, 0.0]])
        g_in = disk_redshift(x_in, p_in, E_in, t32(M), t32(A))
        if float(g_in) > 0 and not bool(torch.isfinite(g_in ** beaming)):
            break
    else:
        raise AssertionError("no ray whose g^beaming overflows")
    tex = torch.rand(8, 16, 3, generator=torch.Generator().manual_seed(2))
    tex.requires_grad_(True)
    disk = P.Disk.make(r_in=1.6, r_out=6.0, texture=tex, beaming=beaming,
                       device="cpu")
    disk = dataclasses.replace(disk, texture=tex)
    scene = dataclasses.replace(hole(A), disk=disk)
    x = torch.cat([x_in, torch.tensor([[3.0, 1.0, 0.0]])]).requires_grad_(True)
    p = torch.cat([p_in, torch.tensor([[0.1, 0.9, -0.4]])]).requires_grad_(True)
    E = torch.cat([E_in, torch.tensor([1.0])]).requires_grad_(True)
    s = P.ops.states.RayState(
        x=x, p=p, E=E, lam=torch.zeros(2),
        status=torch.tensor([states.CAPTURED, states.DISK], dtype=torch.int32),
        hit_obj=torch.full((2,), -1, dtype=torch.int32))
    rgb = shade(scene, s, torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]]))
    assert torch.equal(rgb[0], torch.zeros(3))
    assert torch.equal(rgb[1], shade_disk(scene, x[1:], p[1:], E[1:])[0])
    rgb.sum().backward()
    for t in (x, p, E, tex):
        assert bool(torch.isfinite(t.grad).all())


@pytest.mark.parametrize("z", [0.0, 1e-6, 1e-5])
def test_kerr_fields_are_finite_by_the_ring_disk(z):
    """Where r^2 rounds to 0 (on and just off the ring's disk, z = 0 and
    x^2 + y^2 < a^2), the floored fields keep the final direction and the
    initial momentum finite, value and gradient: a captured ray frozen
    there gave the whole step a NaN gradient when the floor was put on r
    after its square root.  The Kerr reference's fields agree."""
    from blackhole_geodesic_calculator_tpu_torch.models.kerr import ks_radius2
    from blackhole_geodesic_calculator_tpu_torch.ops.geodesic import xdot

    x = torch.tensor([[0.2, 0.1, z]], requires_grad=True)
    assert float(ks_radius2(x.detach(), t32(A))) == 0.0
    p = torch.tensor([[0.3, -0.2, 0.5]], requires_grad=True)
    E = torch.tensor([1.0], requires_grad=True)
    v = xdot(x, p, E, t32(M), t32(A))
    w = torch.tensor([[0.7, -0.1, 0.4]])
    (v * w).sum().backward()
    for t in (x, p, E):
        assert bool(torch.isfinite(t.grad).all())
    assert torch.equal(v.detach(), RI.xdot(x.detach(), p.detach(),
                                           E.detach(), t32(M), t32(A)))
    pn, En = null_init(x, torch.tensor([[0.0, 0.6, 0.8]]), t32(M), t32(A))
    x.grad = None
    (pn.sum() + En.sum()).backward()
    assert bool(torch.isfinite(x.grad).all())


# A ray of the benchmark's edge-on Kerr frame (1024^2 x 5 spp, a/M = 0.9,
# frame 25) whose step from r = 0.81 sampled the horizon's interior near
# the ring and landed outside with |p| ~ 140: bit patterns of its start.
_THROUGH = {"x": [1103489925, 0, 3046188365],
            "p": [3212713597, 3186708036, 997770499], "E": [1065346950],
            "r_escape": [1116403138]}


def _bits(v):
    return torch.from_numpy(np.array(v, dtype=np.uint32).view(np.float32))


def test_a_step_through_the_horizon_captures_the_ray():
    """That ray is CAPTURED by the step whose stages come within the
    capture radius (the port's plain path and the Kerr reference alike);
    judged by its endpoint alone it flew out and hit the disk with a
    momentum no photon there has."""
    from blackhole_geodesic_calculator_tpu_torch.ops import states
    from blackhole_geodesic_calculator_tpu_torch.ops.integrate import (
        _apply_events, _dt_eff, integrate_fixed_fast, rk4_step)

    x0, p0 = _bits(_THROUGH["x"])[None], _bits(_THROUGH["p"])[None]
    E0 = _bits(_THROUGH["E"])
    r_h = float(M + math.sqrt(M * M - A * A))
    env = GeodesicEnv(mass=t32(M), spin=t32(A), r_capture=t32(r_h),
                      r_escape=_bits(_THROUGH["r_escape"])[0],
                      lam_max=t32(100.0),
                      disk=P.ops.integrate.DiskGeom(t32(1.6), t32(6.0)))
    cfg = IntegratorConfig(n_steps=500, dt=0.1, dt_boost=64.0,
                           dt_boost_r_ref=1.7, dt_power=1.5)
    s = integrate_fixed_fast(env, states.init_state(x0, p0, E0), cfg)
    assert s.status.tolist() == [states.CAPTURED]
    # judged by the endpoint alone (the rule before): out again, on the disk
    s = states.init_state(x0, p0, E0)
    for _ in range(500):
        if not bool(s.active.any()):
            break
        dt = _dt_eff(env, cfg, s)
        s = _apply_events(env, s, *rk4_step(env, s.x, s.p, s.E, dt), dt)
    assert s.status.tolist() == [states.DISK]
    assert float(s.p.norm()) > 30.0
    ref_env = RI.Env(mass=t32(M), spin=t32(A), r_capture=t32(r_h),
                     r_escape=env.r_escape, lam_max=t32(100.0),
                     disk=(t32(1.6), t32(6.0)))
    ref = RI.integrate(ref_env, RI.Integrator(
        n_steps=500, dt=0.1, dt_boost=64.0, dt_boost_r_ref=1.7,
        dt_power=1.5), RI.State(x=x0, p=p0, E=E0, lam=torch.zeros(1),
                                status=torch.zeros(1, dtype=torch.int32),
                                hit_obj=torch.full((1,), -1,
                                                   dtype=torch.int32)))
    assert ref.status.tolist() == [RI.CAPTURED]
