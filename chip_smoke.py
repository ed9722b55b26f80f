"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It drives the port's two main paths --
the forward render through rk4_fwd and its gradient through rk4_ckpt and
rk4_bwd -- and fails (non-zero exit, no result line) if anything is off:

  0. needs a CUDA device; prints the card's name and power limit;
  1. builds the kernels from the checkout's sources (build/kernels/), one
     nvcc per source, all at once;
  2. holds rk4_fwd against its plain PyTorch version on the card (a
     65,536-ray impact-parameter fan and a ragged batch with inside-horizon
     rays) and renders the 64x64 sky golden through it;
  3. renders the 1024x1024 flagship sky scene through ``render_image``,
     checks that rk4_fwd alone was launched and that the image agrees with
     the plain PyTorch render, and holds the kernel's final states of those
     1M rays against the plain integrator's;
  4. holds rk4_ckpt against rk4_fwd (final states) and each of its
     checkpoint rows against the plain step loop at the same step, on the
     fan, the ragged batch and the flagship rays;
  5. holds rk4_bwd against autograd of the plain step loop on the card:
     per-ray cotangents of x, p and E and the mass cotangent, on the fan
     (also cut to 40 steps, so rays are ACTIVE at the end) and on the
     ragged batch at all four step-size powers;
  6. takes the flagship 1024x1024 gradient of mean(img^2) with respect to
     the mass, the camera position and the sky through ``render_image``,
     checks that rk4_ckpt and rk4_bwd were launched once each and rk4_fwd
     not at all, and holds it against the plain path: whole, and away from
     the rays circling the photon sphere and those ending near the sky's
     pole, where float32 conditions it badly (it reads how much those
     carry, and how far one ulp of camera moves the plain path); holds the
     per-ray cotangents of the flagship rays away from b_c; checks that
     rk4_bwd's scalar cotangents are the same bit for bit from run to run;
  7. times the forward render, the forward+backward step, and each kernel
     call against its plain version, and profiles the step;
  8. holds the event variant of rk4_fwd (a z = 0 disk and spheres) against
     the plain loop: 65,536 rays spread across the disk and the moons of
     bench.py's events scene, the ragged batch at the four step-size
     powers, the Schwarzschild case of tests/test_pallas.py's sphere-guard
     stress configuration and those rays through small spheres where the
     steps are long (where a guard band cut short would miss hits); statuses and
     hit ids equal, apart from a counted and capped set of rays that touch
     an event's edge (event_margin); renders the 64x64 goldens
     einstein_ring and disk_and_moons through it;
  9. holds rk4_ckpt's event variant against rk4_fwd's (bit for bit) and its
     checkpoint rows against the plain loop, those batches and the 1024^2
     events rays;
 10. holds rk4_bwd's event variant against autograd of the plain loop, the
     (K, 4) sphere cotangent included, and checks that two runs give the
     same bits;
 11. renders bench.py's events scene (a disk and four moons, camera tilted
     by 0.25 rad) at 1024x1024 through render_image: the forward launches
     the event variant of rk4_fwd alone and agrees with the plain render,
     its final states with the plain integrator's; the gradient of
     mean(img^2) to the mass, the camera and the sky launches the event
     variants of rk4_ckpt and rk4_bwd once each and agrees with the plain
     path (the sky's whole; the mass and camera on the frame's calm
     pixels, see TOL_EVENTS_GRAD), and so does a gradient to a moon's
     centre and radius;
 12. times the events render, its forward+backward step and each event
     variant against its plain version, and profiles the step.

Every check of a phase is recorded; after the last phase the run fails if
any check failed.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists each kernel
with its launch count on the main path, error and times.  Imports nothing
of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import blackhole_geodesic_calculator_tpu_torch as P
from blackhole_geodesic_calculator_tpu_torch.camera.pinhole import (
    generate_rays, pixel_grid)
from blackhole_geodesic_calculator_tpu_torch.ops import (
    _build, cuda_kernel, states)
from blackhole_geodesic_calculator_tpu_torch.ops.geodesic import null_init
from blackhole_geodesic_calculator_tpu_torch.ops.integrate import (
    DiskGeom, GeodesicEnv, SphereGeom, _disk_event, _dt_eff, _fixed_step,
    _sphere_events, final_direction, rk4_step)
from blackhole_geodesic_calculator_tpu_torch.render.renderer import (
    _bh_frame, scene_env)
from blackhole_geodesic_calculator_tpu_torch.scene.shading import (
    disk_uv, shade)
from blackhole_geodesic_calculator_tpu_torch.scene.texture import equirect_uv

ROOT = Path(__file__).resolve().parent
PKG = "blackhole_geodesic_calculator_tpu_torch"
PALLAS = "blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py"
KERNELS = {   # name -> (source in the repo, the TPU kernel it replaces)
    "rk4_fwd": (f"{PKG}/ops/csrc/rk4_fwd.cu", f"{PALLAS}:1159"),
    "rk4_ckpt": (f"{PKG}/ops/csrc/rk4_ckpt.cu", f"{PALLAS}:1201"),
    "rk4_bwd": (f"{PKG}/ops/csrc/rk4_bwd.cu", f"{PALLAS}:1258"),
    # the event variants (disk and sphere events, EV > 0 in the sources)
    "rk4_fwd_events": (f"{PKG}/ops/csrc/rk4_fwd.cu", f"{PALLAS}:1159"),
    "rk4_ckpt_events": (f"{PKG}/ops/csrc/rk4_ckpt.cu", f"{PALLAS}:1201"),
    "rk4_bwd_events": (f"{PKG}/ops/csrc/rk4_bwd.cu", f"{PALLAS}:1258"),
}
# the launch counter of each kernel variant in ops/cuda_kernel.py
COUNTERS = {"rk4_fwd": "LAUNCHES", "rk4_ckpt": "LAUNCHES_CKPT",
            "rk4_bwd": "LAUNCHES_BWD", "rk4_fwd_events": "LAUNCHES_EV",
            "rk4_ckpt_events": "LAUNCHES_CKPT_EV",
            "rk4_bwd_events": "LAUNCHES_BWD_EV"}

# Tolerances of the kernels against their plain versions.  Both are
# float32; they differ in rsqrtf against torch.rsqrt and in nvcc's fused
# multiply-adds, a few ulp per step, amplified near the photon sphere.
TOL_X = 1e-3       # position and affine parameter, absolute
TOL_P = 1e-4       # momentum, absolute
TOL_DIR = 1e-4     # final direction, radians: 1/8 of the flagship pixel
# rk4_bwd against autograd of the plain loop: largest |difference| of each
# per-ray cotangent (x, p, E) over the largest |value| of the plain one
# (readings on an H100: at most 1.6e-5 on the fan, the ragged batch and the
# flagship rays away from b_c), and the mass cotangent's relative
# difference (reading 1.6e-4 on the fan).
TOL_GRAD = 1e-4
TOL_GRAD_MASS = 1e-3
# The flagship gradient, kernel path against plain path: the mass, the
# camera position and the sky (largest |difference| over largest |value|).
# It is ill-conditioned in float32: the rays near b_c carry 95% of it, and
# the sky's checker channel varies along u at the pole rows, which the
# camera looks at, so rays that end near the pole have cotangents ~ 1/rho.
# Moving the plain path's camera by one ulp moves it by 1.45e-2; the kernel
# path reads 8.4e-3 from the plain one (H100).
TOL_FLAGSHIP_GRAD = 3e-2
# ... away from b_c and from within POLE_RHO rad of the sky's pole, where
# it is well conditioned.
POLE_RHO = 0.05
TOL_CALM_GRAD = 1e-3
# The events frame's sky gradient (reading 3.0e-3 on an H100, and float32
# alone moves it by 3.0e-3), kernel path against plain path, and its
# gradient to a moon's centre and radius (reading 2.0e-5).  Its calm pixels
# -- away from b_c, the sky's pole, the disk texture's seam, the
# silhouettes, ill-conditioned events and texel flips -- are held to
# TOL_CALM_GRAD (readings 8.6e-6 mass, 8.3e-6 camera, 4.2e-6 sky; the
# plain path with the camera one ulp away reads 8.3e-5 and 2.0e-5).
TOL_EVENTS_GRAD = 1e-2
TOL_MOON_GRAD = 1e-3
# A texel flip is a pixel whose sky or disk lookup falls in another texel
# cell on the kernel path than on the plain one, its end point moved by a
# few float32 ulp.  The bilinear lookup's derivative jumps at a texel
# centre, by the whole contrast at the sky checker's edges: 9 such calm
# pixels of the 1M carried all of a 1.6e-3 difference in the frame's mass
# gradient (H100).  They are counted and capped.
MAX_TEXEL_FLIPS = 64
# The golden rule of tests/test_golden.py for whole images: the 64x64
# golden render against its checked-in image.
GOLDEN_MEAN = 2e-3
GOLDEN_FRAC = 0.01
# The flagship image through the kernel against the plain render on the
# card, set from the readings (mean |d| 8.0e-7, no element off by > 0.1 on
# an H100): a kernel that stopped a step early or got the step budget wrong
# changes a few hundred of the 1M pixels and fails it.
FLAGSHIP_MEAN = 1e-5
FLAGSHIP_FRAC = 1e-5
# At most this many rays of one comparison may end a step apart (see
# step_apart); the readings were 1 of 65,536 fan rays and 0 elsewhere.
MAX_ALIGNED = 8
SIZE = 1024        # the flagship image is SIZE x SIZE
FAN = 65536        # rays of the impact-parameter fan
# Rays that touch an event's edge: a segment that grazes a sphere, crosses
# z = 0 at r_in or r_out or with an end on the plane, enters a sphere at
# an end of the segment, or meets the disk and a sphere at the same point.
# There one ulp can flip the event between two correct float32 paths.  A
# ray whose status or hit id differs between the kernel and the plain loop
# must lie within EVENT_EPS (a length; the paths' x agree to TOL_X) of such
# an edge on some step, and at most MAX_EDGE of them per comparison.
EVENT_EPS = 1e-3
MAX_EDGE = 8
# The float32 conditioning of the event that ended a ray (event_kappa): a
# disk crossing's t = -z / (z1 - z0) moves by L / |z1 - z0| times a change
# of z, a sphere entry's t by |bb| / sqrt(disc) times a relative change of
# the quadratic's terms.  Rays whose event is worse conditioned than
# KAPPA_CALM -- shallow disk crossings, sphere grazes -- carry cotangents
# that two correct float32 paths part on; they are held to TOL_GRAD_EVENTS
# of the largest value, the other rays to TOL_GRAD.
KAPPA_CALM = 10.0
TOL_GRAD_EVENTS = 1e-2
POWERS = (1.5, 1.0, 2.0, 1.3)
DEVICE = "cuda"

FAILURES: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    """Record a failed check; the run fails after its last phase."""
    if not ok:
        FAILURES.append(msg)
        log(f"# FAILED: {msg}")


def phase(name: str, fn, *args):
    """Run one phase; an AssertionError inside it is recorded as a failed
    check and the phase returns None."""
    try:
        return fn(*args)
    except AssertionError as e:
        check(False, f"{name}: {e}")
        return None


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def flagship_cfg(backend="auto"):
    return P.RenderConfig(
        width=SIZE, height=SIZE, samples=1,
        integrator=P.IntegratorConfig(
            n_steps=100, dt=0.12, dt_boost=64.0, dt_boost_r_ref=1.7,
            dt_power=1.5, backend=backend),
        lam_max=100.0)


def make_sky(h=256, w=512, check=16):
    """The procedural equirect sky of the flagship (bench.py make_sky) and,
    at 32x64 with 8-pixel checks, of the goldens (tests/test_golden.py)."""
    v, u = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        0.5 + 0.5 * np.sin(2 * np.pi * u / w) * np.sin(np.pi * v / h),
        v / h,
        ((u // check + v // check) % 2).astype(np.float32)], -1)


def camera_fan(n, dev):
    """n camera-style rays, impact parameters b in [1.5, 2.45] u [2.75, 12]
    at z = 25, direction (0, 0, -1) (bench.py camera_fan)."""
    b = np.concatenate([np.linspace(1.5, 2.45, n // 2),
                        np.linspace(2.75, 12.0, n - n // 2)])
    ang = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    x0 = np.stack([b * np.cos(ang), b * np.sin(ang), np.full(n, 25.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    return f(x0), f(d0)


def ragged_batch(n, dev, seed=0):
    """n rays (not a multiple of the block size) with random impact
    parameters in the fan's bands, azimuths and start heights, a tenth of
    them starting inside the horizon (r_s = 1)."""
    rng = np.random.default_rng(seed)
    b = np.where(rng.random(n) < 0.5, rng.uniform(1.5, 2.45, n),
                 rng.uniform(2.75, 12.0, n))
    ang = rng.uniform(0.0, 2 * np.pi, n)
    x0 = np.stack([b * np.cos(ang), b * np.sin(ang),
                   rng.uniform(15.0, 30.0, n)], -1)
    inside = rng.random(n) < 0.1
    x0[inside] = rng.uniform(-0.5, 0.5, (int(inside.sum()), 3))
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    return f(x0), f(d0)


def initial_state(env, x0, d0):
    """The state ``launch`` integrates: null_init, INSIDE_HORIZON marked."""
    p0, E0 = null_init(x0, d0, env.mass)
    s0 = states.init_state(x0.contiguous(), p0, E0)
    s0.status = s0.status.masked_fill(env.radius(x0) <= env.r_capture,
                                      states.INSIDE_HORIZON)
    return s0


def rays(s, k):
    """The rays ``k`` (a mask or indices) of state ``s``."""
    return dataclasses.replace(s, x=s.x[k], p=s.p[k], E=s.E[k], lam=s.lam[k],
                               status=s.status[k], hit_obj=s.hit_obj[k])


def step_apart(env, cfg, a, b):
    """Align rays that end one step apart in the two paths.

    Where a ray's radius or affine parameter lands within rounding of
    r_escape or lam_max, the termination test can flip between two correct
    float32 paths: both end with the same status, one a step later.  The
    earlier one must then sit on that boundary; step it once more with the
    plain step so the two can be compared.  Returns (a, b, count)."""
    far = (a.lam - b.lam).abs() > TOL_X
    count = int(far.sum())
    if count > MAX_ALIGNED:
        raise AssertionError(f"{count} rays end a step apart "
                             f"(at most {MAX_ALIGNED})")

    def advance(s, mask):
        if not bool(mask.any()):
            return s
        sub = dataclasses.replace(rays(s, mask),
                                  status=torch.zeros_like(s.status[mask]))
        r = sub.x.norm(dim=-1)
        edge = (((r >= env.r_escape) & (r - env.r_escape <= TOL_X))
                | ((sub.lam >= env.lam_max)
                   & (sub.lam - env.lam_max <= TOL_X)))
        if not bool(edge.all()):
            raise AssertionError("rays end a step apart off a boundary")
        nxt = _fixed_step(env, cfg, sub)
        out = dataclasses.replace(s, x=s.x.clone(), p=s.p.clone(),
                                  lam=s.lam.clone(), status=s.status.clone())
        out.x[mask], out.p[mask] = nxt.x, nxt.p
        out.lam[mask], out.status[mask] = nxt.lam, nxt.status
        return out

    early_a = far & (a.lam < b.lam)
    early_b = far & (b.lam < a.lam)
    return advance(a, early_a), advance(b, early_b), count


def compare_states(env, cfg, a, b, what):
    """Kernel state ``a`` against plain state ``b``; returns the largest
    absolute error in x, p and lam and the count of rays aligned by
    step_apart."""
    st_a, st_b = a.status.cpu().numpy(), b.status.cpu().numpy()
    n_bad = int((st_a != st_b).sum())
    if n_bad:
        raise AssertionError(f"{what}: {n_bad} statuses differ")
    a, b, n_apart = step_apart(env, cfg, a, b)
    if not torch.equal(a.status, b.status):
        raise AssertionError(f"{what}: statuses differ after alignment")
    dx = float((a.x - b.x).abs().max())
    dp = float((a.p - b.p).abs().max())
    dl = float((a.lam - b.lam).abs().max())
    # angle between unit vectors as 2 asin(|a - b| / 2): arccos of the dot
    # product loses everything below ~3e-4 rad in float32
    chord = (final_direction(env, a) - final_direction(env, b)).norm(dim=-1)
    dang = float((2.0 * torch.asin((0.5 * chord.double()).clamp(max=1.0)))
                 .max())
    log(f"# parity [{what}] n={st_a.size} statuses equal, "
        f"{n_apart} end a step apart at a boundary; max|dx|={dx:.3e} "
        f"max|dp|={dp:.3e} max|dlam|={dl:.3e} max_dir={dang:.3e} rad")
    if not (dx <= TOL_X and dl <= TOL_X and dp <= TOL_P and dang <= TOL_DIR):
        raise AssertionError(
            f"{what}: outside tolerance (x/lam {TOL_X}, p {TOL_P}, "
            f"direction {TOL_DIR} rad)")
    return max(dx, dp, dl), n_apart


def near_b_c(env, s0):
    """Rays whose impact parameter L/E lies in [4.9, 5.5] M, the band the
    fan leaves out around b_c = 3 sqrt(3) M: they circle near the photon
    sphere, where each orbit multiplies a rounding difference by about
    e^(2 pi), so two correct float32 paths part."""
    b_imp = torch.linalg.cross(s0.x, s0.p, dim=-1).norm(dim=-1) / s0.E
    m = float(env.mass)
    return (b_imp >= 4.9 * m) & (b_imp <= 5.5 * m)


def compare_flagship(env, cfg, s0, a, b, what=None):
    """Kernel state ``a`` against plain state ``b`` for every flagship ray.

    Statuses must be equal everywhere.  Rays near b_c (see near_b_c) part
    by more than the state tolerances (up to 1.2e-2 in lam on an H100), so
    they are held to lam within half a step instead: a ray that took a step
    more or fewer in one path fails.  All other rays are held to the full
    tolerances of compare_states.  Returns (error, rays aligned, largest
    |d lam| in the band)."""
    what = what or f"{SIZE}x{SIZE} flagship"
    if not torch.equal(a.status, b.status):
        n_bad = int((a.status != b.status).sum())
        raise AssertionError(f"{what}: {n_bad} statuses differ")
    near = near_b_c(env, s0)
    err, n = compare_states(env, cfg, rays(a, ~near), rays(b, ~near),
                            f"{what}, away from b_c")
    dlam = float((a.lam[near] - b.lam[near]).abs().max())
    log(f"# parity [{what}, near b_c] n={int(near.sum())} statuses equal, "
        f"max|dlam|={dlam:.3e} (limit {0.5 * cfg.dt:g}, half a step)")
    if not dlam < 0.5 * cfg.dt:
        raise AssertionError(f"{what}: a ray near b_c is a step apart")
    return err, n, dlam


def image_rule(img, ref, what, max_mean, max_frac):
    """Mean |img - ref| below ``max_mean`` and a share of elements off by
    more than 0.1 below ``max_frac``."""
    diff = (img - ref).abs()
    mean, frac = float(diff.mean()), float((diff > 0.1).float().mean())
    log(f"# image [{what}] mean|d|={mean:.3e} frac(|d|>0.1)={frac:.3e} "
        f"(limits {max_mean:g}, {max_frac:g})")
    if not (mean < max_mean and frac < max_frac):
        raise AssertionError(f"{what}: image outside its limits")


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def timed(fn, runs=10):
    """Median host-clock ms of ``fn`` over ``runs`` runs after a warm-up,
    each run ending in a device synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def timed_backward(forward, runs=3):
    """Median host-clock ms of ``forward().backward()``'s backward alone."""
    times = []
    for _ in range(runs + 1):
        loss = forward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def profile(fn, runs=10):
    """torch.profiler over ``runs`` runs of ``fn`` after a warm-up."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return prof


def device_ms(fn, runs=10):
    """Median device ms of the kernels ``fn`` launches, between two CUDA
    events recorded around it behind a kernel that keeps the stream busy
    (torch.cuda._sleep), so that the host's launch overhead does not open
    gaps on the device between them."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def step_profile(step, wall, what, name_limit, runs=5):
    """Where a step's device time goes: the device kernels (and copies) the
    profiler records over ``runs`` steps, by name, against the step's wall
    time ``wall`` (ms)."""
    from torch.autograd import DeviceType

    prof = profile(step, runs=runs)
    by_name: dict[str, list[float]] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            t = by_name.setdefault(ev.name, [0.0, 0])
            t[0] += ev.time_range.elapsed_us() / runs / 1e3
            t[1] += 1
    total = sum(t for t, _ in by_name.values())
    log(f"# {what}, device busy {total:.3f} ms per step over "
        f"{sum(c for _, c in by_name.values()) // runs} kernel launches, "
        f"{100 * total / wall:.1f}% of the {wall:.3f} ms step (profiler, "
        f"mean of {runs}) [{name_limit}]")
    for key, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"#   {t:8.3f} ms {100 * t / max(total, 1e-9):5.1f}%  "
            f"x{c // runs:<4d} {key[:90]}")


# =============================================================================
# Phases.
# =============================================================================
def phase_build():
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"# phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
        f"-> {lib_path.relative_to(ROOT)}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or "error" in line):
            log(f"#   ptxas: {line.strip()}")


def fan_env(dev):
    return GeodesicEnv(
        mass=torch.tensor(0.5, device=dev),
        r_capture=torch.tensor(1.0, device=dev),
        r_escape=torch.tensor(70.0, device=dev),
        lam_max=torch.tensor(100.0, device=dev))


def phase_fwd(env, icfg, dev, readings):
    on = lambda b, **kw: dataclasses.replace(icfg, backend=b, **kw)  # noqa
    x0, d0 = camera_fan(FAN, dev)
    err, aligned = compare_states(
        env, icfg, P.launch(env, x0, d0, on("cuda")),
        P.launch(env, x0, d0, on("torch")), f"fan {FAN}")
    x0r, d0r = ragged_batch(1000, dev)
    for power in POWERS:
        sk = P.launch(env, x0r, d0r, on("cuda", dt_power=power))
        sp = P.launch(env, x0r, d0r, on("torch", dt_power=power))
        e, n = compare_states(env, on("torch", dt_power=power), sk, sp,
                              f"ragged 1000 power={power}")
        aligned += n
        if power == 1.5:
            err = max(err, e)
            inside = sk.status == states.INSIDE_HORIZON
            if not bool(inside.any()) or not torch.equal(sk.x[inside],
                                                         x0r[inside]):
                raise AssertionError("inside-horizon rays moved")

    golden = np.load(ROOT / "tests" / "golden" / "schwarzschild_sky.npz")
    ref = torch.as_tensor(golden["img"].astype(np.float32), device=dev)
    gs = make_sky(32, 64, check=8)
    gscene = P.Scene(bh=P.BlackHole.make(mass=0.5, device=dev),
                     background=torch.as_tensor(gs, dtype=torch.float32,
                                                device=dev))
    gcam = P.Camera.make(position=(0.0, 0.0, 20.0), fov=(0.7, 0.7),
                         device=dev)
    gcfg = P.RenderConfig(width=64, height=64, integrator=P.IntegratorConfig(
        n_steps=400, dt=0.08), lam_max=120.0)
    image_rule(P.render_image(gscene, gcam, gcfg), ref,
               "64x64 golden, kernel", GOLDEN_MEAN, GOLDEN_FRAC)
    readings["rk4_fwd"].update(max_abs_err=err, rays_aligned=aligned)
    log("# phase 2: rk4_fwd agrees with plain PyTorch on the card")


def phase_flagship_fwd(scene, cam, dev, readings):
    cfg, cfg_plain = flagship_cfg(), flagship_cfg(backend="torch")
    reset_counts()
    img = P.render_image(scene, cam, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    readings["rk4_fwd"]["launches"] = launches["rk4_fwd"]
    check(launches == only(rk4_fwd=1),
          f"forward render launched {launches}, expected rk4_fwd once")
    if img.shape != (SIZE, SIZE, 4) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"flagship image is not a finite {SIZE}x{SIZE}x4")
    with torch.no_grad():
        img_plain = P.render_image(scene, cam, cfg_plain)
    image_rule(img, img_plain, f"{SIZE}x{SIZE} flagship, kernel vs plain",
               FLAGSHIP_MEAN, FLAGSHIP_FRAC)

    # the flagship's rays themselves: some run all n_steps or end on the
    # budget, which the fan and the ragged batch never do
    fenv, s0 = flagship_rays(scene, cam, cfg, dev)
    with torch.no_grad():
        s = cuda_kernel.integrate_cuda(fenv, s0, cfg.integrator)
        e, n, dlam_near = compare_flagship(
            fenv, cfg.integrator, s0, s,
            cuda_kernel.integrate_plain(fenv, s0, cfg.integrator))
    r = readings["rk4_fwd"]
    r.update(max_abs_err=max(r.get("max_abs_err", 0.0), e),
             rays_aligned=r.get("rays_aligned", 0) + n,
             dlam_near_b_c=dlam_near)
    hist = torch.bincount(s.status.reshape(-1).long(), minlength=8).tolist()
    names = ("ACTIVE", "CAPTURED", "ESCAPED", "BUDGET", "DISK", "OBJECT",
             "INSIDE_HORIZON", "ERROR")
    log(f"# phase 3: flagship {SIZE}x{SIZE} rendered through rk4_fwd "
        f"(launches={launches}); statuses "
        + " ".join(f"{k}={v}" for k, v in zip(names, hist) if v))


def flagship_rays(scene, cam, cfg, dev):
    """The flagship's environment and initial ray state, as render_image
    builds them, with (SIZE, SIZE) batch shape."""
    ys, xs = pixel_grid(SIZE, SIZE, device=dev)
    o, d = generate_rays(cam, SIZE, SIZE, ys, xs)
    fenv = scene_env(scene, cfg, cam)
    return fenv, initial_state(fenv, o, d)


def flat_state(s):
    """``s`` as contiguous (n, ...) tensors, as the kernel wrappers take."""
    return dataclasses.replace(
        s, x=s.x.reshape(-1, 3).contiguous(),
        p=s.p.reshape(-1, 3).contiguous(), E=s.E.reshape(-1).contiguous(),
        lam=s.lam.reshape(-1).contiguous(),
        status=s.status.reshape(-1).contiguous(),
        hit_obj=s.hit_obj.reshape(-1).contiguous())


def reset_counts():
    for counter in COUNTERS.values():
        setattr(cuda_kernel, counter, 0)


def read_counts():
    return {name: getattr(cuda_kernel, counter)
            for name, counter in COUNTERS.items()}


def only(**launches):
    """The launch counts of a run that launched just ``launches``."""
    return {name: launches.get(name, 0) for name in COUNTERS}


def ckpt_rows(ck, k, s0):
    cx, cp, clam, cst = ck
    return dataclasses.replace(s0, x=cx[k], p=cp[k], lam=clam[k],
                               status=cst[k])


def event_kw(env, s0):
    """The event arguments of the kernel wrappers for ``env``."""
    return dict(sph=cuda_kernel._sphere_table(env, s0.x.device),
                has_disk=env.disk is not None, obj=s0.hit_obj)


def run_ckpt(env, cfg, s0):
    """rk4_fwd and rk4_ckpt on the flat state ``s0``."""
    scal = cuda_kernel._scalars(env, cfg, s0.x.device)
    n, pw = cfg.n_steps, float(cfg.dt_power)
    kw = event_kw(env, s0)
    fwd = cuda_kernel.rk4_fwd(scal, s0.x, s0.p, s0.E, s0.lam, s0.status, n,
                              pw, **kw)
    *fin, ck = cuda_kernel.rk4_ckpt(scal, s0.x, s0.p, s0.E, s0.lam,
                                    s0.status, n, cuda_kernel.segment(n), pw,
                                    **kw)
    return fwd, fin, ck


def phase_ckpt(env, icfg, scene, cam, dev, readings):
    """rk4_ckpt's final states against rk4_fwd's, and its checkpoint rows
    against the plain loop's states at the same steps."""
    err, bitwise = 0.0, True
    cases = [(f"fan {FAN}", initial_state(env, *camera_fan(FAN, dev)),
              icfg, env)]
    xr, dr = ragged_batch(1000, dev)
    cases += [(f"ragged 1000 power={pw}", initial_state(env, xr, dr),
               dataclasses.replace(icfg, dt_power=pw), env) for pw in POWERS]
    cfg = flagship_cfg()
    fenv, fs0 = flagship_rays(scene, cam, cfg, dev)
    cases.append((f"{SIZE}x{SIZE} flagship", flat_state(fs0), cfg.integrator,
                  fenv))
    for what, s0, c, e in cases:
        with torch.no_grad():
            fwd, fin, ck = run_ckpt(e, c, s0)
            same = all(torch.equal(a, b) for a, b in zip(fwd, fin))
            bitwise &= same
            final = dataclasses.replace(s0, x=fin[0], p=fin[1], lam=fin[2],
                                        status=fin[3])
            if not same:   # held to rk4_fwd's tolerances instead
                k1 = dataclasses.replace(s0, x=fwd[0], p=fwd[1], lam=fwd[2],
                                         status=fwd[3])
                err = max(err, compare_states(e, c, final, k1,
                                              f"{what}: rk4_ckpt vs rk4_fwd")
                          [0])
            seg = cuda_kernel.segment(c.n_steps)
            plain, rows = cuda_kernel.integrate_ckpt_plain(e, s0, c, seg)
            # rays that end a step apart at a boundary (phase 2) are
            # checked there; leave them out of the row comparisons
            keep = (final.lam - plain.lam).abs() <= TOL_X
            for k, row in enumerate(rows):
                a, b = ckpt_rows(ck, k, s0), row
                label = f"{what}: checkpoint row {k} (step {k * seg})"
                if "flagship" in what:
                    err = max(err, compare_flagship(e, c, s0, a, b, label)[0])
                else:
                    err = max(err, compare_states(e, c, rays(a, keep),
                                                  rays(b, keep), label)[0])
        log(f"# phase 4: [{what}] rk4_ckpt final state "
            + ("equals rk4_fwd's bit for bit" if same
               else "differs from rk4_fwd's (held to its tolerances)")
            + f"; {len(rows)} checkpoint rows of seg {seg} agree")
    readings["rk4_ckpt"].update(max_abs_err=err, equals_rk4_fwd=bitwise)


def weighted_x_loss(s, wx):
    """The loss of tests/test_pallas.py:82-92: a weighted sum of final
    positions over rays neither CAPTURED nor ERROR."""
    ok = ((s.status != states.CAPTURED) & (s.status != states.ERROR))
    return torch.where(ok[..., None], wx * s.x, 0.0).sum()


def integrator_grads(env, s0, cfg, loss_fn, kernel):
    """Cotangents of (x, p, E) of ``s0`` and of the mass, for
    ``loss_fn(final state)``, through the kernels or the plain loop."""
    mass = env.mass.detach().clone().requires_grad_(True)
    e = dataclasses.replace(env, mass=mass)
    x, p, E = (t.detach().clone().requires_grad_(True)
               for t in (s0.x, s0.p, s0.E))
    s = dataclasses.replace(s0, x=x, p=p, E=E)
    out = (cuda_kernel.integrate_cuda(e, s, cfg) if kernel
           else cuda_kernel.integrate_plain(e, s, cfg))
    loss_fn(out).backward()
    return out, (x.grad, p.grad, E.grad, mass.grad)


def compare_grads(out_k, gk, out_p, gp, what):
    """Per-ray cotangents of x, p, E and the mass cotangent, kernel against
    plain; rays that end a step apart at a boundary are left out."""
    keep = (out_k.lam - out_p.lam).abs() <= TOL_X
    errs = [rel_err(a[keep], b[keep]) for a, b in zip(gk[:3], gp[:3])]
    dm = abs(float(gk[3]) / float(gp[3]) - 1.0)
    log(f"# grad [{what}] n={int(keep.sum())} of {keep.numel()}: "
        f"x {errs[0]:.3e} p {errs[1]:.3e} E {errs[2]:.3e} "
        f"(max |d| / max |plain|), mass {float(gk[3]):.7g} vs "
        f"{float(gp[3]):.7g} (rel {dm:.3e})")
    check(max(errs) <= TOL_GRAD and dm <= TOL_GRAD_MASS,
          f"{what}: cotangents outside tolerance ({TOL_GRAD:g}, mass "
          f"{TOL_GRAD_MASS:g})")
    return max(errs + [dm])


def phase_bwd(env, icfg, dev, readings):
    """rk4_bwd against autograd of the plain loop on the card."""
    rng = np.random.default_rng(2)
    cases = [(f"fan {FAN}", camera_fan(FAN, dev), icfg),
             (f"fan {FAN}, 40 steps",
              camera_fan(FAN, dev), dataclasses.replace(icfg, n_steps=40))]
    rb = ragged_batch(1000, dev)
    cases += [(f"ragged 1000 power={pw}", rb,
               dataclasses.replace(icfg, dt_power=pw)) for pw in POWERS]
    err = 0.0
    for what, (x0, d0), c in cases:
        s0 = initial_state(env, x0, d0)
        wx = torch.as_tensor(rng.normal(size=tuple(x0.shape)),
                             dtype=torch.float32, device=dev)
        loss = lambda s: weighted_x_loss(s, wx)  # noqa: E731
        out_k, gk = integrator_grads(env, s0, c, loss, kernel=True)
        out_p, gp = integrator_grads(env, s0, c, loss, kernel=False)
        active = int((out_k.status == states.ACTIVE).sum())
        err = max(err, compare_grads(out_k, gk, out_p, gp,
                                     f"{what}, {active} ACTIVE at the end"))
    readings["rk4_bwd"]["max_abs_err"] = err
    log("# phase 5: rk4_bwd agrees with autograd of the plain loop")


def render_grads(scene0, cam0, cfg, mask=None):
    """d mean(img[..., :3]^2) (bench.py:385-391) / d (mass, camera
    position, sky); ``mask`` (H, W) weights the pixels."""
    scene = dataclasses.replace(
        scene0,
        bh=dataclasses.replace(
            scene0.bh, mass=scene0.bh.mass.detach().clone()
            .requires_grad_(True)),
        background=scene0.background.detach().clone().requires_grad_(True))
    cam = dataclasses.replace(
        cam0, position=cam0.position.detach().clone().requires_grad_(True))
    sq = P.render_image(scene, cam, cfg)[..., :3].pow(2)
    if mask is not None:
        sq = sq * mask[..., None]
    sq.mean().backward()
    return scene.bh.mass.grad, cam.position.grad, scene.background.grad


def compare_render_grads(gk, gp, what, tol):
    errs = [rel_err(a, b) for a, b in zip(gk, gp)]
    log(f"# grad [{what}] mass {float(gk[0]):.7g} vs {float(gp[0]):.7g} "
        f"(rel {errs[0]:.3e}); camera {gk[1].tolist()} vs {gp[1].tolist()} "
        f"({errs[1]:.3e}); sky {errs[2]:.3e} (max |d| / max |plain|)")
    check(max(errs) <= tol, f"{what}: gradients outside tolerance {tol:g}")
    return errs


def shade_loss(scene, env, s, n_pix):
    """The render's loss as a function of the integrator's final state."""
    rgb = shade(_bh_frame(scene), s, final_direction(env, s))
    return rgb.pow(2).sum() / (3 * n_pix)


def phase_flagship_grad(scene, cam, dev, readings):
    cfg, cfg_plain = flagship_cfg(), flagship_cfg(backend="torch")
    # the main path: the gradient of the flagship frame
    reset_counts()
    gk = render_grads(scene, cam, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    for name in ("rk4_ckpt", "rk4_bwd"):
        readings[name]["launches"] = launches[name]
    check(launches == only(rk4_ckpt=1, rk4_bwd=1),
          f"forward+backward launched {launches}, expected rk4_ckpt and "
          "rk4_bwd once each and rk4_fwd never")
    for g in gk:
        check(bool(torch.isfinite(g).all()), "flagship gradient not finite")
    gp = render_grads(scene, cam, cfg_plain)
    compare_render_grads(gk, gp, f"{SIZE}x{SIZE} flagship, kernel vs plain",
                         TOL_FLAGSHIP_GRAD)

    # how much of it the rays circling the photon sphere carry
    fenv, s0 = flagship_rays(scene, cam, cfg, dev)
    away = (~near_b_c(fenv, s0)).float()
    gk_away = render_grads(scene, cam, cfg, away)
    gp_away = render_grads(scene, cam, cfg_plain, away)
    # the loss is linear in the pixel weights: full = away + band
    share = [float((gk[i] - gk_away[i]).norm() / gk[i].norm())
             for i in (0, 1)]
    log(f"# grad [{SIZE}x{SIZE} flagship] the {int((away == 0).sum())} "
        f"pixels near b_c carry |g_band| / |g| = {share[0]:.3e} of the mass "
        f"gradient and {share[1]:.3e} of the camera gradient (kernel path)")
    compare_render_grads(gk_away, gp_away,
                         f"{SIZE}x{SIZE} flagship away from b_c, kernel vs "
                         "plain (a reading)", float("inf"))
    # ... and away from the sky's pole too, where the gradient is well
    # conditioned: held tightly
    with torch.no_grad():
        end = final_direction(fenv, cuda_kernel.integrate_plain(
            fenv, s0, cfg.integrator))
    rho = end[..., :2].norm(dim=-1)
    calm = (away.bool() & (rho >= POLE_RHO)).float()
    log(f"# grad [{SIZE}x{SIZE} flagship] {int((rho < POLE_RHO).sum())} "
        f"rays end within {POLE_RHO:g} rad of the sky's pole")
    compare_render_grads(render_grads(scene, cam, cfg, calm),
                         render_grads(scene, cam, cfg_plain, calm),
                         f"{SIZE}x{SIZE} flagship away from b_c and the "
                         "pole, kernel vs plain", TOL_CALM_GRAD)

    # the float32 conditioning of that gradient: the plain path against
    # itself with the camera moved by one ulp in z
    cam_ulp = dataclasses.replace(cam, position=cam.position.clone())
    cam_ulp.position[2] = torch.nextafter(cam.position[2],
                                          cam.position[2] + 1)
    compare_render_grads(render_grads(scene, cam_ulp, cfg_plain), gp,
                         f"{SIZE}x{SIZE} flagship, plain vs plain with the "
                         "camera one ulp away (a reading)", float("inf"))
    compare_render_grads(render_grads(scene, cam_ulp, cfg_plain, away),
                         gp_away, f"{SIZE}x{SIZE} flagship away from b_c, "
                         "plain vs plain one ulp away (a reading)",
                         float("inf"))

    # per-ray cotangents of the integrator's inputs, away from b_c, for a
    # loss smooth in the final state (weighted positions and directions)
    near = near_b_c(fenv, s0)
    wx, wd = (torch.as_tensor(np.random.default_rng(k).normal(
        size=(SIZE, SIZE, 3)), dtype=torch.float32, device=dev)
        for k in (4, 5))

    def smooth(s):
        ok = (s.status != states.CAPTURED) & (s.status != states.ERROR)
        f = wx * s.x + wd * final_direction(fenv, s)
        return torch.where(ok[..., None], f, 0.0).sum()

    out_k, rk = integrator_grads(fenv, s0, cfg.integrator, smooth, True)
    out_p, rp = integrator_grads(fenv, s0, cfg.integrator, smooth, False)
    errs = [rel_err(a[~near], b[~near]) for a, b in zip(rk[:3], rp[:3])]
    log(f"# grad [{SIZE}x{SIZE} flagship rays away from b_c, smooth loss] "
        f"per-ray cotangents x {errs[0]:.3e} p {errs[1]:.3e} E "
        f"{errs[2]:.3e}; near b_c: x "
        f"{rel_err(rk[0][near], rp[0][near]):.3e} (max |d| / max |plain|)")
    check(max(errs) <= TOL_GRAD,
          f"flagship per-ray cotangents away from b_c outside {TOL_GRAD:g}")

    # the render's own loss per ray: where it parts, and how near the pole
    loss = lambda s: shade_loss(scene, fenv, s, SIZE * SIZE)  # noqa: E731
    _, rk = integrator_grads(fenv, s0, cfg.integrator, loss, True)
    _, rp = integrator_grads(fenv, s0, cfg.integrator, loss, False)
    bad = ((rk[0] - rp[0]).abs().amax(-1)
           > 1e-3 * rp[0][~near].abs().max()) & ~near
    far = float(rho[bad].max()) if bool(bad.any()) else 0.0
    log(f"# grad [{SIZE}x{SIZE} flagship rays away from b_c, render loss] "
        f"per-ray x cotangent {rel_err(rk[0][~near], rp[0][~near]):.3e}; "
        f"{int(bad.sum())} rays differ by > 1e-3 of the largest, all within "
        f"{far:.3e} rad of the sky's pole (a reading)")

    # the scalar cotangents from rk4_bwd are the same bit for bit
    rng = np.random.default_rng(3)
    gx, gpp = (torch.as_tensor(rng.normal(size=(SIZE * SIZE, 3)),
                               dtype=torch.float32, device=dev)
               for _ in range(2))
    flat, icfg = flat_state(s0), cfg.integrator
    with torch.no_grad():
        _, _, ck = run_ckpt(fenv, icfg, flat)
        runs = [cuda_kernel.rk4_bwd(
            cuda_kernel._scalars(fenv, icfg, dev), ck, flat.E, gx, gpp,
            icfg.n_steps, cuda_kernel.segment(icfg.n_steps), icfg.dt_power)
            for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    gk2 = render_grads(scene, cam, cfg)
    sky_spread = float((gk2[2] - gk[2]).abs().max() / gk[2].abs().max())
    mass_same = "equal" if torch.equal(gk2[0], gk[0]) else "differs"
    log(f"# determinism: two rk4_bwd runs on the flagship rays give "
        + ("bitwise-equal" if same else "DIFFERENT")
        + f" outputs (mass cotangent {float(runs[0][3][0]):.9g}); two "
        f"flagship gradients: mass {mass_same}, sky spread max|d|/max|g| = "
        f"{sky_spread:.3e}")
    check(same, "rk4_bwd is not deterministic from run to run")
    readings["rk4_bwd"]["sky_grad_spread"] = sky_spread
    log("# phase 6: flagship gradient through rk4_ckpt and rk4_bwd agrees "
        "with the plain path")


def phase_times(scene, cam, dev, name_limit, readings):
    cfg, cfg_plain = flagship_cfg(), flagship_cfg(backend="torch")
    rays_n = SIZE * SIZE
    fenv, s0 = flagship_rays(scene, cam, cfg, dev)
    icfg = cfg.integrator
    flat = flat_state(s0)
    scal = cuda_kernel._scalars(fenv, icfg, dev)
    seg = cuda_kernel.segment(icfg.n_steps)
    args = (scal, flat.x, flat.p, flat.E, flat.lam, flat.status)

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    fwd_render = no_grad(lambda: P.render_image(scene, cam, cfg))
    step = lambda: render_grads(scene, cam, cfg)  # noqa: E731
    ms = {
        "forward render (kernel)": timed(fwd_render),
        "forward+backward step (kernels)": timed(step),
        "rk4_fwd call": timed(no_grad(lambda: cuda_kernel.rk4_fwd(
            *args, icfg.n_steps, 1.5))),
        "rk4_ckpt call": timed(no_grad(lambda: cuda_kernel.rk4_ckpt(
            *args, icfg.n_steps, seg, 1.5))),
    }
    with torch.no_grad():
        ck = cuda_kernel.rk4_ckpt(*args, icfg.n_steps, seg, 1.5)[-1]
    g = torch.ones_like(flat.x)
    bwd = no_grad(lambda: cuda_kernel.rk4_bwd(scal, ck, flat.E, g, g,
                                              icfg.n_steps, seg, 1.5))
    ms["rk4_bwd call"] = timed(bwd)
    ms["plain integrator, forward"] = timed(no_grad(
        lambda: cuda_kernel.integrate_plain(fenv, s0, icfg)))
    ms["forward render (plain)"] = timed(no_grad(
        lambda: P.render_image(scene, cam, cfg_plain)))
    ms["forward+backward step (plain)"] = timed(
        lambda: render_grads(scene, cam, cfg_plain), runs=3)

    # the plain versions of rk4_ckpt and rk4_bwd: the checkpointed plain
    # loop's forward under autograd, and its backward
    def plain_forward():
        x = flat.x.detach().clone().requires_grad_(True)
        s = dataclasses.replace(flat, x=x)
        return cuda_kernel.integrate_plain(fenv, s, icfg).x.sum()

    ms["plain checkpointed loop, forward (rk4_ckpt's plain)"] = timed(
        plain_forward, runs=3)
    ms["plain checkpointed loop, backward (rk4_bwd's plain)"] = \
        timed_backward(plain_forward, runs=3)
    for what, v in ms.items():
        log(f"# phase 7: {what} {SIZE}x{SIZE}: median {v:.3f} ms, "
            f"{rays_n / (v * 1e-3):.4e} rays/s [{name_limit}]")
    ms_scal = timed(lambda: cuda_kernel._scalars(fenv, icfg, dev))
    dev_ms = {
        "rk4_fwd": device_ms(no_grad(
            lambda: cuda_kernel.rk4_fwd(*args, icfg.n_steps, 1.5))),
        "rk4_ckpt": device_ms(no_grad(
            lambda: cuda_kernel.rk4_ckpt(*args, icfg.n_steps, seg, 1.5))),
        "rk4_bwd": device_ms(bwd),
    }
    log(f"# phase 7: scalar vector {ms_scal:.3f} ms (host, median); device "
        "time (CUDA events, median of 10): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in dev_ms.items())
        + f" [{name_limit}]")

    # where the forward+backward step's device time goes: the device
    # kernels (and copies) the profiler records, by name
    step_profile(step, ms["forward+backward step (kernels)"],
                 "phase 7: forward+backward step", name_limit)

    readings["rk4_fwd"].update(ms=ms["rk4_fwd call"],
                               device_ms=dev_ms["rk4_fwd"],
                               plain_ms=ms["plain integrator, forward"])
    readings["rk4_ckpt"].update(
        ms=ms["rk4_ckpt call"], device_ms=dev_ms["rk4_ckpt"],
        plain_ms=ms["plain checkpointed loop, forward (rk4_ckpt's plain)"])
    readings["rk4_bwd"].update(
        ms=ms["rk4_bwd call"], device_ms=dev_ms["rk4_bwd"],
        plain_ms=ms["plain checkpointed loop, backward (rk4_bwd's plain)"])
    readings["step"] = {"fwd_bwd_ms": ms["forward+backward step (kernels)"],
                        "fwd_bwd_plain_ms":
                            ms["forward+backward step (plain)"],
                        "fwd_ms": ms["forward render (kernel)"]}


# =============================================================================
# The event variants: a z = 0 disk and spheres.
# =============================================================================
def bench_moons():
    """The four moons of bench.py's events scene (:132-136): centres at
    radius 7 and radii 0.6, 0.5, 0.7, 0.4."""
    ang = np.array([0.3, 1.9, 3.6, 5.2])
    centers = np.stack([7 * np.cos(ang), 7 * np.sin(ang),
                        0.8 * np.sin(2 * ang)], -1)
    return centers, [0.6, 0.5, 0.7, 0.4]


def events_fan(n, dev, seed=5):
    """n camera-style rays from z = 25, direction (0, 0, -1), through
    points spread evenly (seeded) over the circle of radius 9 that holds
    the disk and the moons of bench.py's events scene."""
    rng = np.random.default_rng(seed)
    r = 9.0 * np.sqrt(rng.random(n))
    ang = rng.uniform(0.0, 2 * np.pi, n)
    x0 = np.stack([r * np.cos(ang), r * np.sin(ang), np.full(n, 25.0)], -1)
    d0 = np.tile([0.0, 0.0, -1.0], (n, 1))
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    return f(x0), f(d0)


def with_events(env, centers=None, radii=None, disk=True):
    """``env`` with the events scene's disk (r_in 2, r_out 6) and spheres
    (bench.py's moons unless given)."""
    dev = env.mass.device
    if centers is None:
        centers, radii = bench_moons()
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,  # noqa
                                  device=dev)
    return dataclasses.replace(
        env, disk=DiskGeom(r_in=f(2.0), r_out=f(6.0))
        if disk else None,
        spheres=SphereGeom(center=f(centers), radius=f(radii)))


def guard_stress(n, dev):
    """The Schwarzschild case of tests/test_pallas.py's sphere-guard stress
    test (:356-384), with ``n`` of its rays: spheres at the photon sphere
    and far out, its environment and step schedule."""
    rng = np.random.default_rng(7)
    x0 = np.stack([rng.uniform(-8, 8, n), rng.uniform(-8, 8, n),
                   np.full(n, 25.0)], -1)
    d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  np.full(n, -1.0)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    env = GeodesicEnv(mass=torch.tensor(0.5, device=dev),
                      r_capture=torch.tensor(1.0, device=dev),
                      r_escape=torch.tensor(60.0, device=dev),
                      lam_max=torch.tensor(60.0, device=dev))
    env = with_events(env, [[0.0, 2.6, 0.0], [0.0, 0.0, 30.0]], [0.7, 2.0],
                      disk=False)
    cfg = P.IntegratorConfig(n_steps=64, dt=0.1, dt_boost=64.0,
                             dt_boost_r_ref=1.7, dt_power=1.5)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa
    return env, cfg, f(x0), f(d)


def long_step_spheres(env):
    """``env`` with the disk and eight spheres of radius 0.4 at z = 12..18,
    across events_fan's path, where the r^1.5 schedule makes a step 3-5 long:
    a ray enters a sphere with its step's end far outside the sphere's
    shell, so the guard's band must reach a whole step beyond it."""
    b = np.array([3.0, 5.0, 8.0, 11.0, 4.0, 6.5, 9.5, 2.8])
    ang = np.array([0.4, 2.0, 3.5, 5.0, 1.2, 2.8, 4.3, 5.8])
    z = np.array([12.0, 14.0, 16.0, 18.0, 13.0, 15.0, 17.0, 12.5])
    centers = np.stack([b * np.cos(ang), b * np.sin(ang), z], -1)
    return with_events(env, centers, [0.4] * 8)


def event_margin(env, cfg, s0):
    """Per ray, the least distance to an event's edge over the plain
    loop's steps from ``s0``: the distance of a segment's end from z = 0,
    of a crossing from r_in and r_out, of a segment's closest approach
    from a sphere's surface, of a sphere entry from the segment's ends, and
    between a disk crossing and a sphere entry on one segment."""
    inf = torch.full_like(s0.lam, float("inf"))
    margin, s = inf, s0
    with torch.no_grad():
        for _ in range(cfg.n_steps):
            act = s.active
            if not bool(act.any()):
                break
            dt = _dt_eff(env, cfg, s)
            y, _ = rk4_step(env, s.x, s.p, s.E, dt)
            x, D = s.x, y - s.x
            L = D.norm(dim=-1)
            m = inf
            t_disk = t_sph = inf
            if env.disk is not None:
                z0, z1 = x[..., 2], y[..., 2]
                m = torch.minimum(m, torch.minimum(z0.abs(), z1.abs()))
                t = -z0 / torch.where(D[..., 2] != 0, D[..., 2], 1.0)
                pt = x + D * t[..., None]
                rr = pt[..., :2].norm(dim=-1)
                edge = torch.minimum((rr - env.disk.r_in).abs(),
                                     (rr - env.disk.r_out).abs())
                m = torch.minimum(m, torch.where(z0 * z1 <= 0, edge, inf))
                t_disk, _ = _disk_event(env, x, y)
            if env.spheres is not None:
                aa = (D * D).sum(-1).clamp_min(1e-30)
                for c, r in zip(env.spheres.center, env.spheres.radius):
                    o = x - c
                    bb = 2.0 * (o * D).sum(-1)
                    cc = (o * o).sum(-1) - r * r
                    disc = bb * bb - 4.0 * aa * cc
                    tc = -bb / (2.0 * aa)        # closest approach
                    graze = (disc / (4.0 * aa)).abs() / (2.0 * r)
                    m = torch.minimum(m, torch.where((tc >= 0) & (tc <= 1),
                                                     graze, inf))
                    t = (-bb - disc.clamp_min(0).sqrt()) / (2.0 * aa)
                    ends = torch.minimum(t.abs(), (1.0 - t).abs()) * L
                    m = torch.minimum(m, torch.where(disc > 0, ends, inf))
                t_sph, _, _ = _sphere_events(env, x, y)
            if env.disk is not None and env.spheres is not None:
                both = torch.isfinite(t_disk) & torch.isfinite(t_sph)
                m = torch.minimum(m, torch.where(
                    both, (t_disk - t_sph).abs() * L, inf))
            margin = torch.where(act, torch.minimum(margin, m), margin)
            s = _fixed_step(env, cfg, s)
    return margin


def event_kappa(env, cfg, s0):
    """Per ray, the float32 conditioning of the event that ended it on the
    plain loop from ``s0`` (see KAPPA_CALM): L / |z1 - z0| for a disk
    crossing, |bb| / sqrt(disc) for a sphere entry, 1 for other rays."""
    kappa, s = torch.ones_like(s0.lam), s0
    with torch.no_grad():
        for _ in range(cfg.n_steps):
            act = s.active
            if not bool(act.any()):
                break
            y, _ = rk4_step(env, s.x, s.p, s.E, _dt_eff(env, cfg, s))
            D = y - s.x
            L = D.norm(dim=-1)
            s1 = _fixed_step(env, cfg, s)
            disk = act & (s1.status == states.DISK)
            kappa = torch.where(disk, L / D[..., 2].abs().clamp_min(1e-30),
                                kappa)
            obj = act & (s1.status == states.OBJECT)
            if bool(obj.any()):
                k = s1.hit_obj.clamp_min(0).long()
                o = s.x - env.spheres.center[k]
                r = env.spheres.radius[k]
                aa = (D * D).sum(-1)
                bb = 2.0 * (o * D).sum(-1)
                disc = bb * bb - 4.0 * aa * ((o * o).sum(-1) - r * r)
                kappa = torch.where(obj, bb.abs() / disc.clamp_min(1e-30)
                                    .sqrt(), kappa)
            s = s1
    return kappa


def split_edges(env, cfg, s0, a, b, what):
    """The rays whose status or hit id differs between the kernel state
    ``a`` and the plain state ``b``: each must touch an event's edge within
    EVENT_EPS, and at most MAX_EDGE of them.  Returns (the mask of the
    other rays, their count, the largest margin among them)."""
    flip = (a.status != b.status) | (a.hit_obj != b.hit_obj)
    n = int(flip.sum())
    worst = 0.0
    if n:
        if n > MAX_EDGE:
            raise AssertionError(f"{what}: {n} statuses or hit ids differ "
                                 f"(at most {MAX_EDGE} edge rays)")
        margin = event_margin(env, cfg, rays(s0, flip))
        worst = float(margin.max())
        if not worst <= EVENT_EPS:
            raise AssertionError(
                f"{what}: a ray whose status differs is {worst:.3e} from "
                f"any event's edge (limit {EVENT_EPS:g})")
    return ~flip, n, worst


def compare_events(env, cfg, s0, a, b, what):
    """compare_flagship for the event variant: statuses and hit ids equal
    apart from the edge rays of split_edges, which are counted, capped and
    left out; rays near b_c held to lam within half a step, the others to
    the state tolerances.  Returns (error, rays aligned a step apart, edge
    rays)."""
    keep, n_edge, worst = split_edges(env, cfg, s0, a, b, what)
    a, b, s0k = rays(a, keep), rays(b, keep), rays(s0, keep)
    err, n, _ = compare_flagship(env, cfg, s0k, a, b, what)
    hist = torch.bincount(b.status.reshape(-1).long(), minlength=8).tolist()
    log(f"# events [{what}] {n_edge} edge rays left out (largest margin "
        f"{worst:.3e}); hit ids equal; DISK {hist[4]} OBJECT {hist[5]}")
    if not (hist[4] or hist[5]):
        raise AssertionError(f"{what}: no ray ended on the disk or a sphere")
    return err, n, n_edge


def golden_event_scenes(dev):
    """tests/test_golden.py's einstein_ring and disk_and_moons (:53-65)."""
    sky = torch.as_tensor(make_sky(32, 64, check=8), dtype=torch.float32,
                          device=dev)
    bh = P.BlackHole.make(mass=0.5, device=dev)
    moon = np.tile(np.float32([0.2, 1.0, 0.2]), (2, 8, 8, 1))
    yield "einstein_ring", (
        P.Scene(bh=bh, background=sky, spheres=P.Spheres.make(
            center=[[0.0, 0.0, -12.0]], radius=[1.0], texture=moon[:1],
            device=dev)),
        P.Camera.make(position=(0.0, 0.0, 20.0), fov=(0.9, 0.9), device=dev))
    yield "disk_and_moons", (
        P.Scene(bh=bh, background=sky,
                disk=P.Disk.make(r_in=2.0, r_out=6.0, device=dev,
                                 texture=np.tile(np.float32([1.0, 0.6, 0.2]),
                                                 (8, 32, 1))),
                spheres=P.Spheres.make(
                    center=[[6.0, 2.0, 6.0], [-5.0, -2.0, -8.0]],
                    radius=[0.8, 0.8], texture=moon, device=dev)),
        P.Camera.make(position=(0.0, 6.0, 19.0), euler=(-0.3, 0.0, 0.0),
                      fov=(0.9, 0.9), device=dev))


def event_batches(env, icfg, dev):
    """(label, environment, config, initial state) of the event phases."""
    on = lambda **kw: dataclasses.replace(icfg, **kw)  # noqa: E731
    eenv = with_events(env)
    out = [(f"events fan {FAN}", eenv, icfg,
            initial_state(eenv, *events_fan(FAN, dev)))]
    xr, dr = ragged_batch(1000, dev)
    out += [(f"events ragged 1000 power={pw}", eenv, on(dt_power=pw),
             initial_state(eenv, xr, dr)) for pw in POWERS]
    genv, gcfg, xg, dg = guard_stress(FAN, dev)
    out.append((f"guard stress {FAN}", genv, gcfg,
                initial_state(genv, xg, dg)))
    lenv = long_step_spheres(env)
    out.append((f"long-step spheres, fan {FAN}", lenv, icfg,
                initial_state(lenv, *events_fan(FAN, dev))))
    return out


def phase_events_fwd(env, icfg, dev, readings):
    """rk4_fwd's event variant against the plain loop on the card."""
    err, aligned, edges = 0.0, 0, 0
    for what, e, c, s0 in event_batches(env, icfg, dev):
        with torch.no_grad():
            sk = cuda_kernel.integrate_cuda(e, s0, c)
            sp = cuda_kernel.integrate_plain(e, s0, c)
        got = phase(f"phase 8 (rk4_fwd events vs plain, {what})",
                    compare_events, e, c, s0, sk, sp, what)
        if got is not None:
            err, aligned, edges = (max(err, got[0]), aligned + got[1],
                                   edges + got[2])
    for name, (scene, cam) in golden_event_scenes(dev):
        golden = np.load(ROOT / "tests" / "golden" / f"{name}.npz")
        ref = torch.as_tensor(golden["img"].astype(np.float32), device=dev)
        gcfg = P.RenderConfig(width=64, height=64, lam_max=120.0,
                              integrator=P.IntegratorConfig(n_steps=400,
                                                            dt=0.08))
        reset_counts()
        img = P.render_image(scene, cam, gcfg)
        check(read_counts() == only(rk4_fwd_events=1),
              f"golden {name} launched {read_counts()}")
        image_rule(img, ref, f"64x64 golden {name}, kernel", GOLDEN_MEAN,
                   GOLDEN_FRAC)
    readings["rk4_fwd_events"].update(max_abs_err=err, rays_aligned=aligned,
                                      edge_rays=edges)
    log("# phase 8: rk4_fwd's event variant agrees with plain PyTorch on "
        "the card")


def events_scene(dev, moon_tex=None):
    """bench.py's make_scene('events') (:126-141) on ``dev``: the flagship
    sky, a z = 0 disk (r_in 2, r_out 6) with a 64x256 texture and the
    four moons, one colour unless ``moon_tex`` is given."""
    v, u = np.meshgrid(np.arange(64), np.arange(256), indexing="ij")
    disk_tex = np.stack([0.9 + 0 * u, 0.5 + 0.3 * np.sin(8 * np.pi * u / 256),
                         0.2 + 0 * u], -1)
    centers, radii = bench_moons()
    if moon_tex is None:
        moon_tex = np.tile(np.float32([0.3, 0.9, 0.4]), (4, 16, 32, 1))
    return P.Scene(
        bh=P.BlackHole.make(mass=0.5, device=dev),
        background=torch.as_tensor(make_sky(), dtype=torch.float32,
                                   device=dev),
        disk=P.Disk.make(r_in=2.0, r_out=6.0, texture=disk_tex, device=dev),
        spheres=P.Spheres.make(center=centers, radius=radii,
                               texture=moon_tex, device=dev))


def events_cam(dev):
    """bench.py's camera for the events rows (:1023-1027): (0, 0, 25),
    tilted by 0.25 rad about x, fov 0.8."""
    return P.Camera.make(position=(0.0, 0.0, 25.0), euler=(0.25, 0.0, 0.0),
                         fov=(0.8, 0.8), device=dev)


def varying_moons():
    """A moon texture that varies over the surface: the bench's is one
    colour, so its image does not depend on where a moon is hit and the
    gradient to a moon's centre and radius is zero."""
    v, u = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
    tex = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * u / 32),
                    0.5 + 0.4 * np.cos(np.pi * v / 16), 0.5 + 0 * u], -1)
    return np.tile(tex.astype(np.float32), (4, 1, 1, 1))


def phase_events_ckpt(env, icfg, dev, readings):
    """rk4_ckpt's event variant against rk4_fwd's, and its checkpoint rows
    against the plain loop's states at the same steps."""
    err, bitwise = 0.0, True
    cases = event_batches(env, icfg, dev)
    cfg = flagship_cfg()
    fenv, fs0 = flagship_rays(events_scene(dev), events_cam(dev), cfg, dev)
    cases.append((f"{SIZE}x{SIZE} events", fenv, cfg.integrator,
                  flat_state(fs0)))
    for what, e, c, s0 in cases:
        with torch.no_grad():
            fwd, fin, ck = run_ckpt(e, c, s0)
            same = all(torch.equal(a, b) for a, b in zip(fwd, fin))
            bitwise &= same
            if not same:
                ray_diff = torch.zeros_like(fin[2], dtype=torch.bool)
                for a, b in zip(fwd, fin):
                    ne = a != b
                    ray_diff |= ne.reshape(ne.shape[0], -1).any(-1)
                k = ray_diff.nonzero()[:, 0]
                log(f"# phase 9: [{what}] {k.numel()} rays differ between "
                    f"rk4_ckpt and rk4_fwd: statuses {fin[3][k][:8].tolist()}"
                    f" vs {fwd[3][k][:8].tolist()}, max|dx| "
                    f"{float((fin[0] - fwd[0]).abs().max()):.3e}, max|dlam| "
                    f"{float((fin[2] - fwd[2]).abs().max()):.3e}")
            check(same, f"{what}: rk4_ckpt's final state differs from "
                  "rk4_fwd's")
            final = dataclasses.replace(s0, x=fin[0], p=fin[1], lam=fin[2],
                                        status=fin[3], hit_obj=fin[4])
            seg = cuda_kernel.segment(c.n_steps)
            plain, rows = cuda_kernel.integrate_ckpt_plain(e, s0, c, seg)
            # edge rays and rays a step apart (phase 8) are checked there
            keep = ((final.status == plain.status)
                    & (final.hit_obj == plain.hit_obj)
                    & ((final.lam - plain.lam).abs() <= TOL_X))
            for k, row in enumerate(rows):
                a, b = ckpt_rows(ck, k, s0), row
                label = f"{what}: checkpoint row {k} (step {k * seg})"
                err = max(err, compare_flagship(
                    e, c, rays(s0, keep), rays(a, keep), rays(b, keep),
                    label)[0])
        log(f"# phase 9: [{what}] rk4_ckpt's event variant "
            + ("equals rk4_fwd's bit for bit" if same else "DIFFERS")
            + f"; {len(rows)} checkpoint rows of seg {seg} agree "
            f"({int((~keep).sum())} rays left to phase 8)")
    readings["rk4_ckpt_events"].update(max_abs_err=err,
                                       equals_rk4_fwd=bitwise)


def event_grads(env, s0, cfg, loss_fn, kernel):
    """Cotangents of (x, p, E) of ``s0``, of the mass and of the (K, 4)
    sphere table [centre, radius], through the kernels or the plain loop."""
    mass = env.mass.detach().clone().requires_grad_(True)
    center = env.spheres.center.detach().clone().requires_grad_(True)
    radius = env.spheres.radius.detach().clone().requires_grad_(True)
    e = dataclasses.replace(env, mass=mass, spheres=SphereGeom(
        center=center, radius=radius))
    x, p, E = (t.detach().clone().requires_grad_(True)
               for t in (s0.x, s0.p, s0.E))
    s = dataclasses.replace(s0, x=x, p=p, E=E)
    out = (cuda_kernel.integrate_cuda(e, s, cfg) if kernel
           else cuda_kernel.integrate_plain(e, s, cfg))
    loss_fn(out).backward()
    sph = torch.cat([center.grad, radius.grad[:, None]], dim=1)
    return out, (x.grad, p.grad, E.grad, mass.grad, sph)


def phase_events_bwd(env, icfg, dev, readings):
    """rk4_bwd's event variant against autograd of the plain loop, the
    sphere cotangent included; edge rays get no weight in the loss."""
    rng = np.random.default_rng(2)
    eenv = with_events(env)
    xf, df = events_fan(FAN, dev)
    xr, dr = ragged_batch(1000, dev)
    cases = [(f"events fan {FAN}", (xf, df), icfg),
             (f"events fan {FAN}, 40 steps", (xf, df),
              dataclasses.replace(icfg, n_steps=40))]
    cases += [(f"events ragged 1000 power={pw}", (xr, dr),
               dataclasses.replace(icfg, dt_power=pw)) for pw in POWERS]
    err = 0.0
    for what, (x0, d0), c in cases:
        s0 = initial_state(eenv, x0, d0)
        with torch.no_grad():
            keep, n_edge, _ = split_edges(
                eenv, c, s0, cuda_kernel.integrate_cuda(eenv, s0, c),
                cuda_kernel.integrate_plain(eenv, s0, c), what)
            calm = keep & (event_kappa(eenv, c, s0) <= KAPPA_CALM)
        w = torch.as_tensor(rng.normal(size=tuple(x0.shape)),
                            dtype=torch.float32, device=dev)
        for part, mask, tol in (("all rays", keep, TOL_GRAD_EVENTS),
                                ("calm rays", calm, TOL_GRAD)):
            wx = w * mask[:, None]
            loss = lambda s: weighted_x_loss(s, wx)  # noqa: E731
            out_k, gk = event_grads(eenv, s0, c, loss, kernel=True)
            out_p, gp = event_grads(eenv, s0, c, loss, kernel=False)
            ok = (out_k.lam - out_p.lam).abs() <= TOL_X
            errs = [rel_err(a[ok], b[ok]) for a, b in zip(gk[:3], gp[:3])]
            dm = abs(float(gk[3]) / float(gp[3]) - 1.0)
            dsph = rel_err(gk[4], gp[4])
            active = int((out_k.status == states.ACTIVE).sum())
            log(f"# grad [{what}, {part}: {int(mask.sum())} weighted, "
                f"{n_edge} edge rays not, {active} ACTIVE at the end] x "
                f"{errs[0]:.3e} p {errs[1]:.3e} E {errs[2]:.3e} (max |d| / "
                f"max |plain|), mass rel {dm:.3e}, sphere cotangent (K, 4) "
                f"{dsph:.3e} (largest {float(gp[4].abs().max()):.4g})")
            check(max(errs) <= tol and dm <= max(tol, TOL_GRAD_MASS)
                  and dsph <= max(tol, TOL_GRAD_MASS),
                  f"{what}, {part}: cotangents outside {tol:g} (mass and "
                  f"spheres {max(tol, TOL_GRAD_MASS):g})")
            check(float(gp[4].abs().max()) > 0,
                  f"{what}: no sphere cotangent")
            err = max(err, *errs, dm, dsph)
    # two runs of rk4_bwd give the same bits, the sphere cotangent included
    s0 = flat_state(initial_state(eenv, xf, df))
    g = torch.as_tensor(rng.normal(size=(2, FAN, 3)), dtype=torch.float32,
                        device=dev)
    kw = event_kw(eenv, s0)
    del kw["obj"]
    with torch.no_grad():
        _, _, ck = run_ckpt(eenv, icfg, s0)
        runs = [cuda_kernel.rk4_bwd(
            cuda_kernel._scalars(eenv, icfg, dev), ck, s0.E, g[0], g[1],
            icfg.n_steps, cuda_kernel.segment(icfg.n_steps), icfg.dt_power,
            **kw) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log("# determinism: two runs of rk4_bwd's event variant give "
        + ("bitwise-equal" if same else "DIFFERENT") + " outputs (sphere "
        f"cotangent of moon 0: {runs[0][4][0].tolist()})")
    check(same, "rk4_bwd's event variant is not deterministic")
    readings["rk4_bwd_events"]["max_abs_err"] = err
    log("# phase 10: rk4_bwd's event variant agrees with autograd of the "
        "plain loop")


def moon_grads(scene0, cam, cfg, moon=0):
    """d mean(img[..., :3]^2) / d (the centre and radius of one moon)."""
    center = scene0.spheres.center.detach().clone().requires_grad_(True)
    radius = scene0.spheres.radius.detach().clone().requires_grad_(True)
    scene = dataclasses.replace(scene0, spheres=dataclasses.replace(
        scene0.spheres, center=center, radius=radius))
    P.render_image(scene, cam, cfg)[..., :3].pow(2).mean().backward()
    return torch.cat([center.grad[moon], radius.grad[moon:moon + 1]])


def silhouettes(status, obj):
    """Pixels next to one whose status or hit id differs (the disk's and
    the moons' silhouettes, the shadow's edge)."""
    key = status * 8 + obj
    edge = torch.zeros_like(status, dtype=torch.bool)
    for dim in (0, 1):
        d = key.diff(dim=dim) != 0
        pad = [(0, 1), (1, 0)]
        for lo, hi in pad:
            shape = list(d.shape)
            shape[dim] = 1
            z = torch.zeros(shape, dtype=torch.bool, device=d.device)
            edge |= torch.cat([z, d] if lo else [d, z], dim=dim)
    return edge


def texel_cell(tex, u, v):
    """(row, column) of the texel cell a bilinear lookup of ``tex`` at bpy
    coords (u, v) falls in (texture._SampleBpy)."""
    h, w = tex.shape[:2]
    return (torch.floor((1.0 - v) * 0.5 * h - 0.5),
            torch.floor((u + 1.0) * 0.5 * w - 0.5))


def texel_flips(scene, a, end_a, b, end_b):
    """Sky and disk rays whose texture lookup falls in another texel cell
    in the final state ``a`` (end direction ``end_a``) than in ``b``."""
    def cells(s, end):
        sky = texel_cell(scene.background, *equirect_uv(end))
        disk = texel_cell(scene.disk.texture, *disk_uv(scene.disk, s.x))
        on_disk = s.status == states.DISK
        return [torch.where(on_disk, d, k) for d, k in zip(disk, sky)]

    (ra, ca), (rb, cb) = cells(a, end_a), cells(b, end_b)
    shaded = ((b.status == states.DISK) | (b.status == states.ESCAPED)
              | (b.status == states.BUDGET))
    return shaded & ((ra != rb) | (ca != cb))


def phase_events_render(dev, readings):
    """bench.py's events frame at SIZE^2, forward and forward+backward."""
    scene, cam = events_scene(dev), events_cam(dev)
    cfg, cfg_plain = flagship_cfg(), flagship_cfg(backend="torch")
    reset_counts()
    img = P.render_image(scene, cam, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    readings["rk4_fwd_events"]["launches"] = launches["rk4_fwd_events"]
    check(launches == only(rk4_fwd_events=1),
          f"events render launched {launches}, expected rk4_fwd's event "
          "variant once")
    if img.shape != (SIZE, SIZE, 4) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"events image is not a finite {SIZE}x{SIZE}x4")
    with torch.no_grad():
        img_plain = P.render_image(scene, cam, cfg_plain)
    image_rule(img, img_plain, f"{SIZE}x{SIZE} events, kernel vs plain",
               FLAGSHIP_MEAN, FLAGSHIP_FRAC)
    fenv, s0 = flagship_rays(scene, cam, cfg, dev)
    with torch.no_grad():
        s = cuda_kernel.integrate_cuda(fenv, s0, cfg.integrator)
        sp = cuda_kernel.integrate_plain(fenv, s0, cfg.integrator)
        e, n, n_edge = compare_events(
            fenv, cfg.integrator, flat_state(s0), flat_state(s),
            flat_state(sp), f"{SIZE}x{SIZE} events")
    r = readings["rk4_fwd_events"]
    r.update(max_abs_err=max(r.get("max_abs_err", 0.0), e),
             rays_aligned=r.get("rays_aligned", 0) + n,
             edge_rays=r.get("edge_rays", 0) + n_edge)
    hist = torch.bincount(s.status.reshape(-1).long(), minlength=8).tolist()
    names = ("ACTIVE", "CAPTURED", "ESCAPED", "BUDGET", "DISK", "OBJECT",
             "INSIDE_HORIZON", "ERROR")
    log(f"# phase 11: events {SIZE}x{SIZE} rendered through rk4_fwd's event "
        "variant; statuses "
        + " ".join(f"{k}={v}" for k, v in zip(names, hist) if v))

    # forward+backward: the gradient to the mass, the camera and the sky
    reset_counts()
    gk = render_grads(scene, cam, cfg)
    torch.cuda.synchronize()
    launches = read_counts()
    for name in ("rk4_ckpt_events", "rk4_bwd_events"):
        readings[name]["launches"] = launches[name]
    check(launches == only(rk4_ckpt_events=1, rk4_bwd_events=1),
          f"events forward+backward launched {launches}, expected the event "
          "variants of rk4_ckpt and rk4_bwd once each")
    for g in gk:
        check(bool(torch.isfinite(g).all()), "events gradient not finite")
    gp = render_grads(scene, cam, cfg_plain)
    # The whole frame's mass and camera gradients are sums of large parts
    # of both signs, and float32 alone moves them by as much as they are
    # (the one-ulp reading below): they are readings, and the well-
    # conditioned part of the frame is held instead.  The sky gradient is
    # per texel and held whole.
    errs = compare_render_grads(gk, gp, f"{SIZE}x{SIZE} events, kernel vs "
                                "plain (mass and camera: a reading)",
                                float("inf"))
    check(errs[2] <= TOL_EVENTS_GRAD,
          f"events sky gradient outside {TOL_EVENTS_GRAD:g}")
    # its float32 conditioning: the plain path with the camera one ulp away
    cam_ulp = dataclasses.replace(cam, position=cam.position.clone())
    cam_ulp.position[2] = torch.nextafter(cam.position[2],
                                          cam.position[2] + 1)
    compare_render_grads(render_grads(scene, cam_ulp, cfg_plain), gp,
                         f"{SIZE}x{SIZE} events, plain vs plain with the "
                         "camera one ulp away (a reading)", float("inf"))
    # the parts of the frame: near b_c, near the sky's pole, on a
    # silhouette, after an ill-conditioned event, texel flips, and the calm
    # rest
    with torch.no_grad():
        end = final_direction(fenv, sp)
        kappa = event_kappa(fenv, cfg.integrator, flat_state(s0)).reshape(
            SIZE, SIZE)
        flips = texel_flips(scene, s, final_direction(fenv, s), sp, end)
    rho = end[..., :2].norm(dim=-1)
    # the disk texture's azimuth arccos(x / R) sign(y) has a derivative
    # ~ 1 / |y| near the x axis, as the sky's at its pole
    seam = ((sp.status == states.DISK)
            & (sp.x[..., 1].abs() < POLE_RHO * sp.x[..., :2].norm(dim=-1)))
    parts = {"near b_c": near_b_c(fenv, s0), "near the pole": rho < POLE_RHO,
             "on the disk texture's seam": seam,
             "silhouettes": silhouettes(sp.status, sp.hit_obj),
             "ill-conditioned events": kappa > KAPPA_CALM}
    calm = torch.ones_like(rho, dtype=torch.bool)
    for m in parts.values():
        calm &= ~m
    n_flips = int((calm & flips).sum())
    check(n_flips <= MAX_TEXEL_FLIPS,
          f"{SIZE}x{SIZE} events: {n_flips} texel flips among the calm "
          f"pixels (at most {MAX_TEXEL_FLIPS})")
    parts["texel flips"] = flips
    calm &= ~flips
    for name, m in parts.items():
        gm = render_grads(scene, cam, cfg, m.float())
        log(f"# grad [{SIZE}x{SIZE} events] {int(m.sum())} pixels "
            f"{name} carry mass {float(gm[0]):.5g} and camera "
            f"{gm[1].tolist()} of the kernel path's mass {float(gk[0]):.5g} "
            f"and camera {gk[1].tolist()}")
    log(f"# grad [{SIZE}x{SIZE} events] calm pixels {int(calm.sum())} "
        f"({n_flips} texel flips left out)")
    gp_calm = render_grads(scene, cam, cfg_plain, calm.float())
    errs += compare_render_grads(
        render_grads(scene, cam, cfg, calm.float()), gp_calm,
        f"{SIZE}x{SIZE} events, calm pixels, kernel vs plain",
        TOL_CALM_GRAD)
    compare_render_grads(render_grads(scene, cam_ulp, cfg_plain, calm.float()),
                         gp_calm, f"{SIZE}x{SIZE} events, calm pixels, plain "
                         "vs plain with the camera one ulp away (a reading)",
                         float("inf"))
    # a second gradient: one moon's centre and radius, with a texture that
    # varies over the moons' surfaces
    mscene = events_scene(dev, varying_moons())
    mk = moon_grads(mscene, cam, cfg)
    mp = moon_grads(mscene, cam, cfg_plain)
    dm = rel_err(mk, mp)
    log(f"# grad [{SIZE}x{SIZE} events, moon 0 centre and radius] "
        f"{mk.tolist()} vs {mp.tolist()} ({dm:.3e})")
    check(dm <= TOL_MOON_GRAD and float(mp.abs().max()) > 0,
          f"moon gradient outside {TOL_MOON_GRAD:g}")
    readings["rk4_bwd_events"].update(render_grad_err=max(errs[2:] + [dm]),
                                      texel_flips=n_flips)
    log("# phase 11: events forward+backward through the event variants of "
        "rk4_ckpt and rk4_bwd agrees with the plain path")


def phase_events_times(dev, name_limit, readings):
    scene, cam = events_scene(dev), events_cam(dev)
    cfg, cfg_plain = flagship_cfg(), flagship_cfg(backend="torch")
    fenv, s0 = flagship_rays(scene, cam, cfg, dev)
    icfg = cfg.integrator
    flat = flat_state(s0)
    scal = cuda_kernel._scalars(fenv, icfg, dev)
    seg = cuda_kernel.segment(icfg.n_steps)
    kw = event_kw(fenv, flat)
    args = (scal, flat.x, flat.p, flat.E, flat.lam, flat.status)

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    fwd = no_grad(lambda: cuda_kernel.rk4_fwd(*args, icfg.n_steps, 1.5, **kw))
    ckpt = no_grad(lambda: cuda_kernel.rk4_ckpt(*args, icfg.n_steps, seg,
                                                1.5, **kw))
    ck = ckpt()[-1]
    g = torch.ones_like(flat.x)
    bwd = no_grad(lambda: cuda_kernel.rk4_bwd(
        scal, ck, flat.E, g, g, icfg.n_steps, seg, 1.5, sph=kw["sph"],
        has_disk=True))
    step = lambda: render_grads(scene, cam, cfg)  # noqa: E731

    def plain_forward():
        x = flat.x.detach().clone().requires_grad_(True)
        s = dataclasses.replace(flat, x=x)
        return cuda_kernel.integrate_plain(fenv, s, icfg).x.sum()

    ms = {
        "events forward render (kernel)": timed(no_grad(
            lambda: P.render_image(scene, cam, cfg))),
        "events forward+backward step (kernels)": timed(step),
        "rk4_fwd_events call": timed(fwd),
        "rk4_ckpt_events call": timed(ckpt),
        "rk4_bwd_events call": timed(bwd),
        "events plain integrator, forward": timed(no_grad(
            lambda: cuda_kernel.integrate_plain(fenv, s0, icfg)), runs=5),
        "events forward render (plain)": timed(no_grad(
            lambda: P.render_image(scene, cam, cfg_plain)), runs=3),
        "events forward+backward step (plain)": timed(
            lambda: render_grads(scene, cam, cfg_plain), runs=2),
        "events plain checkpointed loop, forward": timed(plain_forward,
                                                         runs=2),
        "events plain checkpointed loop, backward": timed_backward(
            plain_forward, runs=2),
    }
    for what, v in ms.items():
        log(f"# phase 12: {what} {SIZE}x{SIZE}: median {v:.3f} ms, "
            f"{SIZE * SIZE / (v * 1e-3):.4e} rays/s [{name_limit}]")
    dev_ms = {"rk4_fwd_events": device_ms(fwd),
              "rk4_ckpt_events": device_ms(ckpt),
              "rk4_bwd_events": device_ms(bwd)}
    log("# phase 12: device time (CUDA events, median of 10): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in dev_ms.items())
        + f" [{name_limit}]")
    wall = ms["events forward+backward step (kernels)"]
    step_profile(step, wall, "phase 12: events forward+backward step",
                 name_limit)
    for name, plain in (("rk4_fwd_events", "events plain integrator, forward"),
                        ("rk4_ckpt_events",
                         "events plain checkpointed loop, forward"),
                        ("rk4_bwd_events",
                         "events plain checkpointed loop, backward")):
        readings[name].update(ms=ms[f"{name} call"], device_ms=dev_ms[name],
                              plain_ms=ms[plain])
    readings["events_step"] = {
        "fwd_bwd_ms": wall,
        "fwd_bwd_plain_ms": ms["events forward+backward step (plain)"],
        "fwd_ms": ms["events forward render (kernel)"]}


def main() -> int:
    # --- phase 0: the card -----------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    name_limit = card()
    log(name_limit)
    dev = torch.device(DEVICE, 0)

    if Path(P.__file__).resolve().parent != ROOT / PKG:
        raise RuntimeError(f"{PKG} imported from {P.__file__}, not from "
                           f"this checkout ({ROOT})")
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")

    t_start = time.perf_counter()
    phase_build()
    readings = {name: {} for name in KERNELS}
    env = fan_env(dev)
    icfg = flagship_cfg().integrator
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, device=dev),
                    background=torch.as_tensor(make_sky(),
                                               dtype=torch.float32,
                                               device=dev))
    cam = P.Camera.make(position=(0.0, 0.0, 25.0), fov=(0.8, 0.8),
                        device=dev)

    phase("phase 2 (rk4_fwd vs plain)", phase_fwd, env, icfg, dev, readings)
    phase("phase 3 (flagship forward)", phase_flagship_fwd, scene, cam, dev,
          readings)
    phase("phase 4 (rk4_ckpt)", phase_ckpt, env, icfg, scene, cam, dev,
          readings)
    phase("phase 5 (rk4_bwd vs autograd)", phase_bwd, env, icfg, dev,
          readings)
    phase("phase 6 (flagship gradient)", phase_flagship_grad, scene, cam,
          dev, readings)
    phase_times(scene, cam, dev, name_limit, readings)
    phase("phase 8 (rk4_fwd events vs plain)", phase_events_fwd, env, icfg,
          dev, readings)
    phase("phase 9 (rk4_ckpt events)", phase_events_ckpt, env, icfg, dev,
          readings)
    phase("phase 10 (rk4_bwd events vs autograd)", phase_events_bwd, env,
          icfg, dev, readings)
    phase("phase 11 (events frame)", phase_events_render, dev, readings)
    phase_events_times(dev, name_limit, readings)
    log(f"# chip_smoke ran {time.perf_counter() - t_start:.1f} s, the "
        "kernels' build included")

    if FAILURES:
        log(f"# chip_smoke FAILED {len(FAILURES)} check(s):")
        for msg in FAILURES:
            log(f"#   {msg}")
        return 1
    for key, what in (("step", "flagship"), ("events_step", "events")):
        step = readings.pop(key)
        log(f"# step [{what}]: forward+backward {step['fwd_bwd_ms']:.3f} ms "
            f"({SIZE * SIZE / (step['fwd_bwd_ms'] * 1e-3):.4e} rays/s), "
            f"plain {step['fwd_bwd_plain_ms']:.3f} ms, forward "
            f"{step['fwd_ms']:.3f} ms [{name_limit}]")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         **readings[name]}
        for name, (src, rep) in KERNELS.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
