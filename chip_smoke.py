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
     call against its plain version, and profiles the step.

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
    GeodesicEnv, _fixed_step, final_direction)
from blackhole_geodesic_calculator_tpu_torch.render.renderer import (
    _bh_frame, scene_env)
from blackhole_geodesic_calculator_tpu_torch.scene.shading import shade

ROOT = Path(__file__).resolve().parent
PKG = "blackhole_geodesic_calculator_tpu_torch"
PALLAS = "blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py"
KERNELS = {   # name -> (source in the repo, the TPU kernel it replaces)
    "rk4_fwd": (f"{PKG}/ops/csrc/rk4_fwd.cu", f"{PALLAS}:1159"),
    "rk4_ckpt": (f"{PKG}/ops/csrc/rk4_ckpt.cu", f"{PALLAS}:1201"),
    "rk4_bwd": (f"{PKG}/ops/csrc/rk4_bwd.cu", f"{PALLAS}:1258"),
}

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


def device_ms(kernels, fn, runs=10):
    """Mean device ms per run of the kernels whose name holds one of
    ``kernels``, from torch.profiler; None if it records no device time
    for them."""
    prof = profile(fn, runs)
    us = sum(getattr(ev, "device_time_total", None)
             or getattr(ev, "cuda_time_total", 0)
             for ev in prof.key_averages()
             if any(k in ev.key for k in kernels))
    return us / runs / 1e3 if us else None


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
    check(launches == {"rk4_fwd": 1, "rk4_ckpt": 0, "rk4_bwd": 0},
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
    cuda_kernel.LAUNCHES = 0
    cuda_kernel.LAUNCHES_CKPT = 0
    cuda_kernel.LAUNCHES_BWD = 0


def read_counts():
    return {"rk4_fwd": cuda_kernel.LAUNCHES,
            "rk4_ckpt": cuda_kernel.LAUNCHES_CKPT,
            "rk4_bwd": cuda_kernel.LAUNCHES_BWD}


def ckpt_rows(ck, k, s0):
    cx, cp, clam, cst = ck
    return dataclasses.replace(s0, x=cx[k], p=cp[k], lam=clam[k],
                               status=cst[k])


def run_ckpt(env, cfg, s0):
    """rk4_fwd and rk4_ckpt on the flat state ``s0``."""
    scal = cuda_kernel._scalars(env, cfg, s0.x.device)
    n, pw = cfg.n_steps, float(cfg.dt_power)
    fwd = cuda_kernel.rk4_fwd(scal, s0.x, s0.p, s0.E, s0.lam, s0.status, n,
                              pw)
    *fin, ck = cuda_kernel.rk4_ckpt(scal, s0.x, s0.p, s0.E, s0.lam,
                                    s0.status, n, cuda_kernel.segment(n), pw)
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
    check(launches == {"rk4_fwd": 0, "rk4_ckpt": 1, "rk4_bwd": 1},
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
        ck = cuda_kernel.rk4_ckpt(*args, icfg.n_steps, seg, 1.5)[4]
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
        "rk4_fwd": device_ms(("rk4_fwd",), no_grad(
            lambda: cuda_kernel.rk4_fwd(*args, icfg.n_steps, 1.5))),
        "rk4_ckpt": device_ms(("rk4_ckpt",), no_grad(
            lambda: cuda_kernel.rk4_ckpt(*args, icfg.n_steps, seg, 1.5))),
        "rk4_bwd": device_ms(("rk4_bwd", "sum_blocks"), bwd),
    }
    log(f"# phase 7: scalar vector {ms_scal:.3f} ms (host, median); device "
        "time (profiler, mean of 10): "
        + ", ".join(f"{k} " + (f"{v:.3f} ms" if v is not None
                               else "not measured")
                    for k, v in dev_ms.items()) + f" [{name_limit}]")

    # where the forward+backward step's device time goes: the device
    # kernels (and copies) the profiler records, by name
    from torch.autograd import DeviceType

    prof = profile(step, runs=5)
    by_name: dict[str, list[float]] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            t = by_name.setdefault(ev.name, [0.0, 0])
            t[0] += ev.time_range.elapsed_us() / 5 / 1e3
            t[1] += 1
    total = sum(t for t, _ in by_name.values())
    wall = ms["forward+backward step (kernels)"]
    log(f"# phase 7: forward+backward step, device busy {total:.3f} ms per "
        f"step over {sum(c for _, c in by_name.values()) // 5} kernel "
        f"launches, {100 * total / wall:.1f}% of the {wall:.3f} ms step "
        f"(profiler, mean of 5) [{name_limit}]")
    for key, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"#   {t:8.3f} ms {100 * t / total:5.1f}%  x{c // 5:<4d} "
            f"{key[:90]}")

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

    if FAILURES:
        log(f"# chip_smoke FAILED {len(FAILURES)} check(s):")
        for msg in FAILURES:
            log(f"#   {msg}")
        return 1
    step = readings.pop("step")
    log(f"# step: forward+backward {step['fwd_bwd_ms']:.3f} ms "
        f"({SIZE * SIZE / (step['fwd_bwd_ms'] * 1e-3):.4e} rays/s), plain "
        f"{step['fwd_bwd_plain_ms']:.3f} ms [{name_limit}]")
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
