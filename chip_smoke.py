"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It drives the port's forward render path
through the hand-written CUDA kernel and fails (non-zero exit, no result
line) if anything is off:

  0. needs a CUDA device; prints the card's name and power limit;
  1. builds the kernels from the checkout's sources (build/kernels/);
  2. holds the kernel against its plain PyTorch version on the card
     (a 65,536-ray impact-parameter fan and a ragged batch with
     inside-horizon rays) and renders the 64x64 sky golden through it;
  3. renders the 1024x1024 flagship sky scene through ``render_image``,
     checks that the kernel was launched and that the image agrees with the
     plain PyTorch render, and holds the kernel's final states of those 1M
     rays against the plain integrator's;
  4. times the render, the kernel call, the kernel's device time and the
     plain integrator alone.

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it lists each kernel with its launch count, error and times.
Imports nothing of JAX.
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
from blackhole_geodesic_calculator_tpu_torch.render.renderer import scene_env

ROOT = Path(__file__).resolve().parent
PKG = "blackhole_geodesic_calculator_tpu_torch"
KERNEL_SOURCE = f"{PKG}/ops/csrc/rk4_fwd.cu"
KERNEL_REPLACES = "blackhole_geodesic_calculator_tpu/ops/pallas_kernel.py:1159"

# Tolerances of the kernel against its plain version.  Both are float32;
# they differ in rsqrtf against torch.rsqrt and in nvcc's fused
# multiply-adds, a few ulp per step, amplified near the photon sphere.
TOL_X = 1e-3       # position and affine parameter, absolute
TOL_P = 1e-4       # momentum, absolute
TOL_DIR = 1e-4     # final direction, radians: 1/8 of the flagship pixel
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
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


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
        sub = dataclasses.replace(
            s, x=s.x[mask], p=s.p[mask], E=s.E[mask], lam=s.lam[mask],
            status=torch.zeros_like(s.status[mask]),
            hit_obj=s.hit_obj[mask])
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


def compare_flagship(env, cfg, s0, a, b):
    """Kernel state ``a`` against plain state ``b`` for every flagship ray.

    Statuses must be equal everywhere.  Rays whose impact parameter L/E lies
    in the band the fan leaves out, [4.9, 5.5] M around b_c = 3 sqrt(3) M,
    circle near the photon sphere, where each orbit multiplies a rounding
    difference by about e^(2 pi); there two correct float32 paths part by
    more than the state tolerances (up to 1.2e-2 in lam on an H100), so they
    are held to lam within half a step instead: a ray that took a step more
    or fewer in one path fails.  All other rays are held to the full
    tolerances of compare_states.  Returns (error, rays aligned, largest
    |d lam| in the band)."""
    if not torch.equal(a.status, b.status):
        n_bad = int((a.status != b.status).sum())
        raise AssertionError(f"flagship: {n_bad} statuses differ")
    b_imp = torch.linalg.cross(s0.x, s0.p, dim=-1).norm(dim=-1) / s0.E
    m = float(env.mass)
    near = (b_imp >= 4.9 * m) & (b_imp <= 5.5 * m)

    def rays(s, k):
        return dataclasses.replace(s, x=s.x[k], p=s.p[k], E=s.E[k],
                                   lam=s.lam[k], status=s.status[k],
                                   hit_obj=s.hit_obj[k])

    err, n = compare_states(env, cfg, rays(a, ~near), rays(b, ~near),
                            f"{SIZE}x{SIZE} flagship, away from b_c")
    dlam = float((a.lam[near] - b.lam[near]).abs().max())
    log(f"# parity [{SIZE}x{SIZE} flagship, near b_c] "
        f"n={int(near.sum())} statuses equal, max|dlam|={dlam:.3e} "
        f"(limit {0.5 * cfg.dt:g}, half a step)")
    if not dlam < 0.5 * cfg.dt:
        raise AssertionError("flagship: a ray near b_c is a step apart")
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


def device_ms(kernel, fn, runs=10):
    """Mean device ms per run of the kernels whose name holds ``kernel``,
    from torch.profiler over ``runs`` runs after a warm-up; None if the
    profiler records no device time for them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "device_time_total", None)
             or getattr(ev, "cuda_time_total", 0)
             for ev in prof.key_averages() if kernel in ev.key)
    return us / runs / 1e3 if us else None


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

    # --- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"# phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
        f"-> {lib_path.relative_to(ROOT)}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"#   ptxas: {line.strip()}")

    # --- phase 2: kernel vs plain on the card --------------------------------
    env = GeodesicEnv(
        mass=torch.tensor(0.5, device=dev),
        r_capture=torch.tensor(1.0, device=dev),
        r_escape=torch.tensor(70.0, device=dev),
        lam_max=torch.tensor(100.0, device=dev))
    icfg = flagship_cfg().integrator
    on = lambda b, **kw: dataclasses.replace(icfg, backend=b, **kw)  # noqa

    x0, d0 = camera_fan(65536, dev)
    err, aligned = compare_states(
        env, icfg, P.launch(env, x0, d0, on("cuda")),
        P.launch(env, x0, d0, on("torch")), "fan 65536")
    x0r, d0r = ragged_batch(1000, dev)
    for power in (1.5, 1.0, 2.0, 1.3):
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
    log("# phase 2: kernel agrees with plain PyTorch on the card")

    # --- phase 3: flagship render through the kernel -----------------------
    scene = P.Scene(bh=P.BlackHole.make(mass=0.5, device=dev),
                    background=torch.as_tensor(make_sky(),
                                               dtype=torch.float32,
                                               device=dev))
    cam = P.Camera.make(position=(0.0, 0.0, 25.0), fov=(0.8, 0.8),
                        device=dev)
    cfg = flagship_cfg()
    cfg_plain = flagship_cfg(backend="torch")

    cuda_kernel.LAUNCHES = 0
    img = P.render_image(scene, cam, cfg)
    torch.cuda.synchronize()
    launches = cuda_kernel.LAUNCHES
    if launches != 1:
        raise AssertionError(f"render launched rk4_fwd {launches} times")
    if img.shape != (SIZE, SIZE, 4) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"flagship image is not a finite {SIZE}x{SIZE}x4")
    img_plain = P.render_image(scene, cam, cfg_plain)
    image_rule(img, img_plain, f"{SIZE}x{SIZE} flagship, kernel vs plain",
               FLAGSHIP_MEAN, FLAGSHIP_FRAC)

    # the flagship's rays themselves: some run all n_steps or end on the
    # budget, which the fan and the ragged batch never do
    ys, xs = pixel_grid(SIZE, SIZE, device=dev)
    o, d = generate_rays(cam, SIZE, SIZE, ys, xs)
    fenv = scene_env(scene, cfg, cam)
    p0, E0 = null_init(o, d, fenv.mass)
    s0 = states.init_state(o.contiguous(), p0, E0)
    s = cuda_kernel.integrate_cuda(fenv, s0, cfg.integrator)
    e, n, dlam_near = compare_flagship(
        fenv, cfg.integrator, s0, s,
        cuda_kernel.integrate_plain(fenv, s0, cfg.integrator))
    err, aligned = max(err, e), aligned + n
    hist = torch.bincount(s.status.reshape(-1).long(), minlength=8).tolist()
    names = ("ACTIVE", "CAPTURED", "ESCAPED", "BUDGET", "DISK", "OBJECT",
             "INSIDE_HORIZON", "ERROR")
    log(f"# phase 3: flagship {SIZE}x{SIZE} rendered through rk4_fwd "
        f"(launches={launches}); statuses "
        + " ".join(f"{k}={v}" for k, v in zip(names, hist) if v))

    # --- phase 4: times ------------------------------------------------------
    rays = SIZE * SIZE
    ms_render = timed(lambda: P.render_image(scene, cam, cfg))
    ms_kernel = timed(lambda: cuda_kernel.integrate_cuda(fenv, s0,
                                                         cfg.integrator))
    ms_plain = timed(lambda: cuda_kernel.integrate_plain(fenv, s0,
                                                         cfg.integrator))
    ms_render_plain = timed(lambda: P.render_image(scene, cam, cfg_plain))
    for what, ms in (("forward render (kernel)", ms_render),
                     ("rk4_fwd kernel call (integrate_cuda)", ms_kernel),
                     ("plain integrator alone", ms_plain),
                     ("forward render (plain)", ms_render_plain)):
        log(f"# phase 4: {what} {SIZE}x{SIZE}: median {ms:.3f} ms, "
            f"{rays / (ms * 1e-3):.4e} rays/s [{name_limit}]")
    # where the kernel call's time goes: the scalar vector the wrapper
    # builds, and the kernel's own device time
    ms_scal = timed(lambda: cuda_kernel._scalars(fenv, cfg.integrator, dev))
    ms_dev = device_ms("rk4_fwd", lambda: cuda_kernel.integrate_cuda(
        fenv, s0, cfg.integrator))
    log(f"# phase 4: kernel call split: scalar vector {ms_scal:.3f} ms "
        f"(host, median), kernel device time "
        + (f"{ms_dev:.3f} ms (profiler, mean)" if ms_dev is not None
           else "not measured (profiler saw no device time)")
        + f" [{name_limit}]")

    log(json.dumps({"kernels": [{
        "name": "rk4_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": err, "rays_aligned": aligned,
        "dlam_near_b_c": dlam_near, "ms": ms_kernel,
        "device_ms": ms_dev, "plain_ms": ms_plain}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
