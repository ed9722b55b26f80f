"""Executable tutorial (PyTorch port of examples/tutorial.py): every layer
of the package in one pass.

    python -m blackhole_geodesic_calculator_tpu_torch.examples.tutorial
        [--outdir DIR] [--size 96] [--device cuda|cpu]

Sections:
  1. Trajectories   -- integrate single geodesics, check light deflection
                       against the weak-field 4M/b law.
  2. Rendering      -- whole-scene render_image + the gradient of the mean
                       pixel with respect to the black-hole mass.
  3. Hybrid engine  -- Gen-1 sphere-of-influence render, exact Schwarzschild
                       surrogate table, learned (MLP) surrogate.
  4. Sharding       -- the same render over the ranks of the default
                       torch.distributed group (one rank without one).
  5. Polarization   -- Stokes I/Q/U of a polarized accretion disk.

On the card the integrations go through the hand-written kernels: rk4_fwd
for every forward (its event variant for the disk-and-moon scene, also
inside the table build and the surrogate's labels) and rk4_ckpt + rk4_bwd
for the mass gradient; ``trajectory`` records every step of a plain loop.
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import add_device_arg, device_of, gate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blackhole_geodesic_calculator_tpu_torch.examples."
        "tutorial")
    ap.add_argument("--outdir", default=os.path.join(tempfile.gettempdir(),
                                                     "bhgc_tutorial"))
    ap.add_argument("--size", type=int, default=96,
                    help="render resolution")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    t00 = time.perf_counter()

    from ..camera import Camera
    from ..io_ import tonemap, write_png
    from ..ops import (GeodesicEnv, IntegratorConfig, launch, states,
                       trajectory)
    from ..ops.integrate import final_direction
    from ..render import (LimitedConfig, RenderConfig, render_image,
                          render_limited, render_stokes)
    from ..scene import BlackHole, Disk, Scene, Spheres

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    def host(t):
        return t.detach().cpu().numpy()

    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"# device: {dev} ({kind})")

    # ------------------------------------------------------------------
    # 1. Trajectories.  The physical core is `launch`: a batch of rays,
    # integrated to termination in one call (one kernel launch on the card).
    # ------------------------------------------------------------------
    M = 0.5                       # geometrized units; horizon r_s = 2M = 1
    env = GeodesicEnv(mass=f32(M), r_capture=f32(2 * M),
                      r_escape=f32(80.0), lam_max=f32(400.0))
    cfg = IntegratorConfig(n_steps=2000, dt=0.1, dt_boost=1.0)

    # A fan of rays with impact parameters b = 6..14 M, moving +x (the
    # critical b_c = 3 sqrt(3) M ~ 5.2 M: anything below is captured):
    bs = torch.linspace(6.0, 14.0, 9, device=dev) * M
    x0 = torch.stack([torch.full_like(bs, -60.0), bs, torch.zeros_like(bs)],
                     -1)
    d0 = f32([1.0, 0.0, 0.0]).expand(x0.shape)
    s = launch(env, x0, d0, cfg)
    ed = host(final_direction(env, s))
    defl = np.degrees(np.arctan2(ed[:, 1], ed[:, 0]))
    print("\n[1] light deflection vs the weak-field law 4M/b:")
    for b, dfl in zip(host(bs), defl):
        print(f"    b = {b / M:5.2f} M   bent {abs(dfl):6.3f} deg "
              f"(weak-field {np.degrees(4 * M / b):6.3f} deg)")
    gate(bool(torch.all(s.status == states.ESCAPED)),
         "a ray of the fan did not escape")

    # Full trajectory polylines (the compat layer wraps this as the
    # reference's calc_trajectory) for e.g. plotting:
    xs, _, _ = trajectory(env, x0[:2], d0[:2],
                          dataclasses.replace(cfg, n_steps=400))
    print(f"    trajectory array: {tuple(xs.shape)} (steps, rays, xyz)")

    # ------------------------------------------------------------------
    # 2. Whole-scene differentiable rendering.
    # ------------------------------------------------------------------
    H = Wd = args.size
    v = np.linspace(0.0, 1.0, 64)[:, None]
    u = np.linspace(0.0, 1.0, 128)[None, :]
    sky = f32(np.stack([
        0.5 + 0.5 * np.sin(8 * np.pi * u) * np.sin(4 * np.pi * v)
        * np.ones_like(u * v),
        np.broadcast_to(v, (64, 128)), 0.6 * np.ones((64, 128))], -1))
    scene = Scene(
        bh=BlackHole.make(mass=M, device=dev),
        background=sky,
        disk=Disk.make(r_in=2.2, r_out=6.0,
                       texture=np.ones((8, 8, 3)) * np.asarray(
                           [1.0, 0.62, 0.25]),
                       intensity=2.0, beaming=4.0, device=dev),
        spheres=Spheres.make(center=[[0.0, 9.0, 2.0]], radius=[0.8],
                             texture=np.ones((1, 8, 8, 3), np.float32),
                             emission=[1.0], albedo=[[1, 1, 1]],
                             device=dev),
    )
    cam = Camera.make(position=(0.0, -18.0, 3.5),
                      euler=(np.pi / 2 - 0.19, 0.0, 0.0), fov=(0.9, 0.9),
                      device=dev)
    rcfg = RenderConfig(width=Wd, height=H, samples=1,
                        integrator=IntegratorConfig(n_steps=400, dt=0.1),
                        lam_max=200.0)
    t0 = time.perf_counter()
    with torch.no_grad():
        img = host(render_image(scene, cam, rcfg))
    path = os.path.join(args.outdir, "tutorial_disk.png")
    write_png(path, np.concatenate(
        [tonemap(img[..., :3]), img[..., 3:]], -1))
    print(f"\n[2] whole-scene render -> {path} "
          f"({time.perf_counter() - t0:.1f}s incl. the kernels' build)")

    # The render is ONE differentiable program: d(pixel)/d(mass) exists.
    mass = f32(M).requires_grad_(True)
    s2 = dataclasses.replace(scene, bh=dataclasses.replace(scene.bh,
                                                           mass=mass))
    lum = torch.mean(render_image(s2, cam, rcfg)[..., :3])
    g = float(torch.autograd.grad(lum, mass)[0])
    print(f"    d<image>/d(mass) = {g:+.4f}  (shadow grows with mass -> "
          f"mean luminosity falls)")

    # ------------------------------------------------------------------
    # 3. Gen-1 hybrid engine + surrogates.
    # ------------------------------------------------------------------
    lcfg = LimitedConfig(r_influence=10.0)
    sky_scene = Scene(bh=BlackHole.make(mass=M, device=dev), background=sky)
    cam1 = Camera.make(position=(0.0, 0.0, 40.0), fov=(0.55, 0.55),
                       device=dev)
    rcfg1 = RenderConfig(width=Wd, height=H, samples=1,
                         integrator=IntegratorConfig(n_steps=300, dt=0.1),
                         lam_max=200.0)
    t0 = time.perf_counter()
    with torch.no_grad():
        img_ode = host(render_limited(sky_scene, cam1, rcfg1, lcfg))
        img_tab = host(render_limited(
            sky_scene, cam1, rcfg1, dataclasses.replace(lcfg, approx=True)))
    err = np.abs(img_ode - img_tab)
    print(f"\n[3] Gen-1 hybrid: ODE vs exact surrogate table "
          f"mean|d| = {err.mean():.4f}, max|d| = {err.max():.2f} "
          f"(max sits on the photon ring, where neighbouring pixels "
          f"diverge; {time.perf_counter() - t0:.1f}s)")

    # The LEARNED surrogate, here trained in seconds at toy scale; see
    # models/surrogate.py for the Kerr case that motivates it:
    from ..models.surrogate import (SurrogateConfig, evaluate_surrogate,
                                    train_surrogate)

    scfg = SurrogateConfig(width=64, depth=3, r_influence=10.0,
                           n_steps=200, dt=0.1, lam_max=80.0)
    t0 = time.perf_counter()
    sur, hist = train_surrogate(torch.Generator(dev).manual_seed(0), mass=M,
                                spin=None, cfg=scfg, steps=250, batch=512,
                                log_every=50)
    m = evaluate_surrogate(torch.Generator(dev).manual_seed(1), sur, scfg,
                           n=4096)
    print(f"    learned surrogate: loss {hist['loss'][0]:.3f} -> "
          f"{hist['loss'][-1]:.3f} in {time.perf_counter() - t0:.1f}s; "
          f"capture acc {100 * m['capture_acc']:.1f}%, "
          f"median dir err {m['dir_err_median_rad']:.3f} rad")
    with torch.no_grad():
        img_mlp = render_limited(
            sky_scene, cam1, rcfg1, dataclasses.replace(lcfg, approx=True),
            table=sur)
    path = os.path.join(args.outdir, "tutorial_limited_mlp.png")
    write_png(path, img_mlp)
    print(f"    MLP-surrogate render -> {path}")

    # ------------------------------------------------------------------
    # 4. Sharded rendering: the same render over every rank of the default
    # torch.distributed group (parallel.init_distributed joins one); each
    # rank renders its dealt share of the pixels.
    # ------------------------------------------------------------------
    from ..parallel import make_mesh, render_image_sharded

    mesh = make_mesh()
    t0 = time.perf_counter()
    with torch.no_grad():
        img_sh = host(render_image_sharded(scene, cam, rcfg, mesh))
    print(f"\n[4] sharded render over mesh {mesh.shape}: "
          f"max|d| vs single = {np.abs(img_sh - img).max():.2e} "
          f"({time.perf_counter() - t0:.1f}s)")

    # ------------------------------------------------------------------
    # 5. Polarization: Stokes I/Q/U of the beamed disk.
    # ------------------------------------------------------------------
    scene_pol = dataclasses.replace(
        scene, disk=dataclasses.replace(scene.disk, pol_frac=f32(0.7)))
    t0 = time.perf_counter()
    with torch.no_grad():
        rgb, Q, U = [host(a) for a in render_stokes(scene_pol, cam, rcfg)]
    I = rgb.mean(-1)  # noqa: E741
    pf = np.where(I > 1e-4, np.hypot(Q, U) / np.maximum(I, 1e-20), 0.0)
    path = os.path.join(args.outdir, "tutorial_polfrac.png")
    write_png(path, np.clip(pf, 0, 1)[..., None].repeat(3, -1))
    print(f"\n[5] Stokes render: max pol fraction "
          f"{pf.max():.2f} -> {path} ({time.perf_counter() - t0:.1f}s)")

    print(f"\ntutorial done in {time.perf_counter() - t00:.1f}s; "
          f"images in {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
