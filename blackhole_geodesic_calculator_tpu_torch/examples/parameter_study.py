"""Parameter study (PyTorch port of examples/parameter_study.py): the
reference's open "Finish parameter study" science milestone, executed
with analytic oracles.

Three studies, each comparing a MEASURED quantity from the integrator
against an independent closed-form prediction:

1. **Kerr shadow edges vs spin** -- bisect the capture boundary of
   equatorial photons on both sides of a spinning hole and compare the
   critical impact parameters against Bardeen's exact formula
   xi(r_p) = -(r_p^3 - 3 M r_p^2 + a^2 r_p + a^2 M) / (a (r_p - M))
   evaluated at the prograde/retrograde photon-orbit radii
   r_p = 2M (1 + cos(2/3 arccos(-/+ a/M))).  (Bardeen 1973; the a -> 0
   limit is the Schwarzschild 3 sqrt(3) M on both sides.)

2. **Deflection vs impact parameter** -- total bending angle of escaped
   rays against the weak-field series 4M/b + (15 pi / 4)(M/b)^2: the
   residual must shrink like (M/b)^3.

3. **Disk beaming asymmetry vs inclination** -- the approaching/receding
   flux ratio of a beamed Keplerian disk must grow monotonically with
   inclination (and be 1 face-on).

On the card every bisection step is one rk4_fwd launch of one ray (the
Kerr variant for a spinning hole), the deflection fan one launch and each
disk frame one launch of the event variant.  Writes a JSON table to
--outdir and prints a summary:

    python -m blackhole_geodesic_calculator_tpu_torch.examples.parameter_study
        [--quick] [--outdir DIR] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import add_device_arg, device_of, gate


def bardeen_edges(M, a):
    """Exact equatorial Kerr shadow edges (critical impact parameters),
    (b_prograde, b_retrograde), both positive; 3 sqrt(3) M at a = 0."""
    if a == 0.0:
        b = 3.0 * np.sqrt(3.0) * M
        return b, b
    out = []
    for sgn in (+1.0, -1.0):   # prograde / retrograde photon orbit
        r_p = 2.0 * M * (1.0 + np.cos(2.0 / 3.0
                                      * np.arccos(-sgn * a / M)))
        xi = -(r_p**3 - 3.0 * M * r_p**2 + a * a * r_p + a * a * M) / (
            a * (r_p - M))
        out.append(abs(xi))
    return tuple(out)


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def measure_shadow_edges(M, a, D=400.0, iters=30, n_steps=8000,
                         device="cuda"):
    """Bisect the equatorial capture boundary on both sides of the hole.

    Camera on the -y axis at distance D (far enough that b = D sin(alpha)
    is the asymptotic impact parameter to O(M/D)); photons launched in the
    equatorial plane.  Returns (b_left, b_right) = the prograde/retrograde
    critical impact parameters as seen from +x / -x."""
    from ..ops import GeodesicEnv, IntegratorConfig, launch, states

    dev = torch.device(device)
    spin = None if a == 0.0 else _f32(a, dev)
    # the horizon r_+ in float32, as the JAX script takes it
    r_cap = (2.0 * M if a == 0.0 else M + float(torch.sqrt(torch.clamp_min(
        torch.tensor(M * M - a * a, dtype=torch.float32), 0.0))))
    env = GeodesicEnv(mass=_f32(M, dev), r_capture=_f32(r_cap, dev),
                      r_escape=_f32(2.0 * D, dev),
                      lam_max=_f32(4.0 * D, dev), spin=spin)
    # base dt must resolve the photon-sphere region (dt_eff = dt at
    # r <= r_ref); the far field rides the boost cap so the affine budget
    # ~2D still fits in n_steps
    cfg = IntegratorConfig(n_steps=n_steps, dt=0.1 * M,
                           dt_boost=2.0 * D / (0.1 * M * n_steps) * 4.0,
                           dt_boost_r_ref=3.0 * M, dt_power=1.0)
    x0 = _f32([[0.0, -D, 0.0]], dev)

    def captured(alpha):
        # alpha > 0 aims left of the hole (+x side), alpha < 0 right
        alpha = _f32([alpha], dev)
        d = torch.stack([torch.sin(alpha), torch.cos(alpha),
                         torch.zeros_like(alpha)], -1)
        s = launch(env, x0, d, cfg)
        return bool(s.status[0] == states.CAPTURED)

    edges = []
    for side in (+1.0, -1.0):
        lo, hi = 0.0, 12.0 * M / D     # capture cone is inside ~12M
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            if captured(side * mid):
                lo = mid               # still captured: edge is further out
            else:
                hi = mid
        edges.append(D * float(torch.sin(_f32(0.5 * (lo + hi), "cpu"))))
    return tuple(edges)


def measure_deflection(M, bs, D=400.0, n_steps=8000, device="cuda"):
    """Total bending angle of equatorial photons with impact parameters
    ``bs`` (asymptotic, set up at distance D)."""
    from ..ops import GeodesicEnv, IntegratorConfig, launch, states
    from ..ops.integrate import final_direction

    dev = torch.device(device)
    env = GeodesicEnv(mass=_f32(M, dev), r_capture=_f32(2.0 * M, dev),
                      r_escape=_f32(2.0 * D, dev),
                      lam_max=_f32(5.0 * D, dev))
    cfg = IntegratorConfig(n_steps=n_steps, dt=0.1 * M,
                           dt_boost=2.5 * D / (0.1 * M * n_steps) * 4.0,
                           dt_boost_r_ref=3.0 * M, dt_power=1.0)
    bs = _f32(np.asarray(bs, np.float32), dev)
    x0 = torch.stack([-torch.sqrt(D * D - bs * bs), bs,
                      torch.zeros_like(bs)], -1)
    d0 = _f32([1.0, 0.0, 0.0], dev).expand(x0.shape)
    s = launch(env, x0, d0, cfg)
    gate(bool(torch.all(s.status == states.ESCAPED)),
         "a deflection ray did not escape")
    ed = final_direction(env, s).cpu().numpy()
    return np.arctan2(np.abs(ed[:, 1]), ed[:, 0])


def measure_disk_asymmetry(inclinations, size=96, device="cuda"):
    """Approaching/receding half-image flux ratio of a beamed disk vs
    camera inclination (0 = face-on)."""
    from ..camera import Camera
    from ..ops import IntegratorConfig
    from ..render import RenderConfig, render_image
    from ..scene import BlackHole, Disk, Scene

    dev = torch.device(device)
    scene = Scene(
        bh=BlackHole.make(mass=0.5, device=dev),
        background=torch.zeros((8, 16, 3), device=dev),
        disk=Disk.make(r_in=2.0, r_out=6.0, texture=np.ones((8, 8, 3)),
                       intensity=1.0, beaming=4.0, device=dev),
    )
    cfg = RenderConfig(width=size, height=size,
                       integrator=IntegratorConfig(n_steps=400, dt=0.1),
                       lam_max=150.0)
    out = []
    for inc in inclinations:
        # orbit the camera off the disk axis by `inc`
        R = 25.0
        cam = Camera.make(
            position=(0.0, -R * float(np.sin(inc)), R * float(np.cos(inc))),
            euler=(float(inc), 0.0, 0.0), fov=(0.8, 0.8), device=dev)
        with torch.no_grad():
            img = render_image(scene, cam, cfg)[..., :3].cpu().numpy()
        left = float(img[:, : size // 2].sum())
        right = float(img[:, size // 2:].sum())
        hi, lo = max(left, right), max(min(left, right), 1e-9)
        out.append(hi / lo)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blackhole_geodesic_calculator_tpu_torch.examples."
        "parameter_study")
    ap.add_argument("--outdir", default=os.path.join(tempfile.gettempdir(),
                                                     "bhgc_param_study"))
    ap.add_argument("--quick", action="store_true",
                    help="reduced sweep for CI")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    t0 = time.perf_counter()

    M = 0.5
    report = {"mass": M}

    # -- study 1: shadow edges vs spin ---------------------------------
    spins = [0.0, 0.45] if args.quick else [0.0, 0.15, 0.3, 0.4, 0.45]
    iters = 26 if args.quick else 30
    n_steps = 6000 if args.quick else 8000
    rows = []
    print("shadow edges vs spin (measured | Bardeen analytic), units of M:")
    worst = 0.0
    for a in spins:
        b_pro_t, b_ret_t = bardeen_edges(M, a)
        b_left, b_right = measure_shadow_edges(M, a, iters=iters,
                                               n_steps=n_steps, device=dev)
        # the +x side (left of the hole from the camera) is retrograde for
        # a > 0 with our conventions; order-insensitive match:
        meas = sorted((b_left, b_right))
        anal = sorted((b_pro_t, b_ret_t))
        errs = [abs(m - t) / t for m, t in zip(meas, anal)]
        worst = max(worst, *errs)
        rows.append({"a_over_M": a / M, "measured": [m / M for m in meas],
                     "analytic": [t / M for t in anal],
                     "rel_err": errs})
        print(f"  a/M={a / M:4.2f}:  "
              f"{meas[0] / M:6.3f}/{meas[1] / M:6.3f}  |  "
              f"{anal[0] / M:6.3f}/{anal[1] / M:6.3f}   "
              f"err {max(errs):.2e}", flush=True)
    report["shadow_edges"] = rows
    gate(worst < 0.01, f"shadow edge error {worst:.3e} exceeds 1%")
    print(f"  worst relative error {worst:.2e} (< 1%)\n")

    # -- study 2: deflection vs b --------------------------------------
    bs = np.asarray([10.0, 20.0, 40.0] if args.quick
                    else [10.0, 15.0, 20.0, 30.0, 40.0, 60.0]) * M
    defl = measure_deflection(M, bs, n_steps=n_steps, device=dev)
    first = 4.0 * M / bs
    second = first + (15.0 * np.pi / 4.0) * (M / bs) ** 2
    resid = np.abs(defl - second)
    rows = [{"b_over_M": float(b / M), "measured_rad": float(d),
             "weak_field_rad": float(f), "with_2nd_order_rad": float(s)}
            for b, d, f, s in zip(bs, defl, first, second)]
    report["deflection"] = rows
    print("deflection vs b (measured | 4M/b | +2nd order), rad:")
    for r in rows:
        print(f"  b={r['b_over_M']:5.1f} M: {r['measured_rad']:.5f} | "
              f"{r['weak_field_rad']:.5f} | {r['with_2nd_order_rad']:.5f}")
    # residual against the 2nd-order series must fall ~ (M/b)^3
    ratio = (resid[0] / resid[-1]) / float((bs[-1] / bs[0]) ** 3)
    gate(0.2 < ratio < 5.0, f"residual scaling off: {ratio}")
    print(f"  2nd-order residual scales as (M/b)^3 within x{ratio:.2f}\n")

    # -- study 3: disk beaming asymmetry vs inclination ----------------
    incs = [0.0, 0.6, 1.1] if args.quick else [0.0, 0.3, 0.6, 0.9, 1.2]
    ratios = measure_disk_asymmetry(incs, size=64 if args.quick else 96,
                                    device=dev)
    report["disk_asymmetry"] = [
        {"inclination_rad": float(i), "flux_ratio": float(r)}
        for i, r in zip(incs, ratios)]
    print("disk beaming asymmetry vs inclination (flux ratio):")
    for i, r in zip(incs, ratios):
        print(f"  inc={i:3.1f} rad: {r:6.2f}")
    gate(ratios[0] < 1.3, "face-on disk must be symmetric")
    gate(all(b >= a * 0.95 for a, b in zip(ratios, ratios[1:])), str(ratios))
    gate(ratios[-1] > 1.5, "edge-on beaming asymmetry missing")
    print("  monotone, symmetric face-on, strongly beamed edge-on\n")

    path = os.path.join(args.outdir, "parameter_study.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"study done in {time.perf_counter() - t0:.1f}s -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
