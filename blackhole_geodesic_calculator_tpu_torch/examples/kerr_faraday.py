"""Spin-dependent polarization transport around a Kerr black hole
(PyTorch port of examples/kerr_faraday.py).

In Schwarzschild spacetime, parallel transport produces NO polarization
rotation relative to the orbital-plane decomposition (Plebanski 1960) --
the closed form ``ops/polarization.transport_polarization`` is exact.
Around a KERR hole that law breaks: the transported polarization acquires
an extra rotation relative to the Schwarzschild-law prediction for the
same escape direction, combining gravitational Faraday rotation (odd
under spin reversal) with spin-induced out-of-plane transport geometry
(even).  This example measures that excess per pixel via the
parallel-transport ODE (``transport_polarization_ode`` with the analytic
Kerr-Schild directional Christoffel contraction, a loop of PyTorch
operations: no kernel) and checks the three physics signatures:

(a) the a = 0 excess is ~0 to float noise -- the no-Faraday theorem, and
    an end-to-end validation of the transport ODE against the
    independent closed form;
(b) the excess grows monotonically with spin;
(c) a substantial part of it is ODD under spin reversal a -> -a
    (computed from the +a / -a map pair): the rotation knows the
    DIRECTION of frame dragging, not just its magnitude.

Camera: equatorial view (position on -y, spin axis +z up in the image).
Writes maps to npz (+ PNG quick-look) and a JSON summary:

    python -m blackhole_geodesic_calculator_tpu_torch.examples.kerr_faraday
        [--size 96] [--n-steps 600] [--outdir DIR] [--device cuda|cpu]
"""

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

from . import add_device_arg, device_of, gate

D = 25.0      # the camera's distance; rays stop at 2 D


def equatorial_rays(size, device="cuda"):
    """(o3, d3, f0) of the equatorial camera's size^2 pixel centres: the
    origins, unit directions and the in-plane launch polarizations."""
    from ..camera import Camera
    from ..camera.pinhole import generate_rays, pixel_grid
    from ..ops.polarization import _cross, _unit, plane_normal

    cam = Camera.make(position=(0.0, -D, 0.0), euler=(math.pi / 2, 0.0, 0.0),
                      fov=(0.55, 0.55), device=device)
    ys, xs = pixel_grid(size, size, 0, size, 0, size, device=device)
    o, d = generate_rays(cam, size, size, ys, xs, None)
    o3, d3 = o.reshape(-1, 3), d.reshape(-1, 3)
    return o3, d3, _unit(_cross(d3, plane_normal(o3, d3)))


def excess_map(a, size=96, n_steps=600, device="cuda"):
    """Signed angle between the ODE-transported polarization and the
    Schwarzschild-law prediction for the SAME escape direction, (size,
    size) numpy, NaN where the ray did not escape."""
    from ..models import kerr_ks_metric
    from ..ops.polarization import (_cross, transport_polarization,
                                    transport_polarization_ode)

    o3, d3, f0 = equatorial_rays(size, device)
    with torch.no_grad():
        f_obs, d1, x1, _ = transport_polarization_ode(
            kerr_ks_metric(0.5, a), o3, d3, f0, n_steps=n_steps, dt=0.08,
            r_stop=2.0 * D, dt_boost=16.0, r_ref=1.6)
        esc = (torch.linalg.norm(x1, dim=-1) >= 0.99 * 2 * D).cpu().numpy()
        f_pred = transport_polarization(o3, d3, f0, d1)
        cosang = torch.clamp(torch.sum(f_obs * f_pred, -1), -1.0, 1.0)
        sgn = torch.sign(torch.sum(_cross(f_pred, f_obs) * d1, -1))
        ang = (torch.arccos(cosang) * sgn).cpu().numpy()
    return np.where(esc, ang, np.nan).reshape(size, size)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blackhole_geodesic_calculator_tpu_torch.examples."
        "kerr_faraday")
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--spins", type=float, nargs="+",
                    default=[0.0, 0.25, 0.45])
    ap.add_argument("--n-steps", type=int, default=600)
    ap.add_argument("--outdir", default=".")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    from ..io_ import write_png

    def excess(a):
        return excess_map(a, args.size, args.n_steps, dev)

    results, excess_rms = {}, []
    for a in args.spins:
        results[a] = excess(a)
        rms = float(np.sqrt(np.nanmean(results[a] ** 2)))
        excess_rms.append(rms)
        print(f"a = {a:+.2f}: transport excess rms {rms:.2e} rad",
              flush=True)

    # --- signature (a): exact zero at a = 0 (ODE vs closed form);
    # only applicable when the sweep includes a = 0
    if args.spins[0] == 0.0:
        gate(excess_rms[0] < 2e-3, str(excess_rms))
    # --- signature (b): monotonic growth with spin ------------------------
    gate(all(hi > 1.5 * lo
             for lo, hi in zip(excess_rms[:-1], excess_rms[1:])),
         str(excess_rms))
    # --- signature (c): substantial spin-ODD component --------------------
    a_top = args.spins[-1]
    e_plus = results[a_top]
    e_minus = excess(-a_top)
    both = np.isfinite(e_plus) & np.isfinite(e_minus)
    odd = 0.5 * (e_plus - e_minus)
    tot = np.sqrt(np.nanmean(e_plus[both] ** 2))
    odd_rms = np.sqrt(np.nanmean(odd[both] ** 2))
    frac = float(odd_rms / max(tot, 1e-12))
    print(f"spin-odd fraction of the excess at a = {a_top}: {frac:.2f} "
          f"(odd rms {odd_rms:.2e} / total {tot:.2e} rad)")
    gate(frac > 0.25, str(frac))

    os.makedirs(args.outdir, exist_ok=True)
    out = os.path.join(args.outdir, "kerr_faraday.npz")
    np.savez(out, odd_component=odd,
             **{f"excess_a{a:g}": results[a] for a in args.spins})
    with open(os.path.join(args.outdir, "kerr_faraday.json"), "w") as f:
        json.dump({"spins": args.spins, "excess_rms": excess_rms,
                   "spin_odd_fraction": frac}, f, indent=1)
    v = np.nan_to_num(odd / max(np.nanmax(np.abs(odd)), 1e-9))
    write_png(os.path.join(args.outdir, "kerr_faraday.png"),
              np.stack([np.clip(v, 0, 1), np.zeros_like(v),
                        np.clip(-v, 0, 1)], -1))
    print(f"maps written to {out}")
    print("KERR TRANSPORT SIGNATURES OK (zero at a=0, growing with spin, "
          "spin-odd component present)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
