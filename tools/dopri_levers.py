"""Device times of the Dormand-Prince kernels for several versions of their
CUDA sources, in turns on one card.

    python3 tools/dopri_levers.py [--table] [--turns N] [NAME=CSRC_DIR ...]

Run from the root of a checkout on a machine with a CUDA device and nvcc.
With ``--table`` it first runs chip_smoke.py's phase 26 on the checkout's
own sources: the bound of every Dormand-Prince variant, the forward table
of dopri_fwd and dopri_ckpt (registers, spills, blocks per SM, SASS census,
busy lanes and warps, rejected trips, device ms) and the adjoint table of
dopri_bwd.  Each NAME=CSRC_DIR is a directory of CUDA sources: a copy of
``blackhole_geodesic_calculator_tpu_torch/ops/csrc`` with one change, such
as a lever taken out.  Every version is built into its own library (all at
once), and dopri_fwd, dopri_ckpt and dopri_bwd (in cost order, as the main
path runs it) are timed on phase 26's frames -- the 262,144-ray fans of
bench.py's adaptive rows, Schwarzschild and a = 0.45, and the 512^2
Einstein rings -- through each version in turns, the checkout's own
("tree") first, in order and then reversed.  It prints, per version, its
ptxas registers and spills, each row's device ms (the mean of its turns'
medians) and whether its outputs equal the tree's bit for bit, and last a
JSON line of the same.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.ops import (  # noqa: E402
    _build, cuda_kernel)


def frame_launches(frames):
    """{(row, kind): make} for each frame of ``frames`` (dopri_frames) and
    kernel: make() returns the kernel's launch, a function of nothing.  The
    adjoint's make runs dopri_ckpt first, for its checkpoints, through the
    version of the sources in use."""
    out = {}
    for suffix, (env, cfg_f, cfg_g, s0) in frames.items():
        launch = c.dopri_launches(env, cfg_f, cfg_g, s0)
        args, ctl, kw = c.dopri_args(env, cfg_g, s0)
        del kw["obj"]
        seg = cuda_kernel.segment(cfg_g.n_steps)
        g = torch.ones_like(s0.x)
        row = f"dopri{suffix or '_fan'}"

        def bwd(launch=launch, args=args, ctl=ctl, kw=kw, seg=seg, g=g,
                s0=s0, n=cfg_g.n_steps):
            ck = launch["ckpt"]()[-1]
            return lambda: cuda_kernel.dopri_bwd(args[0], ck, s0.E, g, g, n,
                                                 seg, ctl, tile_order="cost",
                                                 **kw)

        out[row, "fwd"] = lambda f=launch["fwd"]: f
        out[row, "ckpt"] = lambda f=launch["ckpt"]: f
        out[row, "bwd"] = bwd
    return out


def tensors(out):
    """The tensors of a wrapper's result, the checkpoints' among them."""
    for t in out:
        if torch.is_tensor(t):
            yield t
        else:
            yield from t


def ptxas_summary(lib_path):
    """{kernel: "registers/stack/spill stores/spill loads"} of the
    Dormand-Prince kernels in a build's log."""
    info = c.ptxas_info(lib_path)
    out = {}
    for name, (r, st, sp_st, sp_ld) in info.items():
        m = re.search(r"(dopri_\w+?)_kernelILb(\d)ELi(\d)E", name)
        if m:
            out[f"{m.group(1)} kerr={m.group(2)} ev={m.group(3)}"] = (
                f"{r}/{st}/{sp_st}/{sp_ld}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--table", action="store_true",
                    help="run chip_smoke.py's phase 26 on the tree first")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("versions", nargs="*", metavar="NAME=CSRC_DIR")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("dopri_levers: no CUDA device", file=sys.stderr)
        return 1
    name_limit = c.card()
    c.log(name_limit)
    dev = torch.device("cuda", 0)
    versions = {"tree": _build._CSRC}
    for v in a.versions:
        name, d = v.split("=", 1)
        versions[name] = Path(d).resolve()
    with concurrent.futures.ThreadPoolExecutor(min(len(versions), 4)) as pool:
        libs = dict(zip(versions, pool.map(lambda d: _build.build((), d),
                                           versions.values())))
    _build.load()
    for name, lib in libs.items():
        c.log(f"# {name}: ptxas registers/stack/spills "
              f"{ptxas_summary(lib)}")
    if a.table:
        readings = {k: {} for k in c.KERNELS}
        c.phase("phase 26", c.phase_dopri_bounds, dev, name_limit, readings)
    launches = frame_launches(c.dopri_frames(dev))
    ms = {v: {key: [] for key in launches} for v in versions}
    same = {v: {} for v in versions}
    ref = {}
    for turn in range(a.turns):
        order = list(versions) if turn % 2 == 0 else list(versions)[::-1]
        for v in order:
            with torch.no_grad(), _build.built_from(versions[v]):
                for key, make in launches.items():
                    fn = make()
                    if turn == 0:
                        out = list(tensors(fn()))
                        if v == "tree":
                            ref[key] = out
                        else:
                            same[v][key] = all(
                                torch.equal(x, y)
                                for x, y in zip(out, ref[key]))
                    ms[v][key].append(c.device_ms(fn))
    rows = {v: {f"{row} {kind}": sum(t) / len(t)
                for (row, kind), t in ms[v].items()} for v in versions}
    for v in versions:
        c.log(f"# {v}: " + ", ".join(f"{k} {t:.3f}"
                                     for k, t in rows[v].items())
              + f" ms device [{name_limit}]")
        if v != "tree":
            differ = [f"{r} {k}" for (r, k), s in same[v].items() if not s]
            c.log(f"# {v}: outputs equal the tree's bit for bit"
                  if not differ else f"# {v}: outputs differ on {differ}")
    c.log(json.dumps({"card": name_limit, "ms": rows, "bitwise": {
        v: all(s.values()) for v, s in same.items() if v != "tree"}}))
    return 1 if c.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
