"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

At first use, ``nvcc`` compiles every source under ``csrc/`` into an object
file -- one compiler process per source, all started together -- and links
them into one shared library with a plain C interface, under
``build/kernels/<hash>/`` at the root of the checkout; the hash covers the
sources, the headers they include and the flags, so an edited source
rebuilds and an unchanged one is reused.  The library is loaded with
``ctypes``.  Nothing here runs at import time, and a failed build raises:
there is no fallback to the plain PyTorch path.  ``built_with`` routes the
launches of a block through a witness build of the same sources with
preprocessor definitions (rk4_step.cuh's BHGC_SPHERE_GUARD=0,
BHGC_IEEE_RECIPROCALS=1), which chip_smoke.py holds the shipped kernels
against; ``built_from`` through a build of another directory of sources.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "libbhgc_kernels.so"

_lib: ctypes.CDLL | None = None


def _sources(csrc: Path) -> list[Path]:
    srcs = sorted(csrc.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources found under {csrc}")
    return srcs


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(defines: tuple[str, ...] = (), csrc: Path = _CSRC) -> Path:
    """Where the library for the sources under ``csrc`` (the package's by
    default) and the flags, with the preprocessor definitions ``defines``
    ("NAME=VALUE"), lives."""
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for src in sorted(Path(csrc).glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _run_all(cmds: list[list[str]]) -> list[tuple[list[str], int, str]]:
    """Run the commands at once; (command, exit code, output) for each."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    return [(cmd, proc.returncode, out)
            for cmd, proc, (out, _) in zip(cmds, procs,
                                           (p.communicate() for p in procs))]


def build(defines: tuple[str, ...] = (), csrc: Path = _CSRC) -> Path:
    """Compile the sources under ``csrc`` (with ``defines``) unless a
    library for them exists; return its path.

    The compilers' output, including ``-Xptxas=-v``'s registers and spills
    per kernel, is kept beside the library as ``build.log``."""
    srcs = _sources(Path(csrc))
    out = library_path(defines, csrc)
    flags = _flags(defines)
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        objs = [tmp / (src.stem + ".o") for src in srcs]
        runs = _run_all([[nvcc, *flags, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(srcs, objs)])
        if all(rc == 0 for _, rc, _ in runs):
            runs += _run_all([[nvcc, "-shared", "-o", str(tmp / LIB_NAME),
                               *map(str, objs)]])
        (out.parent / "build.log").write_text("".join(
            " ".join(cmd) + "\n" + text for cmd, _, text in runs))
        failed = [(cmd, rc, text) for cmd, rc, text in runs if rc != 0]
        if failed:
            cmd, rc, text = failed[0]
            raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n"
                               f"{text[-4000:]}")
        os.replace(tmp / LIB_NAME, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load the library and declare its C signatures.

    The first success is kept for the life of the process, so a launch pays
    no hashing or file-system work after it."""
    global _lib
    if _lib is None:
        _lib = _declare(ctypes.CDLL(str(build())))
    return _lib


def built_with(*defines: str):
    """Within the block, every launch goes through the library built with
    the preprocessor definitions ``defines`` ("NAME=VALUE"): a witness
    build, which chip_smoke.py holds the shipped library against."""
    return _routed(build(tuple(defines)))


def built_from(csrc: Path):
    """Within the block, every launch goes through the library built from
    the sources under ``csrc``: another version of the package's sources,
    which tools/dopri_levers.py times against them."""
    return _routed(build((), csrc))


@contextlib.contextmanager
def _routed(path):
    """Every launch of the block through the library at ``path``; the
    shipped one is back after it, also when the block raises."""
    global _lib
    shipped = load()
    _lib = _declare(ctypes.CDLL(str(path)))
    try:
        yield _lib
    finally:
        _lib = shipped


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the library's entry points."""
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # scal, sph, n_sph, has_disk, kerr, x, p, E, lam, status, hit_obj,
    # x_out, p_out, lam_out, status_out, hit_obj_out, n, n_steps, power,
    # stream
    lib.bhgc_rk4_fwd.argtypes = ([vp, vp, i32, i32, i32] + [vp] * 11
                                 + [i32, i32, f32, vp])
    lib.bhgc_rk4_fwd.restype = i32
    # as bhgc_rk4_fwd, then cx, cp, clam, cst, live before n, n_steps,
    # seg, power, stream
    lib.bhgc_rk4_ckpt.argtypes = ([vp, vp, i32, i32, i32] + [vp] * 16
                                  + [i32, i32, i32, f32, vp])
    lib.bhgc_rk4_ckpt.restype = i32
    # power, kerr, has_disk, n_sph -> resident blocks per SM
    for kind in ("fwd", "ckpt"):
        occupancy = getattr(lib, f"bhgc_rk4_{kind}_occupancy")
        occupancy.argtypes = [f32, i32, i32, i32]
        occupancy.restype = i32
    # scal, sph, n_sph, has_disk, kerr, cx, cp, clam, cst, E, gx, gp,
    # bx, bp, bE, partial, order, gscal, gsph, n, n_steps, seg, power,
    # stream
    lib.bhgc_rk4_bwd.argtypes = ([vp, vp, i32, i32, i32] + [vp] * 14
                                 + [i32, i32, i32, f32, vp])
    lib.bhgc_rk4_bwd.restype = i32
    lib.bhgc_rk4_bwd_blocks.argtypes = [i32]
    lib.bhgc_rk4_bwd_blocks.restype = i32
    # power, kerr, has_disk, n_sph -> resident blocks per SM
    lib.bhgc_rk4_bwd_occupancy.argtypes = [f32, i32, i32, i32]
    lib.bhgc_rk4_bwd_occupancy.restype = i32
    ctl = [f32] * 4   # rtol, atol, min_step, max_step
    # scal, sph, n_sph, has_disk, kerr, x, p, E, h, lam, status,
    # hit_obj, x_out, p_out, lam_out, status_out, hit_obj_out, n,
    # n_steps, the controller, stream
    lib.bhgc_dopri_fwd.argtypes = ([vp, vp, i32, i32, i32] + [vp] * 12
                                   + [i32, i32] + ctl + [vp])
    lib.bhgc_dopri_fwd.restype = i32
    # as bhgc_dopri_fwd, then cx, cp, ch, clam, cst, live before n,
    # n_steps, seg, the controller, stream
    lib.bhgc_dopri_ckpt.argtypes = ([vp, vp, i32, i32, i32] + [vp] * 18
                                    + [i32, i32, i32] + ctl + [vp])
    lib.bhgc_dopri_ckpt.restype = i32
    # n -> blocks of a launch; kerr, has_disk, n_sph -> resident blocks
    # per SM
    for kind in ("fwd", "ckpt"):
        blocks = getattr(lib, f"bhgc_dopri_{kind}_blocks")
        blocks.argtypes = [i32]
        blocks.restype = i32
        occupancy = getattr(lib, f"bhgc_dopri_{kind}_occupancy")
        occupancy.argtypes = [i32, i32, i32]
        occupancy.restype = i32
    # scal, sph, n_sph, has_disk, kerr, cx, cp, ch, clam, cst, E, gx,
    # gp, bx, bp, bE, partial, order, gscal, gsph, n, n_steps, seg, the
    # controller, stream
    lib.bhgc_dopri_bwd.argtypes = ([vp, vp, i32, i32, i32] + [vp] * 15
                                   + [i32, i32, i32] + ctl + [vp])
    lib.bhgc_dopri_bwd.restype = i32
    lib.bhgc_dopri_bwd_blocks.argtypes = [i32]
    lib.bhgc_dopri_bwd_blocks.restype = i32
    # kerr, has_disk, n_sph -> resident blocks per SM
    lib.bhgc_dopri_bwd_occupancy.argtypes = [i32, i32, i32]
    lib.bhgc_dopri_bwd_occupancy.restype = i32
    # c00, c01, c10, c11, tx, ty, xi0, xi1, yi0, yi1, g, n, C, H, W, sx,
    # sy, dx, dy, scratch, dtex (null: no texture cotangent), stream
    lib.bhgc_tex_bwd.argtypes = ([vp] * 11 + [i32] * 4 + [f32] * 2
                                 + [vp] * 5)
    lib.bhgc_tex_bwd.restype = i32
    i64 = ctypes.c_longlong
    # scal, sph, n_sph, lights, n_lights, then (pointer, H, W) of the sky,
    # the disk's texture and the spheres' stack, kerr, disk, sph_mode
    scene = [vp, vp, i32, vp, i32] + [vp, i32, i32] * 3 + [i32] * 3
    # the scene, x, p, E, status, hit_obj, out, n, stream
    lib.bhgc_shade_fwd.argtypes = scene + [vp] * 6 + [i32, vp]
    lib.bhgc_shade_fwd.restype = i32
    # the scene, need_sky, need_disk, need_moon, x, p, E, status,
    # hit_obj, g, gx, gp, gE, partial, ncol, cols, rec_slot, rec_uv,
    # rec_g, stat, n, stream
    lib.bhgc_shade_bwd.argtypes = (scene + [i32] * 3 + [vp] * 10 + [i32]
                                   + [vp] * 5 + [i32, vp])
    lib.bhgc_shade_bwd.restype = i32
    lib.bhgc_shade_bwd_blocks.argtypes = [i32]
    lib.bhgc_shade_bwd_blocks.restype = i32
    # rec_slot, rec_uv, rec_g, n, (H, W, first texel) of the sky, the
    # disk's texture and the spheres' stack, texels, scratch, dtex, stream
    lib.bhgc_shade_tex.argtypes = ([vp] * 3 + [i32] + [i32, i32, i64] * 3
                                   + [i64, vp, vp, vp])
    lib.bhgc_shade_tex.restype = i32
    return lib
