"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

At first use, ``nvcc`` compiles every source under ``csrc/`` into one shared
library with a plain C interface, under ``build/kernels/<hash>/`` at the
root of the checkout; the hash covers the sources and the flags, so an
edited source rebuilds and an unchanged one is reused.  The library is
loaded with ``ctypes``.  Nothing here runs at import time, and a failed
build raises: there is no fallback to the plain PyTorch path.
"""

from __future__ import annotations

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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "libbhgc_kernels.so"

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    srcs = sorted(_CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources found under {_CSRC}")
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


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the sources unless a library for them exists; return its path.

    The compiler's output, including ``-Xptxas=-v``'s registers and spills
    per kernel, is kept beside the library as ``build.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load the library and declare its C signatures.

    The first success is kept for the life of the process, so a launch pays
    no hashing or file-system work after it."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # scal, x, p, E, lam, status, x_out, p_out, lam_out, status_out,
        # n, n_steps, power, stream
        lib.bhgc_rk4_fwd.argtypes = [vp] * 10 + [i32, i32, f32, vp]
        lib.bhgc_rk4_fwd.restype = i32
        _lib = lib
    return _lib
