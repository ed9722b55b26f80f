"""The example programs (PyTorch port of examples/*.py), each runnable as
``python -m blackhole_geodesic_calculator_tpu_torch.examples.<name>``:

  parameter_study  Kerr shadow edges against Bardeen's formula, the
                   weak-field deflection series, disk beaming against
                   inclination
  kerr_faraday     the spin-odd part of Kerr polarization transport
  fit_orbit        mass and orbit pose recovered from rendered frames
  tutorial         every layer of the package in one pass

Each takes the JAX script's arguments and defaults plus ``--device``
(default ``cuda``: the card, through the hand-written kernels; ``cpu``
runs the plain PyTorch paths), writes the same files and checks the same
physics inside the script; ``main(argv)`` returns the exit code.
"""

import torch


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda: the card; "
                    "cpu runs the plain PyTorch paths)")


def device_of(name: str) -> torch.device:
    """``--device``'s device; a CUDA device on a host without one raises,
    nothing falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device here; pass "
                           "--device cpu to run on the CPU")
    return dev


def gate(ok: bool, msg: str) -> None:
    """A physics check of the script: raises AssertionError when it fails
    (as the JAX scripts' asserts do, but not removed under -O)."""
    if not ok:
        raise AssertionError(msg)
