"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference's answer to the same inputs.

Frames: ``px_off`` is the share of pixels of which some channel of the
uint8 frame lies more than ``LEVELS`` levels from the reference's, and
``mean_abs`` the mean absolute difference in levels over every pixel and
channel; each is the worst over the compared frames.

Inverse-rendering steps: ``loss_gap`` is the largest relative gap between
the program's and the reference's loss over the compared steps (the
first steps from the start and the window's step from the program's
state); ``grad_gap`` the worst leaf's gap between the norms of the first
step's gradient as each optimizer got it; ``change_gap`` the worst
leaf's gap between the norms of the parameters' change over the first
steps, and ``change_gap_median`` the median leaf's; ``window_change_gap``
the worst leaf's gap between the norms of the window step's change.  A
leaf's gap is measured against the reference's norm of that leaf or of
the median leaf, whichever is larger.  A cell compares the numbers that
its limits file names (PERF.md gives why each cell compares which).
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the changes' gaps.
"""

from __future__ import annotations

import statistics

import torch

LEVELS = 2


def frame_numbers(prog_u8: torch.Tensor, ref_u8: torch.Tensor) -> dict:
    """(px_off, mean_abs) of one (H, W, 4) uint8 frame against the
    reference's."""
    if prog_u8.shape != ref_u8.shape or prog_u8.dtype != torch.uint8:
        return {"px_off": 1.0, "mean_abs": 255.0}
    d = (prog_u8.to(torch.int16) - ref_u8.to(torch.int16)).abs()
    return {"px_off": float((d.amax(-1) > LEVELS).float().mean()),
            "mean_abs": float(d.float().mean())}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |norm(prog) - norm(ref)| over max(norm(ref leaf),
    median leaf norm of ref); a NaN norm reads inf."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double()))
             for k in ref}
    med = statistics.median(norms.values())
    out = {}
    for k in ref:
        if keep is not None and k not in keep:
            continue
        p = float(torch.linalg.vector_norm(prog[k].double()))
        out[k] = (abs(p - norms[k]) / max(norms[k], med, 1e-30)
                  if p == p else float("inf"))
    return out


def moved(ref_grad: dict) -> set:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    gnorm = {k: float(torch.linalg.vector_norm(g.double()))
             for k, g in ref_grad.items()}
    med = statistics.median(gnorm.values())
    return {k for k, v in gnorm.items() if v >= 1e-3 * med}


def fit_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [...], "grad": {leaf: first
    gradient}, "change": {leaf: parameter change}, "window": {"loss",
    "grad", "change"} of the window's step (absent if none was run)}."""
    pairs = list(zip(prog["losses"], ref["losses"]))
    out = {}
    if "window" in ref:
        pw, rw = prog["window"], ref["window"]
        pairs.append((pw["loss"], rw["loss"]))
        out["window_change_gap"] = max(leaf_gaps(
            pw["change"], rw["change"], moved(rw["grad"])).values())
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in pairs]
    change = leaf_gaps(prog["change"], ref["change"], moved(ref["grad"]))
    out.update({
        "loss_gap": max(gaps) if all(g == g for g in gaps) else float("inf"),
        "grad_gap": max(leaf_gaps(prog["grad"], ref["grad"]).values()),
        "change_gap": max(change.values()),
        "change_gap_median": statistics.median(change.values())})
    return out
