"""Per-ray debug dumps for the crop window (PyTorch port of
render/debug.py): one batched trace of the marked pixels, returned as a
dict of numpy arrays and as the reference's ``debug_string`` text."""

from __future__ import annotations

import numpy as np
import torch

from ..camera.pinhole import Camera, pixel_grid
from ..ops import states
from ..ops.integrate import final_direction
from .renderer import RenderConfig, trace_rays

STATUS_NAMES = {
    states.ACTIVE: "ACTIVE", states.CAPTURED: "CAPTURED",
    states.ESCAPED: "ESCAPED", states.BUDGET: "BUDGET",
    states.DISK: "DISK", states.OBJECT: "OBJECT",
    states.INSIDE_HORIZON: "INSIDE_HORIZON", states.ERROR: "ERROR",
}


def debug_rays(scene, cam: Camera, cfg: RenderConfig) -> dict:
    """Trace the rays of the (cropped) pixel grid and return their launch
    and termination record: ys, xs, origin, direction, end_loc, end_dir,
    lam, status, hit_obj -- all numpy, shaped (n_marked, ...).  end_loc is
    in the hole's frame (where every shader works), origin in the
    world's."""
    x0c, x1c, y0c, y1c = cfg.crop()
    ys, xs = pixel_grid(cfg.width, cfg.height, x0c, x1c, y0c, y1c,
                        device=cam.position.device)
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    with torch.no_grad():
        t = trace_rays(scene, cam, cfg, ys, xs)
        end_dir = final_direction(t.env, t.s)
    s = t.s
    out = {"ys": ys, "xs": xs, "origin": t.origin, "direction": t.d,
           "end_loc": s.x, "end_dir": end_dir, "lam": s.lam,
           "status": s.status, "hit_obj": s.hit_obj}
    return {k: v.contiguous().cpu().numpy() for k, v in out.items()}


def format_debug_string(rec: dict, max_rays: int | None = None) -> str:
    """The reference's ``debug_string`` layout, one line per marked ray."""
    n = len(rec["ys"]) if max_rays is None else min(max_rays, len(rec["ys"]))
    lines = []
    for i in range(n):
        st = STATUS_NAMES.get(int(rec["status"][i]), "?")
        lines.append(
            f"[{int(rec['xs'][i])},{int(rec['ys'][i])}] "
            f"loc={np.round(rec['origin'][i], 4).tolist()} "
            f"dir={np.round(rec['direction'][i], 4).tolist()} "
            f"end_loc={np.round(rec['end_loc'][i], 4).tolist()} "
            f"end_dir={np.round(rec['end_dir'][i], 4).tolist()} "
            f"lam={float(rec['lam'][i]):.3f} {st}"
        )
    return "\n".join(lines)
