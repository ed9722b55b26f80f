"""The general generator: the timed loops that a traffic mix's data file
drives over a configuration.

A mix names its loop (``"loop": "frames"``); the loop is the module of
that name in this package, found by name as the per-layer metrics are, so
a new kind of loop is a new file.  Each module's ``Loop(cell, seed,
device)`` has:

* ``setup()``, then ``item(i)``: one timed frame or step, from item
  ``first``; a window closes on a whole ``cycle`` of items;
* ``release()``: frees the program's state once the window has closed;
* ``numbers()``: the compared numbers of the timed path against the
  plain reference, and ``control(dtype)`` the same with the reference
  computed in ``dtype`` in the program's place;
* ``traced_rays()``: the reference's initial states of the rays that the
  traced items integrated, for the work of the rooflines.
"""

from __future__ import annotations

import importlib
import re

_NAME = re.compile(r"^[a-z][a-z0-9_]*$")


def make(cell: dict, seed: int, device):
    kind = cell["traffic"]["loop"]
    if not _NAME.match(kind) or kind == "base":
        raise ValueError(f"bad loop name {kind!r}")
    try:
        mod = importlib.import_module(f"{__name__}.{kind}")
    except ModuleNotFoundError as e:
        raise ValueError(f"no loop {kind!r} (gpubench/loops/{kind}.py) for "
                         f"traffic {cell['traffic']}") from e
    return mod.Loop(cell, seed, device)
