"""Faults planted in the program under the timed path, which the check has
to catch: each is a context manager that patches the program for the
length of a run.

* ``answer`` (frames): an answer altered where it is produced: every
  uint8 frame leaves ``render_image_u8`` with the central block of 1/64
  of its pixels inverted.
* ``unchanged`` (fit): a step that leaves its state unchanged: the
  optimizer's update does nothing.
* ``half_batch`` (fit): half of the batch left out, the mean taken over
  the rest: the Trainer's share of the target is its first half of rays.

A cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch

FOR_LOOP = {"frames": ("answer",), "fit": ("unchanged", "half_batch")}


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def planted(fault: str):
    import blackhole_geodesic_calculator_tpu_torch as P

    if fault == "answer":
        real = P.render_image_u8

        def altered(*args, **kwargs):
            img = real(*args, **kwargs).clone()
            h, w = img.shape[0], img.shape[1]
            block = img[7 * h // 16:9 * h // 16, 7 * w // 16:9 * w // 16, :3]
            block.copy_(255 - block)
            return img

        return _patched(P, "render_image_u8", altered)
    if fault == "unchanged":
        return _patched(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    if fault == "half_batch":
        real = P.Trainer.shard_target

        def half(self, target_image):
            flat, ys, xs = real(self, target_image)
            k = flat.shape[0] // 2
            return flat[:k], ys[:k], xs[:k]

        return _patched(P.Trainer, "shard_target", half)
    raise ValueError(f"unknown fault {fault!r}")
