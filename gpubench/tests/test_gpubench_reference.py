"""The frozen reference against the port's plain path, at a tiny size of
each configuration: the same frames, the same inverse-rendering steps.
Should the port's plain path drift from the copy, this shows it."""

import pytest
import torch

import _tiny
from gpubench import compare, loops

torch.set_num_threads(2)


@pytest.mark.parametrize("config", ["orbit_anim_1024", "einstein_ring_512"])
def test_frames_equal_the_reference(config):
    loop = loops.make(_tiny.cell(f"{config}.frames"), _tiny.SEED, "cpu")
    loop.setup()
    for i in range(3):
        loop.item(i)
    got = loop.numbers()
    assert got["px_off"] == 0.0 and got["mean_abs"] < 0.01


@pytest.mark.parametrize("config", ["orbit_anim_1024", "einstein_ring_512"])
def test_fit_steps_equal_the_reference(config):
    loop = loops.make(_tiny.cell(f"{config}.fit", 16), _tiny.SEED, "cpu")
    loop.setup()
    for k in range(loop.first, loop.first + 3):
        loop.item(k)
    assert loop.window is not None and loop.window["k"] >= loop.first
    got = loop.numbers()
    assert got["loss_gap"] < 1e-4
    assert got["grad_gap"] < 1e-4
    # the window's step, redone from the program's parameters and moments
    assert got["window_change_gap"] < 2e-3
    # Adam scales each texel's step by its own gradient's size, so texels
    # whose gradient is near zero on both sides move by different shares
    # of the rate: the change agrees less closely than the gradient
    assert got["change_gap"] < 2e-3
    # every learned leaf moved, and the gradient reached each
    assert all(float(c.abs().max()) > 0 for c in loop.change.values())


def test_u8_quantization_is_the_programs():
    """The reference's tonemap and quantization, and the comparison's
    count of pixels off."""
    rgb = torch.tensor([[[0.0, 0.5, 1.0], [2.0, 0.25, 0.002]]])
    from gpubench.reference import render as R

    u8 = R.to_u8(rgb, tonemap=True)
    assert u8.dtype == torch.uint8 and u8.shape == (1, 2, 4)
    assert u8[0, 0].tolist() == [0, 85, 128, 255]
    other = u8.clone()
    other[0, 1, 0] += 3
    got = compare.frame_numbers(other, u8)
    assert got["px_off"] == 0.5 and got["mean_abs"] == 3 / 8
