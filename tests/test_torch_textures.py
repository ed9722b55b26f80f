"""PyTorch port against the JAX package: the named texture registry
(``scene/textures.py``, a copy of the JAX module).

Every registry name resolves to the JAX package's array exactly -- the
procedural stand-ins are seeded by crc32 of the name, which keeps
``animate --resume`` bit-identical across processes -- and the twin of
tests/test_compat.py::test_texture_registry holds the cache and the
errors.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from blackhole_geodesic_calculator_tpu.scene import textures as JT  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch import io_  # noqa: E402
from blackhole_geodesic_calculator_tpu_torch.scene import (  # noqa: E402
    TEXTURES, load_all, load_texture)
from blackhole_geodesic_calculator_tpu_torch.scene import textures as PT  # noqa: E402


def test_registry_is_the_jax_packages():
    assert TEXTURES == JT.TEXTURES


@pytest.mark.parametrize("name", sorted(JT.TEXTURES))
def test_texture_equals_jax(name):
    tex = load_texture(name, size=(24, 48))
    ref = JT.load_texture(name, size=(24, 48))
    assert tex.dtype == ref.dtype == np.float32
    assert tex.shape == (24, 48, 3)
    np.testing.assert_array_equal(tex, ref)


def test_texture_registry():
    """Twin of tests/test_compat.py::test_texture_registry."""
    assert {"background", "moon", "test", "disk_clouds"} <= set(TEXTURES)
    tex = load_texture("background", size=(64, 128))
    assert tex.shape == (64, 128, 3) and tex.dtype == np.float32
    assert 0.0 <= tex.min() and tex.max() <= 1.0
    # idempotent cache: same object back
    assert load_texture("background", size=(64, 128)) is tex
    # distinct kinds differ
    moon = load_texture("moon", size=(64, 128))
    assert not np.array_equal(moon, tex)
    allt = load_all()
    assert set(allt) == set(TEXTURES)
    np.testing.assert_array_equal(allt["moon"], JT.load_texture("moon"))
    with pytest.raises(KeyError):
        load_texture("nope")


def test_texture_dir_file_wins(tmp_path):
    """A file under texture_dir with the entry's file name replaces the
    procedural stand-in, read through the port's io_.read_image; an image
    path resolves as a name."""
    img = np.random.default_rng(0).random((6, 10, 3)).astype(np.float32)
    io_.write_png(str(tmp_path / TEXTURES["moon"]["file_name"]), img)
    tex = load_texture("moon", texture_dir=str(tmp_path), size=(8, 16))
    np.testing.assert_array_equal(
        tex, io_.read_image(str(tmp_path / TEXTURES["moon"]["file_name"])))
    assert tex.shape == (6, 10, 3)
    path = str(tmp_path / "sky.png")
    io_.write_png(path, img)
    np.testing.assert_array_equal(load_texture(path), io_.read_image(path))
    assert PT._cache is not JT._cache
