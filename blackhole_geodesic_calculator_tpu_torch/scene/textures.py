"""Named texture registry (a copy of the JAX package's scene/textures.py,
which this package may not import).

The reference keeps a hardcoded name -> image-file table and loads each file
idempotently into ``bpy.data.textures``
(LimitedRelativisticRenderEngine.py:26-37,441-455,
texture_dir at :38).  Standalone equivalent: the same names resolve to
``(H, W, 3)`` float32 arrays -- from image files under ``texture_dir`` when
present, otherwise from deterministic procedural stand-ins (starfields, a
cratered moon, seamless disk clouds, the UV test card), so every reference
scene renders without the author's private asset directory.  Loads are
cached per (name, dir).
"""

from __future__ import annotations

import os
import zlib

import numpy as np

# The reference's table (LimitedRelativisticRenderEngine.py:26-37), name ->
# expected file; the kind drives the procedural fallback.
TEXTURES: dict[str, dict] = {
    "background": {"file_name": "8k_stars_milky_way.jpg", "kind": "stars"},
    "bg_ngc3293": {"file_name": "high_ngc3293_eso_8682x8436.jpg",
                   "kind": "stars"},
    "puppis": {"file_name": "ThreeClustersPuppis1824x1447.jpg",
               "kind": "stars"},
    "high_PIA23647": {"file_name": "high_PIA23647.png", "kind": "stars"},
    "perseus-cluster": {
        "file_name": "high_1-Perseus-cluster_1oEasJg_6500x6500.jpg",
        "kind": "stars"},
    "moon": {"file_name": "8k_moon.jpg", "kind": "moon"},
    "test": {"file_name": "test.png", "kind": "test"},
    "disk_clouds": {"file_name": "clouds_seamless_1024-512.png",
                    "kind": "clouds"},
    "disk_clouds_high_contr": {
        "file_name": "clouds_seamless_2024_512_high_contr.png",
        "kind": "clouds", "contrast": 2.0},
    "disk_clouds_high_contr_color1": {
        "file_name": "clouds_seamless_2024_512_high_contr_color1.png",
        "kind": "clouds", "contrast": 2.0, "tint": (1.0, 0.6, 0.25)},
}

_cache: dict[tuple, np.ndarray] = {}


def _smooth_noise(h, w, octaves, seed):
    """Seamless (wrap-around) value noise via randomized Fourier modes."""
    rng = np.random.default_rng(seed)
    v = np.zeros((h, w), np.float32)
    yy, xx = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    for o in range(octaves):
        k = 2 ** (o + 1)
        for _ in range(3):
            ky, kx = rng.integers(1, k + 1, 2)
            ph = rng.uniform(0, 2 * np.pi)
            v += (0.5 ** o) * np.sin(
                2 * np.pi * (ky * yy + kx * xx) + ph).astype(np.float32)
    v -= v.min()
    return v / max(v.max(), 1e-9)


def _procedural(kind: str, spec: dict, h: int, w: int,
                seed: int) -> np.ndarray:
    if kind == "stars":
        rng = np.random.default_rng(seed)
        img = np.zeros((h, w, 3), np.float32)
        img += 0.02 * _smooth_noise(h, w, 3, seed + 1)[..., None]  # nebula
        n_stars = h * w // 150
        ys = rng.integers(0, h, n_stars)
        xs = rng.integers(0, w, n_stars)
        mag = rng.power(4.0, n_stars).astype(np.float32)
        tint = rng.uniform(0.7, 1.0, (n_stars, 3)).astype(np.float32)
        img[ys, xs] = np.maximum(img[ys, xs], mag[:, None] * tint)
        return np.clip(img, 0.0, 1.0)
    if kind == "moon":
        base = 0.35 + 0.3 * _smooth_noise(h, w, 5, seed)
        craters = _smooth_noise(h, w, 6, seed + 7)
        base = base - 0.25 * (craters > 0.75) * (craters - 0.75) * 4.0
        g = np.clip(base, 0.0, 1.0).astype(np.float32)
        return np.stack([g, g, g * 0.95], -1)
    if kind == "clouds":
        v = _smooth_noise(h, w, 6, seed)
        c = float(spec.get("contrast", 1.0))
        v = np.clip(0.5 + (v - 0.5) * c, 0.0, 1.0).astype(np.float32)
        tint = np.asarray(spec.get("tint", (1.0, 1.0, 1.0)), np.float32)
        return v[..., None] * tint
    # 'test': UV card -- red/green ramps + 8px checker, seam markers
    yy, xx = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    checker = ((np.arange(h)[:, None] // 8 + np.arange(w)[None, :] // 8) % 2)
    return np.stack([xx, yy, 0.5 * checker], -1).astype(np.float32)


def load_texture(name: str, texture_dir: str | None = None,
                 size: tuple[int, int] = (512, 1024)) -> np.ndarray:
    """Resolve a registry name (or a file path) to an (H, W, 3) f32 array.

    File under ``texture_dir`` wins when it exists; otherwise the
    deterministic procedural stand-in of the entry's kind is generated at
    ``size``.  Results are cached (the reference's idempotent
    ``bpy.data.images.load``, LimitedRelativisticRenderEngine.py:446-448).
    """
    key = (name, texture_dir, size)
    if key in _cache:
        return _cache[key]

    arr = None
    spec = TEXTURES.get(name)
    candidates = []
    if spec and texture_dir:
        candidates.append(os.path.join(texture_dir, spec["file_name"]))
    if os.path.sep in name or name.lower().endswith(
            (".png", ".jpg", ".jpeg", ".pfm")):
        candidates.append(name if texture_dir is None
                          else os.path.join(texture_dir, name))
    for path in candidates:
        if os.path.exists(path):
            from ..io_.image import read_image

            arr = np.asarray(read_image(path), np.float32)
            break
    if arr is None:
        if spec is None:
            raise KeyError(
                f"unknown texture {name!r}; registry names: "
                f"{sorted(TEXTURES)}")
        h, w = size
        # Stable cross-process seed: Python's str hash is salted per process
        # (PYTHONHASHSEED), which would give every host of a multi-host
        # render a DIFFERENT procedural sky and break animate --resume
        # bit-reproducibility across restarts.  crc32 is deterministic.
        seed = zlib.crc32(name.encode())
        arr = _procedural(spec["kind"], spec, h, w, seed)
    _cache[key] = arr
    return arr


def load_all(texture_dir: str | None = None) -> dict[str, np.ndarray]:
    """The reference's ``loadTextures()``: materialize the whole table."""
    return {name: load_texture(name, texture_dir) for name in TEXTURES}
