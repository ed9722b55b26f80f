"""Image IO (a copy of the JAX package's io_/image.py, which this package
may not import).

PNG out through a pure-zlib encoder, so writing frames needs no dependency
beyond numpy; images in through PIL; and a Reinhard tonemap for the disk's
HDR intensities.  The JAX package's native C++ encoder is not copied here.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch


def tonemap(rgb, exposure: float = 1.0) -> np.ndarray:
    """Simple Reinhard x / (1 + x) tonemap for HDR disk intensities."""
    v = np.asarray(rgb, np.float32) * exposure
    return v / (1.0 + v)


def _png_bytes(arr: np.ndarray) -> bytes:
    """Minimal RGB(A) 8-bit PNG encoder: every row with filter 0, one
    zlib stream."""
    h, w, c = arr.shape
    color = {3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag, data):
        payload = tag + data
        return (struct.pack(">I", len(data)) + payload
                + struct.pack(">I", zlib.crc32(payload) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img, clip: bool = True) -> str:
    """(H, W, 3|4) float [0, 1] or uint8 -> PNG file; a tensor is copied
    to the host first (render_image_u8's frame is a quarter of the float
    frame's bytes).

    Writes atomically (tmp file + rename): a reader never sees a truncated
    file after a crash mid-write.
    """
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.asarray(arr, np.float32)
        if clip:
            arr = np.clip(arr, 0.0, 1.0)
        arr = (arr * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4), got {arr.shape}")
    arr = np.ascontiguousarray(arr)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_png_bytes(arr))
    os.replace(tmp, path)
    return path


def read_image(path: str) -> np.ndarray:
    """Image file -> (H, W, 3) float32 in [0, 1] (the sky-map loader).
    Needs PIL (the ``pillow`` package); without it, raises ImportError."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("read_image needs PIL (the pillow package), "
                          "which is not installed") from e
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
