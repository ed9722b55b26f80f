"""Image IO: PNG out, images in, and the HDR tonemap."""

from .image import read_image, tonemap, write_png

__all__ = ["read_image", "tonemap", "write_png"]
