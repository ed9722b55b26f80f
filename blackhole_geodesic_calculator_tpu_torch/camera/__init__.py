"""Pinhole camera."""

from .pinhole import Camera, euler_matrix, generate_rays, pixel_grid

__all__ = ["Camera", "euler_matrix", "generate_rays", "pixel_grid"]
