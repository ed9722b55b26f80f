"""Scene description, textures, samplers and shading."""

from .scene import Scene, BlackHole, Disk, Spheres, Lights
from .texture import sample_bpy, sample_equirect, sphere_uv_bpy
from .shading import (
    shade, shade_background, shade_disk, shade_sphere, disk_redshift,
)
from .textures import TEXTURES, load_texture, load_all

__all__ = [
    "Scene", "BlackHole", "Disk", "Spheres", "Lights",
    "sample_bpy", "sample_equirect", "sphere_uv_bpy",
    "shade", "shade_background", "shade_disk", "shade_sphere",
    "disk_redshift",
    "TEXTURES", "load_texture", "load_all",
]
