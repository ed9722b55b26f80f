"""The differentiable renderer: rays -> geodesics -> events -> shading ->
image, its multisampled, uint8 and progressive outputs, its stats and
debug dumps, the polarized (Stokes) render and the polarization map, and
the Gen-1 hybrid renderer."""

from .debug import debug_rays, format_debug_string
from .limited import LimitedConfig, SurrogateTable, render_limited
from .renderer import (
    RenderConfig,
    polarization_map,
    polarization_rays,
    render_image,
    render_image_u8,
    render_progressive,
    render_sample,
    render_stokes,
    sample_draws,
    scene_env,
    stokes_rays,
)
from .stats import render_stats, settings_dump

__all__ = [
    "LimitedConfig",
    "RenderConfig",
    "SurrogateTable",
    "debug_rays",
    "format_debug_string",
    "polarization_map",
    "polarization_rays",
    "render_image",
    "render_image_u8",
    "render_limited",
    "render_progressive",
    "render_sample",
    "render_stats",
    "render_stokes",
    "sample_draws",
    "scene_env",
    "settings_dump",
    "stokes_rays",
]
