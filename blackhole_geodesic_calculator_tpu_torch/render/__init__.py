"""The differentiable renderer: rays -> geodesics -> events -> shading ->
image, its multisampled, uint8 and progressive outputs, and its stats and
debug dumps."""

from .debug import debug_rays, format_debug_string
from .renderer import (
    RenderConfig,
    render_image,
    render_image_u8,
    render_progressive,
    render_sample,
    sample_draws,
    scene_env,
)
from .stats import render_stats, settings_dump

__all__ = [
    "RenderConfig",
    "debug_rays",
    "format_debug_string",
    "render_image",
    "render_image_u8",
    "render_progressive",
    "render_sample",
    "render_stats",
    "sample_draws",
    "scene_env",
    "settings_dump",
]
