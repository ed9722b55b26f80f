"""Scene data, texture sampling and shading."""
