"""Pinhole camera."""
