"""The forward renderer."""
