"""The differentiable renderer."""
