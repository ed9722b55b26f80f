"""Spacetime models: the Kerr-Schild forms of the Kerr metric."""
