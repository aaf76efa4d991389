"""Frozen copies; see the package docstring."""
