"""Gradient-norm kernel: `ops` (wrapper) and `ref` (plain version)."""
