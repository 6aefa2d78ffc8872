"""Fused masked-Adam kernel: `ops` (wrapper) and `ref` (plain version)."""
