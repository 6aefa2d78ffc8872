"""Bit-pattern top-k kernel: `ops` (wrapper) and `ref` (plain version)."""
