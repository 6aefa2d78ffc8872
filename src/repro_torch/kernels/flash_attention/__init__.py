"""Flash-attention kernel: `ops` (wrapper) and `ref` (plain version)."""
