"""RWKV-6 wkv kernel: `ops` (wrapper) and `ref` (plain version)."""
