"""RMSNorm kernel: `ops` (wrapper) and `ref` (plain version)."""
