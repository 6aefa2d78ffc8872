"""Hardware constants for the roofline analysis (the JAX package's
`launch/mesh.py`, its constants only), per card: an NVIDIA H100 SXM 80GB
from NVIDIA's data sheet, dense rates without sparsity, at the card's
full 700 W.

The JAX package's mesh builders (`make_production_mesh`,
`make_local_mesh`, `make_session_mesh`) wait for sharded execution on
more than one card (ROADMAP §1 item 5)."""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 on the tensor cores
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s per direction, NVLink 4 (18 links)
