"""Mesh descriptions and hardware constants (the JAX package's
`launch/mesh.py`).

The constants are per card: an NVIDIA H100 SXM 80GB from NVIDIA's data
sheet, dense rates without sparsity, at the card's full 700 W.

`make_production_mesh` and `make_local_mesh` describe the JAX package's
meshes without touching a device: a `MeshShape` holds the axis names and
sizes, which is all that the sharding rules (`launch.shardings`) and the
dry run (`launch.dryrun`) read. The production meshes, (16, 16) over
("data", "model") and (2, 16, 16) over ("pod", "data", "model"), are read
as 256 and 512 H100s; the local mesh is one card. The session mesh that
shards fused serving across cards (`make_session_mesh`) waits for sharded
execution on more than one card (ROADMAP §1 item 5)."""
from __future__ import annotations

import math
from typing import NamedTuple

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 on the tensor cores
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s per direction, NVLink 4 (18 links)
# device memory of one card: the total that an H100 SXM 80GB reports to
# torch.cuda.get_device_properties (chip_smoke.py prints it)
HBM_BYTES = 85_017_493_504


class MeshShape(NamedTuple):
    """A device-free mesh: axis names and their sizes."""

    axis_names: tuple
    shape: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_local_mesh() -> MeshShape:
    """One card, with the production meshes' axis names (degenerate
    axes)."""
    return MeshShape(("data", "model"), (1, 1))
