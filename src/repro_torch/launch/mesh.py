"""Mesh descriptions and hardware constants (the JAX package's
`launch/mesh.py`).

The constants are per card: an NVIDIA H100 SXM 80GB from NVIDIA's data
sheet, dense rates without sparsity, at the card's full 700 W.

`make_production_mesh` and `make_local_mesh` describe the JAX package's
meshes without touching a device: a `MeshShape` holds the axis names and
sizes, which is all that the sharding rules (`launch.shardings`) and the
dry run (`launch.dryrun`) read. The production meshes, (16, 16) over
("data", "model") and (2, 16, 16) over ("pod", "data", "model"), are read
as 256 and 512 H100s; the local mesh is one card.

The session mesh (`make_session_mesh`) is 1-D over the ``"session"`` axis
and holds real cards: fused grant lifecycles stack co-resident sessions
on the leading axis, and `core.batched.train_phases_sharded` runs one
pool slot's group on each card of it."""
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


class SessionMesh(NamedTuple):
    """A 1-D mesh over the ``"session"`` axis: the CUDA cards it spans,
    in order."""

    devices: tuple
    axis_names: tuple = ("session",)

    @property
    def shape(self) -> tuple:
        return (len(self.devices),)

    @property
    def size(self) -> int:
        return len(self.devices)


def make_session_mesh(n: int | None = None) -> SessionMesh:
    """The session mesh over the host's first ``n`` CUDA cards (all of
    them by default). Raises without CUDA, and for ``n < 1`` or more cards
    than the host has."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the session mesh spans CUDA cards, but CUDA is "
                           "not available")
    live = torch.cuda.device_count()
    if n is None:
        n = live
    if n < 1 or n > live:
        raise ValueError(f"session mesh wants {n} devices, have {live}")
    return SessionMesh(tuple(torch.device("cuda", i) for i in range(n)))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_local_mesh() -> MeshShape:
    """One card, with the production meshes' axis names (degenerate
    axes)."""
    return MeshShape(("data", "model"), (1, 1))
