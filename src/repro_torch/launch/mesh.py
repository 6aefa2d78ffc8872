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

`fake_mesh` turns a `MeshShape` into a PyTorch `DeviceMesh` over a fake
process group of that many ranks, this process being rank 0: the dry
run's sharded trace (`launch.dryrun`) runs the step on DTensors over it,
so PyTorch's own SPMD partitioner issues the collectives that the step
would issue across cards, on meta tensors, with no card and no network.

The session mesh (`make_session_mesh`) is 1-D over the ``"session"`` axis
and holds real cards: fused grant lifecycles stack co-resident sessions
on the leading axis, and `core.batched.train_phases_sharded` runs one
pool slot's group on each card of it."""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 on the tensor cores
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s per direction, NVLink 4 (18 links)
# a node is an HGX H100 board: 8 cards on one NVSwitch fabric, each with
# its own 400 Gb/s NDR InfiniBand port to the other nodes (as a DGX H100);
# a mesh's ranks fill the nodes in order
GPUS_PER_NODE = 8
IB_BW = 50e9  # bytes/s per direction, one 400 Gb/s port
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


@contextlib.contextmanager
def fake_mesh(mesh: MeshShape):
    """A `torch.distributed.device_mesh.DeviceMesh` of ``mesh``'s shape and
    axis names over a ``"fake"`` process group of ``mesh.size`` ranks, as
    rank 0, for the span of the context; the group is destroyed on every
    exit path. The fake backend (PyTorch's
    `torch.testing._internal.distributed.fake_pg`, whose import registers
    it, with its `FakeStore`) moves no data and opens no connection:
    collectives return tensors of their result's shape. The mesh's device
    type is ``"cuda"``, as on the cards, so DTensor issues what it would
    issue over NCCL (on a ``"cpu"`` mesh it swaps each all-to-all for an
    all-gather, gloo having none); the fake backend sets no device, and
    the dry run keeps every local tensor on the meta device, so nothing
    is allocated and no card is touched. Raises when a
    process group is already initialised: the dry run must never count,
    let alone run, its collectives on a real group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the fake mesh "
                           "opens its own and never runs on another")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        yield init_device_mesh("cuda", tuple(mesh.shape),
                               mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()
