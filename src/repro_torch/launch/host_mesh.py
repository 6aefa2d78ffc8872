"""The host's CUDA cards as a session mesh (the JAX package's
`launch/host_mesh.py`).

`serving.resources.GPUPool(device_backend="torch")` binds pool slots to
cards and `core.batched.train_phases_sharded` runs one slot's group on
each. `host_devices` lists the cards and refuses to pretend: a path that
asks for more cards than the host has raises, so a run on fewer cards
cannot pass for a parallel one. `make_host_mesh` is
`launch.mesh.make_session_mesh`.

The JAX package splits one CPU host into N XLA devices through
``XLA_FLAGS`` (`host_device_count_flag`, `forced_host_device_count`,
`ensure_host_devices`) and builds ``NamedSharding``s for its one-launch
``shard_map`` path (`session_sharding`, `replicated_sharding`). PyTorch
has neither, so they have no counterpart here. Nothing here touches a
card when the module is imported.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import SessionMesh, make_session_mesh


def host_devices(n: int | None = None) -> list:
    """The live CUDA cards as ``torch.device("cuda", i)``, the first ``n``
    of them when ``n`` is given; raises when fewer than ``n`` exist."""
    live = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devs = [torch.device("cuda", i) for i in range(live)]
    if n is None:
        return devs
    if live < n:
        raise RuntimeError(
            f"asked for {n} CUDA cards but only {live} exist; this path "
            f"needs {n} cards")
    return devs[:n]


def make_host_mesh(n: int | None = None) -> SessionMesh:
    """A 1-D mesh over the ``session`` axis on ``n`` cards
    (`launch.mesh.make_session_mesh`)."""
    return make_session_mesh(n)
