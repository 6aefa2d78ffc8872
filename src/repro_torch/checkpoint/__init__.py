"""npz checkpoints of tensor trees, in the JAX package's layout
(`repro/checkpoint`): one array per leaf under its ``/``-joined path of
dict keys and sequence indices, bfloat16 stored as float32. A file that
either package writes loads in the other.

`load` restores each leaf's dtype and device from ``like``, a tree of
tensors of the same structure (a NamedTuple restores as its own type).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.tree import _is_namedtuple


def _flatten_paths(tree) -> dict:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(f"{prefix}/{i}", v)
        else:
            t = torch.as_tensor(node).detach()
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32)  # bf16 -> fp32 on disk
            flat[prefix] = t.cpu().numpy()

    rec("", tree)
    return flat


def save(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten_paths(tree))


def load(path: str, like):
    """Restore into the structure of ``like``: each leaf in its dtype, on
    its device."""
    with np.load(path) as data:
        flat = dict(data)

    def rec(prefix, node):
        if isinstance(node, dict):
            return {k: rec(f"{prefix}/{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [rec(f"{prefix}/{i}", v) for i, v in enumerate(node)]
            return type(node)(*vals) if _is_namedtuple(node) else type(node)(vals)
        return torch.from_numpy(np.asarray(flat[prefix])).to(device=node.device,
                                                              dtype=node.dtype)

    return rec("", like)


def exists(path: str) -> bool:
    return os.path.exists(path)
