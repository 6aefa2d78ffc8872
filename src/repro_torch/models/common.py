"""Parameter metadata for the port's models: the part of the JAX package's
`models/common.py` that the segmentation student needs.

A ``ParamMeta`` tree describes every leaf's shape and initialiser (the
JAX package's logical sharding axes are left out: nothing here shards);
``init_params`` draws real weights from a `torch.Generator`. The draws
cannot match ``jax.random`` bit for bit, so tests that compare the two
packages carry the JAX package's weights over instead
(`repro_torch.models.seg.student.params_from_numpy`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch import tree


@dataclass(frozen=True)
class ParamMeta:
    shape: tuple
    init: str = "fan_in"  # fan_in|zeros (what the student uses)


def _leaf_init(meta: ParamMeta, gen: torch.Generator, dtype, device):
    if meta.init == "zeros":
        return torch.zeros(meta.shape, dtype=dtype, device=device)
    if meta.init != "fan_in":
        raise ValueError(f"unknown init {meta.init}")
    # fan-in is the second-to-last axis by convention (matmul lhs dim); for
    # 1-D params fall back to the only axis. Drawn on the CPU generator, so
    # a seed gives the same weights on every device.
    fan_in = meta.shape[-2] if len(meta.shape) >= 2 else meta.shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(meta.shape, generator=gen, dtype=torch.float32)
    return (scale * x).to(device=device, dtype=dtype)


def init_params(metas, gen: torch.Generator, dtype, device) -> dict:
    """Materialize real parameters from a ParamMeta tree, leaves drawn in
    flatten order from ``gen`` (a CPU generator)."""
    return tree.tree_map(lambda m: _leaf_init(m, gen, dtype, device), metas)


def param_count(metas) -> int:
    return sum(math.prod(m.shape) for m in tree.leaves(metas))
