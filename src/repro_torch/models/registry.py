"""Model facade: bundles a config with its parameter machinery and step
functions (the JAX package's `models/registry.py`).

The parameter tree keeps the JAX package's layout and key names (``wq``
is (d, KV, G, hd), blocks are stacked under ``groups/b{i}``), so
`params_from_numpy` (re-exported here) carries the JAX package's weights
over leaf by leaf.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (  # noqa: F401  (params_from_numpy)
    ModelConfig,
    abstract_params,
    init_params,
    param_count,
    params_from_numpy,
    partition_specs,
)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # --- params ---
    def metas(self) -> dict:
        return tfm.model_metas(self.cfg)

    def init(self, gen: torch.Generator, device="cuda"):
        """Random weights in the config's param dtype, drawn from ``gen``
        (a `torch.Generator` on the CPU, or on the card for a full-size
        model) and placed on ``device``."""
        return init_params(self.metas(), gen, self.cfg.pdtype, resolve_device(device))

    def abstract(self):
        """The params as meta tensors in the param dtype (the dry run)."""
        return abstract_params(self.metas(), self.cfg.pdtype)

    def pspecs(self, rules: dict):
        """Each leaf's partition spec under ``rules`` (a tuple of mesh axis
        names, tuples of them, or None, one entry a dimension)."""
        return partition_specs(self.metas(), rules)

    def num_params(self) -> int:
        return param_count(self.metas())

    # --- steps ---
    def forward(self, params, tokens, memory=None):
        """(logits, aux): the MoE load-balance loss beside the logits, as in
        the JAX package. ``memory`` (B, Sm, d) feeds cross-attention."""
        return tfm.forward(self.cfg, params, tokens, memory)

    def loss(self, params, batch):
        """(loss, {"ce", "aux"}): `transformer.distill_loss`, the trainer's
        loss, differentiable through the kernels' backward on the card."""
        return tfm.distill_loss(self.cfg, params, batch)

    def prefill(self, params, tokens, cache_len, memory=None):
        return tfm.prefill(self.cfg, params, tokens, cache_len, memory)

    def decode_step(self, params, caches, tokens, pos):
        return tfm.decode_step(self.cfg, params, caches, tokens, pos)

    # --- caches ---
    def cache_metas(self, batch, seq, mem_len=0):
        return tfm.cache_metas(self.cfg, batch, seq, mem_len)

    def init_cache(self, batch, seq, mem_len=0, dtype=None, device="cuda"):
        return tfm.init_cache(self.cfg, batch, seq, mem_len, dtype, resolve_device(device))

    def abstract_cache(self, batch, seq, mem_len=0, dtype=None):
        """The decode cache as meta tensors, each leaf in `cache_dtype`."""
        dtype = dtype or self.cfg.cdtype
        meta = torch.device("meta")
        return {b: {key: torch.empty(m.shape, dtype=tfm.cache_dtype(key, dtype), device=meta)
                    for key, m in c.items()}
                for b, c in self.cache_metas(batch, seq, mem_len).items()}

    def cache_pspecs(self, batch, seq, rules, mem_len=0):
        return partition_specs(self.cache_metas(batch, seq, mem_len), rules)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
