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
    init_params,
    param_count,
    params_from_numpy,
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

    def num_params(self) -> int:
        return param_count(self.metas())

    # --- steps ---
    def forward(self, params, tokens, memory=None):
        """(logits, aux): the MoE load-balance loss beside the logits, as in
        the JAX package. ``memory`` (B, Sm, d) feeds cross-attention."""
        return tfm.forward(self.cfg, params, tokens, memory)

    def prefill(self, params, tokens, cache_len, memory=None):
        return tfm.prefill(self.cfg, params, tokens, cache_len, memory)

    def decode_step(self, params, caches, tokens, pos):
        return tfm.decode_step(self.cfg, params, caches, tokens, pos)

    # --- caches ---
    def cache_metas(self, batch, seq, mem_len=0):
        return tfm.cache_metas(self.cfg, batch, seq, mem_len)

    def init_cache(self, batch, seq, mem_len=0, dtype=None, device="cuda"):
        return tfm.init_cache(self.cfg, batch, seq, mem_len, dtype, resolve_device(device))


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
