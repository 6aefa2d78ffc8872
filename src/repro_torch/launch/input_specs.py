"""Meta-tensor stand-ins for every model input (the JAX package's
`launch/input_specs.py`): the dry run's inputs, shapes and dtypes on
``torch.device("meta")``, no storage.

Tokens and labels are int32, as the trainer's token stream gives them
and as the decode step feeds its own tokens back; the decode position is
a Python int, as `launch.steps.make_serve_step` takes it. A partition
spec is a tuple (`models.common.meta_pspec`).
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ModelConfig

INPUT_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode_long", seq_len=524288, global_batch=1),
}

META = torch.device("meta")


def train_inputs(cfg: ModelConfig, batch: int, seq: int, mem_len: int | None = None):
    """tokens and labels (batch, seq) int32, and for a model with
    cross-attention its memory (batch, mem_len, d_model) in the compute
    dtype (``mem_len`` defaults to ``cfg.num_xattn_tokens``)."""
    specs = {
        "tokens": torch.empty((batch, seq), dtype=torch.int32, device=META),
        "labels": torch.empty((batch, seq), dtype=torch.int32, device=META),
    }
    if cfg.num_xattn_tokens:
        specs["memory"] = torch.empty(
            (batch, mem_len or cfg.num_xattn_tokens, cfg.d_model), dtype=cfg.cdtype,
            device=META)
    return specs


def train_input_pspecs(cfg: ModelConfig, rules) -> dict:
    b = rules.get("batch")
    out = {"tokens": (b, None), "labels": (b, None)}
    if cfg.num_xattn_tokens:
        out["memory"] = (b, None, None)
    return out


def decode_inputs(cfg: ModelConfig, batch: int, pos: int):
    """One token per row (batch, 1) int32 at position ``pos``."""
    return {"tokens": torch.empty((batch, 1), dtype=torch.int32, device=META), "pos": pos}


def decode_input_pspecs(cfg: ModelConfig, rules) -> dict:
    return {"tokens": (rules.get("batch"), None), "pos": ()}
