"""The step functions that the serving launcher drives (the JAX package's
`launch/steps.py`): prefill of a prompt batch, and one greedy decode step
against the KV cache. ``make_train_step`` waits for the training slice
(ROADMAP §1 item 7)."""
from __future__ import annotations

import torch

from repro_torch.models.registry import Model


def make_prefill_step(model: Model, cache_len: int):
    def prefill_step(params, batch):
        return model.prefill(params, batch["tokens"], cache_len, batch.get("memory"))

    return prefill_step


def make_serve_step(model: Model):
    """One greedy decode step. Returns ``(next_tok, caches, logits)``: the
    JAX package's pair plus the step's logits, so that a caller can check
    them without another step; the caches are written in place."""

    def serve_step(params, caches, batch):
        logits, caches = model.decode_step(params, caches, batch["tokens"], batch["pos"])
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, caches, logits

    return serve_step
