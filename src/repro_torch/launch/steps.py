"""The step functions that the launchers drive (the JAX package's
`launch/steps.py`): one masked-Adam training step of online distillation
(`make_train_step`), prefill of a prompt batch, and one greedy decode step
against the KV cache."""
from __future__ import annotations

import contextlib

import torch

from repro_torch import spmd
from repro_torch.core.masked_adam import FlatMaskedAdam
from repro_torch.models.registry import Model


def make_train_step(model: Model, lr: float = 1e-3, clip: float = 0.0, clock=None):
    """One inner iteration of Algorithm 2 on the model's distillation
    loss: ``train_step(state, batch) -> (u, loss)``, where ``state`` is a
    `FlatMaskedAdam` holding the params (its ``params`` tree), the phase's
    mask and the Adam state, all updated in place (the JAX package's step
    returns new trees; a 2.5B-parameter model's state has no room for a
    second copy). ``u`` is the tree of the step's updates (views into the
    state), ``loss`` the step's loss, detached. With ``clip``, the
    gradients are clipped to that global norm with a non-finite guard, as
    the JAX trainer's own step does (its `make_train_step` has no clip):
    the ``clip`` stage takes the norm (`FlatMaskedAdam.grad_norm`) and the
    ``adam`` stage clips inside the masked-Adam kernel
    (`FlatMaskedAdam.step`). ``clock(stage)``, where given, returns a
    context manager around each stage: ``forward_backward``, ``clip`` and
    ``adam``."""
    stage = clock or (lambda name: contextlib.nullcontext())

    def train_step(state: FlatMaskedAdam, batch):
        with stage("forward_backward"):
            state.zero_grad()
            loss, _ = model.loss(state.params, batch)
            loss.backward()
        gn = None
        if clip:
            with stage("clip"):
                gn = state.grad_norm()
        with stage("adam"):
            state.step(lr=lr, clip=clip, gn=gn)
        return state.u_tree, loss.detach()

    return train_step


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
        # a vocabulary sharded over cards is gathered first (`spmd.whole`)
        next_tok = torch.argmax(spmd.whole(logits, -1), dim=-1).to(torch.int32)
        return next_tok, caches, logits

    return serve_step
