"""The step functions that the launchers drive (the JAX package's
`launch/steps.py`): one masked-Adam training step of online distillation
(`make_train_step`), prefill of a prompt batch, and one greedy decode step
against the KV cache."""
from __future__ import annotations

import contextlib

import torch

from repro_torch import tree
from repro_torch.core.masked_adam import FlatMaskedAdam
from repro_torch.models.registry import Model


def clip_grads_(grads, clip: float) -> torch.Tensor:
    """The JAX trainer's global grad-norm clip and non-finite guard, in
    place on a gradient tree: the norm in float32, each leaf's sum of
    squares added in leaf order; every leaf scaled by ``min(1, clip /
    max(norm, 1e-9))`` in float32 and set to 0 where it, or the norm, is
    not finite (a ``where``, not a multiply: 0 * nan is nan). Returns the
    norm."""
    leaves = tree.leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))
    scale = torch.clamp(clip / torch.clamp(gn, min=1e-9), max=1.0)
    ok = torch.isfinite(gn)
    with torch.no_grad():
        for g in leaves:
            g.copy_(torch.where(ok & torch.isfinite(g), g.to(torch.float32) * scale,
                                0.0).to(g.dtype))
    return gn


def make_train_step(model: Model, lr: float = 1e-3, clip: float = 0.0, clock=None):
    """One inner iteration of Algorithm 2 on the model's distillation
    loss: ``train_step(state, batch) -> (u, loss)``, where ``state`` is a
    `FlatMaskedAdam` holding the params (its ``params`` tree), the phase's
    mask and the Adam state, all updated in place (the JAX package's step
    returns new trees; a 2.5B-parameter model's state has no room for a
    second copy). ``u`` is the tree of the step's updates (views into the
    state), ``loss`` the step's loss, detached. With ``clip``, the
    gradients are clipped as `clip_grads_` does (the JAX trainer's own
    step; its `make_train_step` has no clip). ``clock(stage)``, where
    given, returns a context manager around each stage:
    ``forward_backward``, ``clip`` and ``adam``."""
    stage = clock or (lambda name: contextlib.nullcontext())

    def train_step(state: FlatMaskedAdam, batch):
        with stage("forward_backward"):
            state.zero_grad()
            loss, _ = model.loss(state.params, batch)
            loss.backward()
        if clip:
            with stage("clip"):
                clip_grads_(state.grads, clip)
        with stage("adam"):
            state.step(lr=lr)
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
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, caches, logits

    return serve_step
