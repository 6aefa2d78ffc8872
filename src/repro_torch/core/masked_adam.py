"""Algorithm 2 — gradient-guided coordinate descent for the Adam optimizer.

The coordinate subset I_n is fixed BEFORE the K iterations of phase n
(chosen from the largest |Adam update| of phase n-1), and Adam's moments
track the actually visited trajectory. Every iteration:
    m <- b1 m + (1-b1) g          (ALL coordinates)
    v <- b2 v + (1-b2) g^2        (ALL coordinates)
    u <- lr * sqrt(1-b2^i)/(1-b1^i) * m / sqrt(v + eps)   (paper line 12)
    w <- w - u * mask             (only I_n moves)
The returned `u` of the last iteration feeds the next phase's selection.

Trees on the card always take the fused kernel
(`repro_torch.kernels.masked_adam`), a single session as a stack of one;
trees on the CPU take the per-leaf float32 expression, which is the
kernel's plain version.

`momentum_update` (the Just-In-Time baseline's momentum SGD) is plain
PyTorch on either device: the JAX package has no kernel for it.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.kernels.masked_adam.ops import (bias_correction,
                                                 masked_adam_stacked)
from repro_torch.kernels.masked_adam.ref import masked_adam_ref


class MaskedAdamState(NamedTuple):
    m: Any  # first-moment tree (like params)
    v: Any  # second-moment tree
    count: torch.Tensor  # global step i (scalar int32)


def init_state(params, m_dtype=None, v_dtype=torch.float32) -> MaskedAdamState:
    m = tree.tree_map(lambda p: torch.zeros_like(p, dtype=m_dtype or p.dtype), params)
    v = tree.tree_map(lambda p: torch.zeros_like(p, dtype=v_dtype), params)
    device = tree.leaves(params)[0].device
    return MaskedAdamState(m=m, v=v,
                           count=torch.zeros((), dtype=torch.int32, device=device))


def _stack_of_one(t):
    return tree.tree_map(lambda l: l.unsqueeze(0), t)


def _first(t):
    return tree.tree_map(lambda l: l[0], t)


def masked_adam_update(params, grads, state: MaskedAdamState, mask, *,
                       lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                       eps: float = 1e-8):
    """One inner iteration (paper lines 7-13). Returns (params', state', u)."""
    if tree.leaves(params)[0].device.type != "cpu":
        st = MaskedAdamState(_stack_of_one(state.m), _stack_of_one(state.v),
                             state.count.reshape(1))
        p, st, u = masked_adam_stacked(
            _stack_of_one(params), _stack_of_one(grads), st,
            _stack_of_one(mask), lr=lr, b1=b1, b2=b2, eps=eps)
        return (_first(p), MaskedAdamState(_first(st.m), _first(st.v),
                                           st.count[0]), _first(u))
    i, bc = bias_correction(state.count, lr=lr, b1=b1, b2=b2)
    ls, treedef = tree.flatten(params)
    quads = [masked_adam_ref(p, g, m, v, b, bc.reshape(1), b1=b1, b2=b2,
                             eps=eps)
             for p, g, m, v, b in zip(ls, tree.leaves(grads),
                                      tree.leaves(state.m),
                                      tree.leaves(state.v),
                                      tree.leaves(mask))]
    p, m, v, u = (tree.unflatten(treedef, [q[j] for q in quads])
                  for j in range(4))
    return p, MaskedAdamState(m, v, i), u


def adam_update(params, grads, state, **kw):
    """Unmasked Adam (mask of ones) — used by baselines and pretraining."""
    ones = tree.tree_map(lambda p: torch.ones_like(p, dtype=torch.bool), params)
    return masked_adam_update(params, grads, state, ones, **kw)


class MomentumState(NamedTuple):
    velocity: Any


def init_momentum(params) -> MomentumState:
    return MomentumState(tree.tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def momentum_update(params, grads, state: MomentumState, mask=None, *,
                    lr=1e-3, momentum=0.9):
    """Momentum SGD (the Just-In-Time baseline's optimizer, §4.1), with
    optional coordinate mask (JIT also uses gradient-guided selection).
    Returns (params', state', u)."""
    if mask is None:
        mask = tree.tree_map(lambda p: torch.ones((), dtype=p.dtype,
                                                  device=p.device), params)

    def upd(p, g, vel, b):
        vel_new = momentum * vel + g.to(torch.float32)
        u = lr * vel_new
        p_new = (p.to(torch.float32) - u * b.to(torch.float32)).to(p.dtype)
        return p_new, vel_new, u

    ls, treedef = tree.flatten(params)
    triples = [upd(*xs) for xs in zip(ls, tree.leaves(grads),
                                      tree.leaves(state.velocity),
                                      tree.leaves(mask))]
    p, vel, u = (tree.unflatten(treedef, [t[j] for t in triples])
                 for j in range(3))
    return p, MomentumState(vel), u
