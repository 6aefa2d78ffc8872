"""Fused cross-session training: B sessions' phases as one stacked lifecycle.

Every AMS session of a task shares one parameter-tree structure (the
student), so B co-resident sessions' training phases need not be B
separate K-iteration loops: stack their ``(params, opt_state, mask,
replay batches)`` along a leading session axis, run the K iterations of a
`torch.func.vmap`-ed loss/grad followed by ONE fused masked-Adam launch
over the whole stack per iteration (momentum SGD, which has no kernel, is
a `vmap` of the plain `momentum_update`), then select the next phase's
masks with one stacked top-k launch and encode the B wire deltas with one
device-to-host pull.

`vmap` keeps each session's maths its own: the student's folded-norm
statistics are taken over one session's batch, never over the stack
(folding B into the convolution batch axis would change them).

A singleton group runs the sequential `AMSSession._run_phase_prepared`
loop, as in the JAX package. The K loop is a Python loop; there is no
executable cache to keep, since PyTorch runs eagerly.
"""
from __future__ import annotations

import functools
from collections import defaultdict
from typing import Hashable

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import selection
from repro_torch.core.delta import encode_delta_stack
from repro_torch.core.masked_adam import momentum_update
from repro_torch.device import host_to_device
from repro_torch.kernels.masked_adam.ops import masked_adam_stacked
from repro_torch.kernels.stacking import dtype_name

# ---------------------------------------------------------------------------
# struct-of-arrays stack / unstack
# ---------------------------------------------------------------------------


def stack_trees(trees: list):
    """Stack B same-structure trees along a new leading session axis."""
    if not trees:
        raise ValueError("stack_trees needs at least one tree")
    return tree.tree_map(lambda *ls: torch.stack(ls), *trees)


def unstack_tree(t, n: int) -> list:
    """Inverse of `stack_trees`: split the leading axis back into B trees
    (views into the stacked leaves)."""
    return [tree.tree_map(lambda l: l[i], t) for i in range(n)]


def tree_struct(t) -> Hashable:
    """Hashable shape/dtype/structure fingerprint of a tree."""
    leaves, treedef = tree.flatten(t)
    return (treedef, tuple((tuple(l.shape), dtype_name(l.dtype)) for l in leaves))


def _mask_struct(s, mask) -> Hashable:
    """Shape fingerprint of the phase's mask tree. A deferred gradient-
    guided mask (None) has param-shaped bool leaves by construction."""
    if mask is not None:
        return tree_struct(mask)
    leaves, treedef = tree.flatten(s.params)
    return (treedef, tuple((tuple(l.shape), "bool") for l in leaves))


def _group_key(s, mask, frames, labels) -> Hashable:
    cfg = s.cfg
    return (s.task.loss_and_grad,
            tree_struct((s.params, s.opt_state)), _mask_struct(s, mask),
            cfg.k_iters, cfg.optimizer, cfg.lr, cfg.b1, cfg.b2, cfg.eps,
            cfg.momentum,
            # the update pipeline batches selection (keyed by γ/strategy)
            # and delta encode (keyed by wire dtype) across the group, so
            # they must agree for sessions to share a fused launch
            cfg.strategy, cfg.gamma, cfg.value_dtype,
            tuple(frames.shape), str(frames.dtype),
            tuple(labels.shape), str(labels.dtype))


# ---------------------------------------------------------------------------
# fused phase over live sessions
# ---------------------------------------------------------------------------


def _stacked_masks(members):
    """The group's stacked mask tree, batching deferred gradient-guided
    selections into one stacked selection.

    ``members`` carry mask=None where selection was deferred; those
    sessions' ``u_prev`` trees stack into a single
    `selection.stacked_gradient_guided_masks` call. Concrete masks
    (first-phase random or injected, Table-3 strategies) stack as they
    are."""
    deferred = [j for j, m in enumerate(members) if m[2] is None]
    if not deferred:
        return stack_trees([m[2] for m in members])
    u_stack = stack_trees([members[j][1].u_prev for j in deferred])
    stacked_d = selection.stacked_gradient_guided_masks(
        u_stack, members[0][1].cfg.gamma)
    if len(deferred) == len(members):
        return stacked_d
    per = {j: tree.tree_map(lambda l, k=k: l[k], stacked_d)
           for k, j in enumerate(deferred)}
    return stack_trees([per.get(j, m[2]) for j, m in enumerate(members)])


def train_phases_fused(sessions: list, t_now: float) -> list:
    """Run one training phase for several sessions as fused launches.

    Per-session host-side work (replay sampling, ASR/ATR bookkeeping)
    happens in session order, consuming each session's RNG exactly as its
    own ``train_phase`` would. Sessions that share a grouping key — same
    loss callable, shapes, K, optimizer and selection/wire recipe — are
    stacked and trained together; a session with nothing to train yields
    None in its slot, like ``train_phase``. Singleton groups take the
    sequential step path."""
    results: dict[int, object] = {}
    groups: dict[Hashable, list] = defaultdict(list)
    for i, s in enumerate(sessions):
        prep = s._prepare_phase_deferred(t_now)
        if prep is None:
            results[i] = None
            continue
        mask, frames, labels = prep  # mask None = deferred gradient-guided
        groups[_group_key(s, mask, frames, labels)].append(
            (i, s, mask, frames, labels))

    for members in groups.values():
        if len(members) == 1:
            i, s, mask, frames, labels = members[0]
            if mask is None:
                mask = selection.gradient_guided_mask(s.u_prev, s.cfg.gamma)
            results[i] = s._run_phase_prepared(t_now, mask, frames, labels)
            continue
        _commit_stacked(members, t_now, _launch_stacked(members), results)
    return [results[i] for i in range(len(sessions))]


def _launch_stacked(members):
    """Stack one group and run its K fused train iterations.

    Returns ``(params, opt, u, losses, mask)``, all stacked along the
    session axis and still on the device."""
    ss = [m[1] for m in members]
    s0 = ss[0]
    cfg = s0.cfg
    params = stack_trees([s.params for s in ss])
    opt = stack_trees([s.opt_state for s in ss])
    mask = _stacked_masks(members)
    # batches: per-session (K, batch, ...) -> (K, B, batch, ...)
    frames = host_to_device(np.stack([m[3] for m in members], axis=1), s0.device)
    labels = host_to_device(np.stack([m[4] for m in members], axis=1), s0.device)
    vgrad = torch.func.vmap(s0.task.loss_and_grad)
    if cfg.optimizer == "adam":
        step = functools.partial(masked_adam_stacked, lr=cfg.lr, b1=cfg.b1,
                                 b2=cfg.b2, eps=cfg.eps)
    else:
        step = torch.func.vmap(functools.partial(
            momentum_update, lr=cfg.lr, momentum=cfg.momentum))
    u = losses = None
    for k in range(cfg.k_iters):
        losses, grads = vgrad(params, frames[k], labels[k])
        params, opt, u = step(params, grads, opt, mask)
    return params, opt, u, losses, mask


def _commit_stacked(members, t_now, out, results) -> None:
    """Encode the group's wire deltas (one batched device-to-host pull) and
    commit per-member state."""
    params, opt, u, losses, mask = out
    losses = losses.detach().cpu().numpy()
    b = len(members)
    deltas = encode_delta_stack(params, mask, b, members[0][1].cfg.value_dtype)
    for j, (i, s, _, _, _), p_j, o_j, u_j in zip(
            range(b), members, unstack_tree(params, b),
            unstack_tree(opt, b), unstack_tree(u, b)):
        results[i] = s._commit_phase(t_now, p_j, o_j, u_j,
                                     float(losses[j]), None,
                                     delta=deltas[j])
