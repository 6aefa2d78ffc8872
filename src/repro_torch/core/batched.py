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
loop, as in the JAX package. The K loop is a Python loop; PyTorch runs
eagerly, so there is no executable cache to keep.

Observability: `update_pipeline_info` counts the stacked selections and
batched encodes and the sessions they covered, and the K iterations of a
stacked group are timed as stage ``train_fused`` (`core.timing`), the
first call with a given ``(B, K)`` in the process in the first-call
bucket (cuDNN picks its algorithms and the CUDA sources build there).
"""
from __future__ import annotations

import functools
import time
from collections import defaultdict
from typing import Hashable

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import selection, timing
from repro_torch.core.delta import encode_delta_stack
from repro_torch.core.masked_adam import momentum_update
from repro_torch.device import host_to_device
from repro_torch.kernels.masked_adam.ops import masked_adam_stacked

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


def _mask_struct(s, mask) -> Hashable:
    """Shape fingerprint of the phase's mask tree. A deferred gradient-
    guided mask (None) has param-shaped bool leaves by construction."""
    if mask is not None:
        return tree.struct(mask)
    leaves, treedef = tree.flatten(s.params)
    return (treedef, tuple((tuple(l.shape), str(torch.bool)) for l in leaves))


def _group_key(s, mask, frames, labels) -> Hashable:
    cfg = s.cfg
    return (s.task.loss_and_grad,
            tree.struct((s.params, s.opt_state)), _mask_struct(s, mask),
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

# update-pipeline telemetry: how much of the post-train select/encode work
# ran stacked (one launch / one transfer pair per fused group) instead of
# per-session. The serving engine snapshots this around a run.
_UPDATE_STATS = {"stacked_select_launches": 0, "stacked_select_sessions": 0,
                 "stacked_encode_launches": 0, "stacked_encode_sessions": 0}

# (B, K) keys a stacked group has trained at in this process: the first
# call per key lands in the timing's first-call bucket
_TRAIN_SEEN: set = set()


def update_pipeline_info() -> dict:
    """Counters for the fused post-train update pipeline (stacked selection
    launches + batched delta encodes and the sessions they covered)."""
    return dict(_UPDATE_STATS)


def update_pipeline_reset() -> None:
    for k in _UPDATE_STATS:
        _UPDATE_STATS[k] = 0


def _to(t, device):
    return tree.tree_map(lambda l: l.to(device), t)


def _stacked_masks(members, device=None):
    """The group's stacked mask tree, batching deferred gradient-guided
    selections into one stacked selection.

    ``members`` carry mask=None where selection was deferred; those
    sessions' ``u_prev`` trees stack into a single
    `selection.stacked_gradient_guided_masks` call (one top-k launch for
    all of them, even for one deferred session in a group). Concrete masks
    (first-phase random or injected, Table-3 strategies) stack as they
    are. ``device`` places the selection and the stacked mask on that
    device; None places nothing."""
    def place(t):
        return t if device is None else _to(t, device)

    deferred = [j for j, m in enumerate(members) if m[2] is None]
    masks = {j: m[2] for j, m in enumerate(members) if m[2] is not None}
    if deferred:
        u_stack = place(stack_trees([members[j][1].u_prev for j in deferred]))
        stacked_d = selection.stacked_gradient_guided_masks(
            u_stack, members[0][1].cfg.gamma)
        _UPDATE_STATS["stacked_select_launches"] += 1
        _UPDATE_STATS["stacked_select_sessions"] += len(deferred)
        if not masks:
            return stacked_d
        masks.update({j: tree.tree_map(lambda l, k=k: l[k], stacked_d)
                      for k, j in enumerate(deferred)})
    return stack_trees([place(masks[j]) for j in range(len(members))])


def train_phases_fused(sessions: list, t_now: float,
                       force_stack: bool = False, device=None) -> list:
    """Run one training phase for several sessions as fused launches.

    Per-session host-side work (replay sampling, ASR/ATR bookkeeping)
    happens in session order, consuming each session's RNG exactly as its
    own ``train_phase`` would. Sessions that share a grouping key — same
    loss callable, shapes, K, optimizer and selection/wire recipe — are
    stacked and trained together as one `vmap` lifecycle (K iterations of
    a vmapped loss/grad, each followed by one fused masked-Adam launch; one
    stacked top-k launch for the group's gradient-guided selections; one
    batched encode); a session with nothing to train yields None in its
    slot, like ``train_phase``.

    Singleton groups take the sequential step path (bitwise-identical to
    ``train_phase``); ``force_stack=True`` pushes even B = 1 through the
    stacked path (tests and benchmarks).

    ``device`` (a ``torch.device``: the granted pool slot's card under
    ``GPUPool(device_backend="torch")``) places each stacked group's
    lifecycle on that device — the stacked state, masks, batches and the
    K iterations — and commits each session's new state back to the
    session's own device. The sequential singleton path ignores it. None,
    the default, places nothing: a group runs on its sessions' device."""
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
        if len(members) == 1 and not force_stack:
            i, s, mask, frames, labels = members[0]
            if mask is None:
                mask = selection.gradient_guided_mask(s.u_prev, s.cfg.gamma)
            results[i] = s._run_phase_prepared(t_now, mask, frames, labels)
            continue
        _commit_stacked(members, t_now, _launch_stacked(members, device),
                        results)
    return [results[i] for i in range(len(sessions))]


def _launch_stacked(members, device=None):
    """Stack one group and run its K fused train iterations.

    Returns ``(params, opt, u, losses, mask)``, all stacked along the
    session axis and still on the device. With timing on, the K iterations
    alone (after the stacking and the host-to-device copy) are recorded as
    stage ``train_fused`` under key ``(B, K)``."""
    ss = [m[1] for m in members]
    s0 = ss[0]
    cfg = s0.cfg
    dev = s0.device if device is None else device
    params = stack_trees([s.params for s in ss])
    opt = stack_trees([s.opt_state for s in ss])
    if device is not None:
        params, opt = _to(params, device), _to(opt, device)
    mask = _stacked_masks(members, device)
    # batches: per-session (K, batch, ...) -> (K, B, batch, ...)
    frames = host_to_device(np.stack([m[3] for m in members], axis=1), dev)
    labels = host_to_device(np.stack([m[4] for m in members], axis=1), dev)
    vgrad = torch.func.vmap(s0.task.loss_and_grad)
    if cfg.optimizer == "adam":
        step = functools.partial(masked_adam_stacked, lr=cfg.lr, b1=cfg.b1,
                                 b2=cfg.b2, eps=cfg.eps)
    else:
        step = torch.func.vmap(functools.partial(
            momentum_update, lr=cfg.lr, momentum=cfg.momentum))
    record = timing.enabled()
    if record:
        key = (len(members), cfg.k_iters)
        first = key not in _TRAIN_SEEN
        _TRAIN_SEEN.add(key)
        timing.block((params, opt, mask, frames, labels))
        t0 = time.perf_counter()
    u = losses = None
    for k in range(cfg.k_iters):
        losses, grads = vgrad(params, frames[k], labels[k])
        params, opt, u = step(params, grads, opt, mask)
    if record:
        timing.block((params, opt, u, losses))
        # nbytes: the optimizer update's traffic only (33 B per coordinate
        # and iteration, forward/backward excluded), as in the JAX package
        timing.record("train_fused", time.perf_counter() - t0, first=first,
                      key=key, nbytes=(len(members) * cfg.k_iters * 33
                                       * selection.tree_size(s0.params)))
    return params, opt, u, losses, mask


def _commit_stacked(members, t_now, out, results) -> None:
    """Encode the group's wire deltas (one batched device-to-host pull) and
    commit per-member state, each on its session's own device."""
    params, opt, u, losses, mask = out
    losses = losses.detach().cpu().numpy()
    b = len(members)
    out_dev = tree.leaves(params)[0].device
    deltas = encode_delta_stack(params, mask, b, members[0][1].cfg.value_dtype)
    _UPDATE_STATS["stacked_encode_launches"] += 1
    _UPDATE_STATS["stacked_encode_sessions"] += b
    for j, (i, s, _, _, _), p_j, o_j, u_j in zip(
            range(b), members, unstack_tree(params, b),
            unstack_tree(opt, b), unstack_tree(u, b)):
        if out_dev != s.device:
            p_j, o_j, u_j = (_to(x, s.device) for x in (p_j, o_j, u_j))
        results[i] = s._commit_phase(t_now, p_j, o_j, u_j,
                                     float(losses[j]), None,
                                     delta=deltas[j])
