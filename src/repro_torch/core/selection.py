"""Coordinate-subset selection (paper §3.1.2).

`gradient_guided_mask` implements the paper's method: pick the γ-fraction
of coordinates with the largest |u_{n-1}| (last Adam update of the
previous phase). Up to `_SMALL` coordinates the threshold is the exact
``sort(|u|)[N-k]``, found by the bit-pattern top-k search
(`repro_torch.kernels.topk_mask`: the kernel on the card, its plain
version on the CPU). Above `_SMALL`, bisection over per-leaf counts (the
JAX package's large-tree path, plain tensor ops on either device).

`stacked_gradient_guided_masks` selects for B stacked sessions at once;
session b's slice equals ``gradient_guided_mask(u_b, frac)``.

With `core.timing` on, the two record stages ``select_solo`` and
``select_stacked`` (key ``(B,)``), the first call per tree structure and
γ in the process in the first-call bucket, as in the JAX package.

`random_mask` draws the first phase's uniform mask from a
`torch.Generator`. The Table-3 ablation strategies (random, first, last,
first_last, full) go through `make_mask`; the positional ones select
whole leaves in flatten order, the JAX package's leaf order.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import timing
from repro_torch.kernels.topk_mask import ops as topk_ops

_SMALL = 20_000_000  # below this, the exact threshold beats bisection


def tree_size(t) -> int:
    return sum(l.numel() for l in tree.leaves(t))


# (structure, γ) keys already selected on, solo and stacked: the first call
# per key lands in the timing's first-call bucket
_SOLO_SEEN: set = set()
_STACK_SEEN: set = set()


def _select_nbytes(b: int, per_session: int) -> int:
    """Least traffic of the stacked selection: one float32 read of every
    |u| coordinate plus one bool mask write."""
    return b * per_session * 5


# ---------------------------------------------------------------------------
# gradient-guided (the paper's strategy)
# ---------------------------------------------------------------------------


def _count_above(leaves, thr) -> torch.Tensor:
    return sum((torch.abs(l.to(torch.float32)) > thr).sum() for l in leaves)


def global_threshold(u_tree, frac: float, iters: int = 32) -> torch.Tensor:
    """Bisection for t with |{x : |x| > t}| ~= frac * N."""
    leaves = tree.leaves(u_tree)
    n_target = torch.tensor(frac * tree_size(u_tree), dtype=torch.float32)
    hi = torch.clamp(torch.stack([torch.abs(l.to(torch.float32)).max()
                                  for l in leaves]).max(), min=1e-20)
    lo = torch.zeros((), dtype=torch.float32, device=hi.device)
    n_target = n_target.to(hi.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        above = _count_above(leaves, mid).to(torch.float32) > n_target
        # too many above -> raise threshold
        lo, hi = torch.where(above, mid, lo), torch.where(above, hi, mid)
    return 0.5 * (lo + hi)


def gradient_guided_mask(u_tree, frac: float):
    """Mask of the γ-fraction largest-|u| coordinates (paper Alg. 2 line 1).

    Small trees: the exact global top-k threshold, ``|u| >= thr``. Large
    trees: bisection over per-leaf counts, ``|u| > thr``."""
    if not timing.enabled():
        return _gradient_guided_mask(u_tree, frac)
    key = (tree.struct(u_tree), float(frac))
    first = key not in _SOLO_SEEN
    _SOLO_SEEN.add(key)
    t0 = time.perf_counter()
    out = _gradient_guided_mask(u_tree, frac)
    timing.block(out)
    timing.record("select_solo", time.perf_counter() - t0, first=first)
    return out


def _gradient_guided_mask(u_tree, frac: float):
    if tree_size(u_tree) > _SMALL:
        thr = global_threshold(u_tree, frac)
        return tree.tree_map(lambda u: torch.abs(u.to(torch.float32)) > thr, u_tree)
    one = tree.tree_map(lambda l: l.unsqueeze(0), u_tree)
    return tree.tree_map(lambda l: l[0], topk_ops.stacked_topk_masks(one, frac))


def stacked_gradient_guided_masks(u_stacked, frac: float):
    """Per-session gradient-guided masks for a B-stacked update tree.

    ``u_stacked`` carries a leading session axis on every leaf. Up to
    `_SMALL` coordinates per session, one top-k threshold launch covers
    all B sessions (its plain version on the CPU); above it, per-session
    bisection. Returns the stacked bool mask tree."""
    leaves = tree.leaves(u_stacked)
    if not leaves:
        raise ValueError("stacked selection needs at least one leaf")
    if not timing.enabled():
        return _stacked_select(u_stacked, frac)
    b = int(leaves[0].shape[0])
    key = (tree.struct(u_stacked), float(frac))
    first = key not in _STACK_SEEN
    _STACK_SEEN.add(key)
    t0 = time.perf_counter()
    out = _stacked_select(u_stacked, frac)
    timing.block(out)
    timing.record("select_stacked", time.perf_counter() - t0, first=first,
                  key=(b,), nbytes=_select_nbytes(
                      b, sum(l[0].numel() for l in leaves)))
    return out


def _stacked_select(u_stacked, frac: float):
    leaves = tree.leaves(u_stacked)
    if sum(l[0].numel() for l in leaves) > _SMALL:
        b = leaves[0].shape[0]
        per = [_gradient_guided_mask(
            tree.tree_map(lambda l: l[i], u_stacked), frac) for i in range(b)]
        return tree.tree_map(lambda *ls: torch.stack(ls), *per)
    return topk_ops.stacked_topk_masks(u_stacked, frac)


# ---------------------------------------------------------------------------
# ablation strategies (Table 3)
# ---------------------------------------------------------------------------


def random_mask(gen: torch.Generator, params, frac: float):
    """Uniform Bernoulli(frac) mask like ``params``, drawn leaf by leaf in
    flatten order from ``gen`` on the generator's device (a CPU generator
    gives the same mask wherever the params are; a CUDA one draws a
    billion-coordinate mask on the card), placed beside each leaf."""
    return tree.tree_map(
        lambda l: (torch.rand(l.shape, generator=gen, device=gen.device)
                   < frac).to(l.device),
        params)


def _positional_mask(params, frac: float, *, reverse: bool):
    """Select whole leaves in flattened traversal order until γN params are
    covered (partial fill on the boundary leaf). Host-side, numpy; each
    mask leaf is placed beside its param leaf."""
    leaves, treedef = tree.flatten(params)
    order = list(range(len(leaves)))
    if reverse:
        order = order[::-1]
    budget = int(frac * sum(l.numel() for l in leaves))
    masks = [None] * len(leaves)
    for idx in order:
        shape = tuple(leaves[idx].shape)
        n = leaves[idx].numel()
        if budget >= n:
            masks[idx] = np.ones(shape, bool)
            budget -= n
        elif budget > 0:
            flat = np.zeros(n, bool)
            flat[:budget] = True
            masks[idx] = flat.reshape(shape)
            budget = 0
        else:
            masks[idx] = np.zeros(shape, bool)
    return tree.unflatten(treedef, [torch.from_numpy(m).to(l.device)
                                    for m, l in zip(masks, leaves)])


def first_layers_mask(params, frac: float):
    return _positional_mask(params, frac, reverse=False)


def last_layers_mask(params, frac: float):
    return _positional_mask(params, frac, reverse=True)


def first_last_mask(params, frac: float):
    a = _positional_mask(params, frac / 2, reverse=False)
    b = _positional_mask(params, frac / 2, reverse=True)
    return tree.tree_map(torch.logical_or, a, b)


def make_mask(strategy: str, *, params=None, u_prev=None, frac: float,
              rng: torch.Generator | None = None):
    if strategy == "gradient_guided":
        if u_prev is None:
            raise ValueError("gradient_guided needs u_prev")
        return gradient_guided_mask(u_prev, frac)
    if strategy == "random":
        if rng is None:
            raise ValueError("random needs a torch.Generator")
        return random_mask(rng, params, frac)
    if strategy == "first":
        return first_layers_mask(params, frac)
    if strategy == "last":
        return last_layers_mask(params, frac)
    if strategy == "first_last":
        return first_last_mask(params, frac)
    if strategy == "full":
        return tree.tree_map(
            lambda p: torch.ones(p.shape, dtype=torch.bool, device=p.device),
            params)
    raise ValueError(strategy)


def mask_fraction(mask) -> float:
    n = tree_size(mask)
    sel = sum(int(l.sum()) for l in tree.leaves(mask))
    return sel / max(n, 1)
