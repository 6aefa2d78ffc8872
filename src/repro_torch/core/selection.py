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

`random_mask` draws the first phase's uniform mask from a
`torch.Generator`. The Table-3 ablation strategies are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.kernels.topk_mask import ops as topk_ops

_SMALL = 20_000_000  # below this, the exact threshold beats bisection


def tree_size(t) -> int:
    return sum(l.numel() for l in tree.leaves(t))


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
    if sum(l[0].numel() for l in leaves) > _SMALL:
        b = leaves[0].shape[0]
        per = [gradient_guided_mask(tree.tree_map(lambda l: l[i], u_stacked),
                                    frac) for i in range(b)]
        return tree.tree_map(lambda *ls: torch.stack(ls), *per)
    return topk_ops.stacked_topk_masks(u_stacked, frac)


# ---------------------------------------------------------------------------
# first-phase random mask
# ---------------------------------------------------------------------------


def random_mask(gen: torch.Generator, params, frac: float):
    """Uniform Bernoulli(frac) mask like ``params``, drawn leaf by leaf in
    flatten order from ``gen`` (a CPU generator), placed beside each
    leaf."""
    return tree.tree_map(
        lambda l: (torch.rand(l.shape, generator=gen) < frac).to(l.device),
        params)


def mask_fraction(mask) -> float:
    n = tree_size(mask)
    sel = sum(int(l.sum()) for l in tree.leaves(mask))
    return sel / max(n, 1)
