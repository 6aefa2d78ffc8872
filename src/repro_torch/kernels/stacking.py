"""Flatten-and-concatenate plans for stacked (B, ...) parameter trees.

The stacked kernels (masked Adam, bit-pattern top-k) want each session's
parameters as ONE lane-aligned buffer, ``(B, rows, 128)``, so a whole fused
group moves through device memory in a single launch instead of one per
leaf. The flatten is one ``torch.cat`` of the leaves' B-major views and
the zero padding, and the unflatten is slice + view: both bit-exact
re-layouts, so a kernel output unstacks to exactly the per-leaf tensors a
per-leaf update would have produced. Unflattened leaves are views into
the kernel's output buffer; nothing is copied back.

A `StackPlan` caches the host-side bookkeeping per shape/dtype struct:
leaf order grouped by dtype (groups in sorted dtype-name order, leaves in
flatten order), per-leaf sizes and offsets, and the row count.

`flatten_tree` / `unflatten_tree` do the same for a whole tree at once,
one buffer per dtype group: the fused phase keeps params, Adam moments
and the mask in that flat layout for a whole K loop
(`kernels.masked_adam.ops.masked_adam_flat`), flattening each tree once
per phase and each iteration's gradients once per iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree

LANES = 128


def dtype_name(dtype: torch.dtype) -> str:
    """numpy-style name ("float32", "bfloat16", "bool")."""
    return str(dtype).removeprefix("torch.")


class DtypeGroup(NamedTuple):
    dtype: str            # param dtype name of every leaf in the group
    indices: tuple        # leaf positions (flatten order) in the source tree
    sizes: tuple          # per-session flat size of each leaf
    offsets: tuple        # start of each leaf inside the concat buffer
    n: int                # per-session valid elements (sum of sizes)
    rows: int             # ceil(n / LANES) — buffer is (B, rows, LANES)


class StackPlan(NamedTuple):
    b: int                # session-axis length
    groups: tuple         # DtypeGroup per distinct leaf dtype
    shapes: tuple         # per-leaf full shapes (B first), flatten order
    treedef: object


_PLANS: dict = {}


def stack_plan(stacked) -> StackPlan:
    """The (cached) flatten/concat plan for a stacked tree whose every leaf
    carries a leading session axis B."""
    leaves, treedef = tree.flatten(stacked)
    if not leaves:
        raise ValueError("stack_plan needs at least one leaf")
    key = (treedef, tuple((tuple(l.shape), dtype_name(l.dtype)) for l in leaves))
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    b = int(leaves[0].shape[0])
    for l in leaves:
        if l.shape[0] != b:
            raise ValueError(f"inconsistent session axis: {l.shape[0]} vs {b}")
    by_dtype: dict[str, list[int]] = {}
    for i, l in enumerate(leaves):
        by_dtype.setdefault(dtype_name(l.dtype), []).append(i)
    groups = []
    for dt in sorted(by_dtype):
        idx = tuple(by_dtype[dt])
        sizes = tuple(leaves[i][0].numel() for i in idx)
        offsets, off = [], 0
        for s in sizes:
            offsets.append(off)
            off += s
        rows = -(-off // LANES)  # ceil
        groups.append(DtypeGroup(dt, idx, sizes, tuple(offsets), off, rows))
    plan = StackPlan(b, tuple(groups), tuple(tuple(l.shape) for l in leaves),
                     treedef)
    _PLANS[key] = plan
    return plan


def _group_parts(leaves, group: DtypeGroup, b: int, transform=None) -> list:
    """The group's (transformed) leaves as ``(B, n_leaf)`` views, checked
    to share one dtype."""
    parts = []
    for i in group.indices:
        l = leaves[i] if transform is None else transform(leaves[i])
        parts.append(l.reshape(b, -1))
    dtype = parts[0].dtype
    if any(p.dtype != dtype for p in parts):
        raise ValueError(
            f"dtype group {group.dtype!r} mixes leaf dtypes "
            f"{sorted({dtype_name(p.dtype) for p in parts})}")
    return parts


def flatten_group(leaves, group: DtypeGroup, b: int, transform=None):
    """Concat a dtype group's leaves into the kernel buffer
    ``(B, rows, LANES)``, zero-padded past ``group.n``: ONE ``torch.cat``
    of the B-major leaf views and the padding. ``transform`` maps each leaf
    elementwise before it is written; the padding stays zero. Every
    (transformed) leaf of the group must share one dtype, which is the
    buffer's."""
    parts = _group_parts(leaves, group, b, transform)
    pad = group.rows * LANES - group.n
    if pad:
        parts.append(parts[0].new_zeros((b, pad)))
    return torch.cat(parts, dim=1).view(b, group.rows, LANES)


def unflatten_group(buf, group: DtypeGroup, b: int, shapes, out: list) -> None:
    """Inverse of `flatten_group`: each leaf of the group as a view into
    ``buf``, written into ``out`` (a list indexed like the source tree's
    flat leaves). Padding is dropped; the round trip is bit-exact."""
    flat = buf.reshape(b, group.rows * LANES)
    for i, size, off in zip(group.indices, group.sizes, group.offsets):
        out[i] = flat[:, off:off + size].view(shapes[i])


def flatten_tree(t, plan: StackPlan) -> tuple:
    """A stacked tree laid out like ``plan``'s (same structure and shapes;
    leaf dtypes may differ from the plan's, one per group) as one
    ``(B, rows, LANES)`` buffer per dtype group, in ``plan.groups``
    order."""
    leaves = tree.leaves(t)
    return tuple(flatten_group(leaves, g, plan.b) for g in plan.groups)


def unflatten_tree(bufs, plan: StackPlan):
    """Inverse of `flatten_tree`: the tree whose leaves are views into
    ``bufs``."""
    out = [None] * len(plan.shapes)
    for buf, g in zip(bufs, plan.groups):
        unflatten_group(buf, g, plan.b, plan.shapes, out)
    return tree.unflatten(plan.treedef, out)
