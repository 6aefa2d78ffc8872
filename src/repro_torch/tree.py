"""Nested-container utilities in the JAX package's `jax.tree` order.

Parameters, masks and optimizer state are plain nests of dicts, tuples,
lists and NamedTuples with tensors at the leaves. The wire delta
concatenates leaves in flatten order, so that order must be the one the
JAX package uses: dict keys sorted, sequence and NamedTuple fields in
order. (`torch.utils._pytree` keeps dict insertion order, which would
reorder the wire.) A treedef is a hashable nest of tuples, so it can sit
inside a grouping key.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(t, leaves: list):
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return ("dict", keys, tuple(_flatten(t[k], leaves) for k in keys))
    if _is_namedtuple(t):
        return ("namedtuple", type(t), tuple(_flatten(c, leaves) for c in t))
    if isinstance(t, (tuple, list)):
        return (type(t).__name__, len(t), tuple(_flatten(c, leaves) for c in t))
    leaves.append(t)
    return None


def flatten(tree) -> tuple[list, Any]:
    """``(leaves, treedef)``; `unflatten` inverts it. (Module-level helpers
    rather than a recursive closure: a closure that calls itself is a
    reference cycle, which would keep the leaves, gigabytes of weights,
    alive until the cyclic collector runs.)"""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _unflatten(d, it):
    if d is None:
        return next(it)
    kind, meta, children = d
    built = [_unflatten(c, it) for c in children]
    if kind == "dict":
        return dict(zip(meta, built))
    if kind == "namedtuple":
        return meta(*built)
    return tuple(built) if kind == "tuple" else list(built)


def unflatten(treedef, leaves) -> Any:
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of ``tree`` and of same-structure
    ``rest`` trees, leaf by leaf."""
    ls, treedef = flatten(tree)
    others = []
    for r in rest:
        rl, rd = flatten(r)
        if rd != treedef:
            raise ValueError("tree_map over trees of different structure")
        others.append(rl)
    return unflatten(treedef, [fn(*xs) for xs in zip(ls, *others)])


def struct(tree) -> tuple:
    """Hashable structure, shape and dtype fingerprint of a tree."""
    ls, treedef = flatten(tree)
    return (treedef, tuple((tuple(l.shape), str(l.dtype)) for l in ls))
