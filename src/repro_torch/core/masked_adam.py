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

`FlatMaskedAdam` is the same step for one large model trained in place
(the LLM trainer): params, gradients, moments, mask and u live in flat
per-dtype buffers across steps, the model's leaves are views into them,
and the kernel updates p, m and v where they lie, with no per-step copy.
Its step can clip the gradients to a global norm first (the JAX
trainer's clip): the gradient-norm kernel reads the flat gradients once,
and the masked-Adam kernel applies the clip as it steps.

`ShardedMaskedAdam` is `FlatMaskedAdam`'s interface over DTensor params
(the dry run's sharded trace): the flat layout concatenates leaves, which
DTensors of different placements cannot be, so each leaf's local shard
gets a flat buffer of its own, and the kernels step each shard where it
lies.

`momentum_update` (the Just-In-Time baseline's momentum SGD) is plain
PyTorch on either device: the JAX package has no kernel for it.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import spmd, tree
from repro_torch.kernels import stacking
from repro_torch.kernels.grad_norm.ops import grad_norm
from repro_torch.kernels.masked_adam.ops import (bias_correction, masked_adam_3d,
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


class FlatMaskedAdam:
    """Masked Adam for one model whose state is kept flat and updated in
    place: per param dtype, one ``(1, rows, 128)`` buffer each of params
    ``p``, gradients ``g``, moments ``m`` (``m_dtype``, by default the
    param dtype, as `init_state` gives) and ``v`` (float32), the mask
    (bool) and the last update ``u`` (float32), laid out by
    `kernels.stacking` for a stack of one (zero padding past the leaves).

    ``params`` is the model's tree of leaves that are views into ``p``
    and require grad; each leaf's ``.grad`` is a view into ``g``, so
    backward accumulates there (`zero_grad` clears it first). ``grads``,
    ``mask`` and ``u`` are trees of views into their buffers. `step`
    runs one kernel launch per dtype group, writing p, m, v and u in
    place: the arithmetic of `masked_adam_update`, bit for bit. Given the
    norm from `grad_norm` (one launch over every group) and a clip, each
    group's launch clips g, writing the clipped gradients back.

    Building it copies the given params once into ``p``; the caller drops
    its own tree afterwards."""

    def __init__(self, params, m_dtype=None):
        one = tree.tree_map(lambda l: l.detach().unsqueeze(0), params)
        self.plan = stacking.stack_plan(one)
        with torch.no_grad():
            self.p = stacking.flatten_tree(one, self.plan)
        del one
        self.g = tuple(torch.zeros_like(b) for b in self.p)
        self.m = tuple(torch.zeros_like(b, dtype=m_dtype or b.dtype) for b in self.p)
        self.v = tuple(torch.zeros_like(b, dtype=torch.float32) for b in self.p)
        self.u = tuple(torch.zeros_like(b, dtype=torch.float32) for b in self.p)
        self.mask_buf = tuple(torch.zeros_like(b, dtype=torch.bool) for b in self.p)
        self.count = torch.zeros((1,), dtype=torch.int32, device=self.p[0].device)
        self.params = self.views(self.p)
        for leaf in tree.leaves(self.params):
            leaf.requires_grad_(True)
        self.grads = self.views(self.g)
        for leaf, g in zip(tree.leaves(self.params), tree.leaves(self.grads)):
            leaf.grad = g
        self.mask = self.views(self.mask_buf)
        self.u_tree = self.views(self.u)

    def views(self, bufs):
        """The tree whose leaves are views into ``bufs`` (one per dtype
        group, laid out like ``p``)."""
        return tree.tree_map(lambda l: l[0], stacking.unflatten_tree(bufs, self.plan))

    def zero_grad(self) -> None:
        for g in self.g:
            g.zero_()

    def set_mask(self, mask) -> None:
        """Copy a mask tree (bool or 0/1, like params) into the flat mask."""
        with torch.no_grad():
            for dst, src in zip(tree.leaves(self.mask), tree.leaves(mask)):
                dst.copy_(src)

    def grad_norm(self) -> torch.Tensor:
        """The global L2 norm of the gradients in ``g``, a float32 scalar
        on their device (the gradient-norm kernel; no host sync)."""
        with torch.no_grad():
            return grad_norm(self.g)

    def step(self, *, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8, gn=None, clip: float = 0.0) -> None:
        """One inner iteration (paper lines 7-13) over the gradients in
        ``g``, in place; ``u`` holds its update afterwards. Given ``gn``
        (`grad_norm`) and a positive ``clip``, the gradients are first
        clipped to global norm ``clip`` with the JAX trainer's non-finite
        guard (`kernels.masked_adam.ref.clip_ref`), and ``g`` holds the
        clipped gradients afterwards; one without the other raises."""
        i, bc = bias_correction(self.count, lr=lr, b1=b1, b2=b2)
        with torch.no_grad():
            for p, g, m, v, b, u in zip(self.p, self.g, self.m, self.v, self.mask_buf,
                                        self.u):
                masked_adam_3d(p, g, m, v, b, bc, b1=b1, b2=b2, eps=eps,
                               out=(p, m, v, u), gn=gn, clip=clip)
        self.count = i


def _flat_local(t):
    """A local shard as a (1, rows, 128) buffer (zero padding past it)."""
    n = t.numel()
    out = t.new_zeros((1, -(-n // stacking.LANES), stacking.LANES))
    out.view(-1)[:n].copy_(t.reshape(-1))
    return out


class ShardedMaskedAdam:
    """`FlatMaskedAdam`'s interface (``params``, ``zero_grad``,
    ``grad_norm``, ``step``, ``u_tree``) over a tree of DTensor params
    that require grad. Each leaf's local shard is laid out as its own
    ``(1, rows, 128)`` buffer, a DTensor sharded along its rows on the
    mesh dims that shard the leaf (replicated on the rest), with m
    (``m_dtype``), v, u (float32) and the mask (bool) beside it. `step`
    flattens each leaf and its gradient (a gradient still a partial sum
    is reduced to the leaf's placements first: the step's reduce-scatter
    or all-reduce), runs masked Adam on each shard (`masked_adam_3d`'s
    DTensor branch) and writes the new values back into the leaf;
    `grad_norm` sums the shards' squares and all-reduces them once
    (`kernels.grad_norm.ops.grad_norm`'s DTensor branch)."""

    def __init__(self, params, m_dtype=None):
        from torch.distributed.tensor import Replicate, Shard

        self.params = params
        self.leaves = tree.leaves(params)
        self.flat_place = [[Shard(1) if isinstance(p, Shard) else Replicate()
                            for p in leaf.placements] for leaf in self.leaves]
        flat = [self._flat(leaf.detach(), j) for j, leaf in enumerate(self.leaves)]
        self.m = [torch.zeros_like(b, dtype=m_dtype or b.dtype) for b in flat]
        self.v = [torch.zeros_like(b, dtype=torch.float32) for b in flat]
        self.u = [torch.zeros_like(b, dtype=torch.float32) for b in flat]
        self.mask_buf = [torch.zeros_like(b, dtype=torch.bool) for b in flat]
        self.count = spmd.like(torch.zeros((1,), dtype=torch.int32,
                                           device=flat[0].to_local().device), flat[0])
        self.g = None
        self.u_tree = tree.unflatten(tree.flatten(params)[1], self.u)

    def _flat(self, t, j: int):
        """Leaf j's (or its gradient's, its mask's) local shard as its flat
        buffer."""
        return spmd.local(_flat_local, self.flat_place[j], (self.leaves[j].placements,))(t)

    def set_mask(self, mask) -> None:
        """Copy a mask tree (DTensors placed as the params) into the flat
        masks."""
        self.mask_buf = [self._flat(m, j).to(torch.bool)
                         for j, m in enumerate(tree.leaves(mask))]

    def zero_grad(self) -> None:
        for leaf in self.leaves:
            leaf.grad = None
        self.g = None

    def _grads(self):
        if self.g is None:
            self.g = [self._flat(leaf.grad, j) for j, leaf in enumerate(self.leaves)]
        return self.g

    def grad_norm(self):
        with torch.no_grad():
            return grad_norm(self._grads())

    def step(self, *, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8, gn=None, clip: float = 0.0) -> None:
        i, bc = bias_correction(self.count, lr=lr, b1=b1, b2=b2)
        with torch.no_grad():
            g = self._grads()
            for j, leaf in enumerate(self.leaves):
                p = self._flat(leaf.detach(), j)
                p, self.m[j], self.v[j], self.u[j] = masked_adam_3d(
                    p, g[j], self.m[j], self.v[j], self.mask_buf[j], bc, b1=b1, b2=b2,
                    eps=eps, gn=gn, clip=clip)
                unflat = spmd.local(
                    lambda f, t: f.reshape(-1)[:t.numel()].view(t.shape),
                    leaf.placements, (self.flat_place[j], leaf.placements))
                leaf.detach().copy_(unflat(p, leaf.detach()))
        self.u_tree = tree.unflatten(tree.flatten(self.params)[1], self.u)
        self.count = i


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
