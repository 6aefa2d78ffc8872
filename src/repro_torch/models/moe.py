"""Mixture-of-Experts layer: top-k router and capacity-based dispatch (the
JAX package's `models/moe.py`).

Tokens go into an (E, cap, d) buffer at positions given by a cumulative
count per expert, in token-major, k-minor order (O(T*E) ints, no
(T, E, cap) one-hot). A slot whose position reaches ``cap`` is dropped: it
contributes nothing, and its token keeps only its other experts (and the
shared ones). The buffer is written by an index assignment of the kept
slots alone, so the dispatch is deterministic on the card (each kept
(expert, position) pair is written once; nothing accumulates). The three
expert products are batched matrix products over the experts, which the
JAX package also computes outside any Pallas kernel. The JAX package's
`_act` is `layers.glu_act`.

``moe_ep_axis`` and ``moe_cap_axes`` pin the JAX package's expert-parallel
layout; nothing here reads them: the dry run's sharded trace places the
experts by the sharding rules alone.

On the meta device (the dry run, `launch/dryrun.py`) which slots are
kept is not known, and ``keep.nonzero()`` has no meta shape: there the
dispatch takes the bound, all T*k slots kept, as the JAX package's
capacity-based dispatch is static in shape. Only the gathered rows'
count depends on it (T*k rows at most).

On DTensors (the dry run's sharded trace and `scripts/spmd_values.py`)
the dispatch keeps and drops exactly the slots that one program over all
T tokens does, as the JAX package's step partitioned by GSPMD does
(`_dispatch_sharded`): each rank counts its slots per expert, the counts
are all-gathered (R*E ints), and a slot's position is its rank's
cumulative count after the lower ranks' counts, kept below `capacity`
of the global T. The (E, cap, d) buffer's capacity rows are sharded as
the tokens are; each rank all-gathers the tokens and the slots' ids,
positions and flags and writes its own rows, and the combine
reduce-scatters each rank's weighted rows over the tokens.

`moe_ref` is the dense oracle (every expert on every token, no drops).
"""
from __future__ import annotations

import functools

import torch

from repro_torch import spmd
from repro_torch.models.common import ModelConfig, ParamMeta
from repro_torch.models.layers import glu_act, mlp_apply, mlp_metas


def moe_metas(cfg: ModelConfig) -> dict:
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    m = {
        "router": ParamMeta((d, E), ("embed", "unsharded")),
        "wg": ParamMeta((E, d, ff), ("experts", "expert_embed", "expert_ff")),
        "wu": ParamMeta((E, d, ff), ("experts", "expert_embed", "expert_ff")),
        "wd": ParamMeta((E, ff, d), ("experts", "expert_ff", "expert_embed")),
    }
    if cfg.num_shared_experts:
        m["shared"] = mlp_metas(cfg, d_ff=cfg.num_shared_experts * ff)
    return m


def _route(cfg: ModelConfig, p: dict, x_flat):
    """Returns (weights (T,k) in x's dtype, idx (T,k), aux_loss float32):
    a float32 softmax over the router's logits, its top k renormalised,
    and the Switch load-balance loss over each token's first expert."""
    logits = (x_flat @ p["router"]).to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topk = functools.partial(torch.topk, k=cfg.experts_per_token, dim=-1)
    if spmd.is_dtensor(probs):  # per token: on each rank's tokens, experts whole
        (pt, gt) = spmd.operand(probs, (0,))
        topk = spmd.local(topk, (pt, pt), (pt,), (gt,))
    weights, idx = topk(probs)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    experts = spmd.like(torch.arange(cfg.num_experts, device=x_flat.device), x_flat)
    frac_tokens = (idx[:, :1] == experts).to(torch.float32).mean(dim=0)  # primary
    mean_probs = probs.mean(dim=0)
    aux = cfg.num_experts * torch.sum(frac_tokens * mean_probs)
    return weights.to(x_flat.dtype), idx, aux


def capacity(cfg: ModelConfig, T: int) -> int:
    """Buffer rows per expert for T tokens: capacity_factor * T * k / E,
    at least 1 and at most T."""
    cap = max(int(cfg.capacity_factor * T * cfg.experts_per_token / cfg.num_experts), 1)
    return min(cap, T)


def expert_counts(cfg: ModelConfig, idx):
    """Slots per expert of expert ids idx (T, k): (E,) int32."""
    experts = torch.arange(cfg.num_experts, device=idx.device)
    return (experts[:, None] == idx.reshape(-1)[None, :]).sum(dim=1, dtype=torch.int32)


def dispatch(cfg: ModelConfig, idx, offset=None, cap: int | None = None):
    """Each slot's position within its expert and whether it is kept.
    idx: (T, k) expert ids. Returns (pos_f, keep), both (T*k,), from the
    cumulative count per expert in token-major, k-minor order. The count
    runs along the slots as the innermost axis of an (E, T*k) one-hot: a
    scan over the outer axis of (T*k, E) took 25 ms a layer on an H100 at
    T*k = 96,000.

    On a shard of a program's tokens, ``offset`` (E,) counts each
    expert's slots on the tokens before the shard (`expert_counts` of the
    lower ranks' shards) and ``cap`` is the capacity of all the tokens:
    the positions and keep flags are then the shard's part of one
    dispatch over all of them. By default the shard is the whole: no
    offset, ``capacity(cfg, T)``."""
    T, k = idx.shape
    idx_f = idx.reshape(T * k)
    experts = torch.arange(cfg.num_experts, device=idx.device)
    one_hot = (experts[:, None] == idx_f[None, :]).to(torch.int32)  # (E, T*k)
    counts = torch.cumsum(one_hot, dim=1, dtype=torch.int32)
    pos_f = counts.gather(0, idx_f[None, :])[0] - 1
    if offset is not None:
        pos_f = pos_f + offset[idx_f]
    return pos_f, pos_f < (capacity(cfg, T) if cap is None else cap)


def _dispatch_tokens(cfg: ModelConfig, x_flat, idx):
    """The (E, cap, d) expert buffer of tokens x_flat (T, d) routed to
    experts idx (T, k), and each slot's position and keep flag (T*k,)."""
    T, d = x_flat.shape
    k, E = idx.shape[1], cfg.num_experts
    cap = capacity(cfg, T)
    idx_f = idx.reshape(T * k)
    pos_f, keep = dispatch(cfg, idx)

    # buffer row e * cap + pos of each kept slot, written once (token-major)
    if x_flat.device.type == "meta":  # the bound: every slot kept
        kept = torch.arange(T * k, device=x_flat.device)
    else:
        kept = keep.nonzero()[:, 0]
    buffer = torch.zeros((E * cap, d), dtype=x_flat.dtype, device=x_flat.device)
    buffer.index_copy_(0, idx_f[kept] * cap + pos_f[kept], x_flat.index_select(0, kept // k))
    return buffer.view(E, cap, d), pos_f, keep


def _combine(h_out, idx, weights, pos_f, keep):
    """Each token's kept slots' expert outputs from h_out (E, cap, d),
    weighted and summed: (T, d)."""
    E, cap, d = h_out.shape
    T, k = idx.shape
    idx_f, w_f = idx.reshape(T * k), weights.reshape(T * k)
    gathered = h_out.reshape(E * cap, d).index_select(
        0, idx_f * cap + torch.where(keep, pos_f, 0))  # (T*k, d)
    gathered = gathered * (w_f * keep.to(w_f.dtype))[:, None]
    return gathered.reshape(T, k, d).sum(dim=1)


def _own_slots(first: int, rows: int, E: int, pos_f, keep):
    """The kept slots (T*k,) whose position lies in [first, first + rows):
    their indices. On the meta device (the dry run) which they are is not
    known: the bound, the first min(T*k, E*rows) slots."""
    if keep.device.type == "meta":
        return torch.arange(min(keep.shape[0], E * rows), device=keep.device)
    return (keep & (pos_f >= first) & (pos_f < first + rows)).nonzero()[:, 0]


def _write_rows(cfg, first: int, rows: int, x_all, idx_all, pos_f, keep):
    """A rank's rows [first, first + rows) of every expert of the (E, cap,
    d) buffer of all T tokens x_all (T, d): (E, rows, d)."""
    E, k = cfg.num_experts, idx_all.shape[1]
    own = _own_slots(first, rows, E, pos_f, keep)
    buffer = torch.zeros((E * rows, x_all.shape[1]), dtype=x_all.dtype, device=x_all.device)
    buffer.index_copy_(0, idx_all.reshape(-1)[own] * rows + pos_f[own] - first,
                       x_all.index_select(0, own // k))
    return buffer.view(E, rows, -1)


def _combine_rows(first: int, rows: int, h_out, idx_all, w_all, pos_f, keep):
    """The expert outputs of a rank's rows h_out (E, rows, d), weighted and
    added to their tokens: (T, d), the rank's part of `_combine`'s sum."""
    E, _, d = h_out.shape
    T, k = idx_all.shape
    own = _own_slots(first, rows, E, pos_f, keep)
    got = h_out.reshape(E * rows, d).index_select(
        0, idx_all.reshape(-1)[own] * rows + pos_f[own] - first)
    got = got * w_all.reshape(-1)[own][:, None]
    return torch.zeros((T, d), dtype=got.dtype, device=got.device).index_add_(0, own // k, got)


def _dispatch_sharded(cfg: ModelConfig, x_flat, idx):
    """`_dispatch_tokens` and `_combine` of DTensor tokens x_flat (T, d) and
    their expert ids idx (T, k), both placed as x_flat is along the
    tokens: the slots that one program over all T tokens keeps, in the
    buffer that the JAX package lays out, its capacity rows sharded as the
    tokens are (R shards of ceil(cap / R) rows, the last padded).

    Positions: each rank counts its slots per expert, the (R, E) counts
    are all-gathered, and a slot's position is its rank's cumulative count
    after the lower ranks' counts (`dispatch` with an offset), kept below
    the capacity of all T tokens. The dispatch all-gathers the tokens and
    the slots' expert ids, positions and keep flags; each rank writes the
    kept slots of its own rows. The combine adds each rank's rows'
    weighted outputs to their tokens, and reduce-scatters the sums over
    the tokens. Returns (buffer, pos_f, keep, combine), the last as
    `_combine`'s signature."""
    from torch.distributed.tensor import Replicate

    mesh = x_flat.device_mesh
    tok = (0,)
    cap = capacity(cfg, x_flat.shape[0])
    px, pi = spmd.operand(x_flat, tok)[0], spmd.operand(x_flat, tok, {0: 0})[0]
    pb, gb = spmd.operand(x_flat, tok, {0: 1})
    whole, partial = spmd.operand(x_flat, tok, {})  # replicated; a partial sum
    rep = [Replicate()] * mesh.ndim
    # this rank's shard of the tokens (DTensor's order: mesh dims in turn)
    shards, rank, coord = 1, 0, mesh.get_coordinate()
    for i, p in enumerate(pi):
        if p.is_shard():
            shards, rank = shards * mesh.size(i), rank * mesh.size(i) + coord[i]
    rows = -(-cap // shards)
    first = rank * rows

    # (R, E): each rank's row its slots per expert, then the lower rows' sum
    counts = spmd.local(lambda i: expert_counts(cfg, i)[None], pi, (pi,))(idx)
    before = spmd.local(lambda c: torch.cumsum(c, dim=0, dtype=torch.int32) - c, rep,
                        (rep,))(counts.redistribute(placements=rep))
    pos_f, keep = spmd.local(lambda i, o: dispatch(cfg, i, o[0], cap), (pi, pi),
                             (pi, pi))(idx, before)
    slots = (whole,) * 3  # every rank reads every slot's expert, position, flag
    write = spmd.local(functools.partial(_write_rows, cfg, first, rows), pb,
                       (whole,) + slots, (partial,) + slots)
    buffer = write(x_flat, idx, pos_f, keep)
    add = spmd.local(functools.partial(_combine_rows, first, rows), partial,
                     (pb, whole, whole) + slots[1:], (gb, whole, partial, whole, whole))

    def combine(h_out, idx, weights, pos_f, keep):
        return add(h_out, idx, weights, pos_f, keep).redistribute(placements=px)

    return buffer, pos_f, keep, combine


def _dispatch(cfg: ModelConfig, x_flat, idx):
    """(buffer (E, cap, d), pos_f, keep, combine): `_dispatch_tokens`, and
    `_combine` as the layer calls it (on DTensors, `_dispatch_sharded`)."""
    if spmd.is_dtensor(x_flat):
        return _dispatch_sharded(cfg, x_flat, idx)
    return (*_dispatch_tokens(cfg, x_flat, idx), _combine)


def moe_apply(cfg: ModelConfig, p: dict, x):
    """x: (B, S, d) -> (out (B, S, d), aux_loss float32 scalar)."""
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    weights, idx, aux = _route(cfg, p, x_flat)
    buffer, pos_f, keep, combine = _dispatch(cfg, x_flat, idx)

    h = glu_act(cfg, torch.bmm(buffer, p["wg"])) * torch.bmm(buffer, p["wu"])
    out = combine(torch.bmm(h, p["wd"]), idx, weights, pos_f, keep)
    if cfg.num_shared_experts:
        out = out + mlp_apply(cfg, p["shared"], x_flat)
    return out.reshape(B, S, d), aux


def moe_ref(cfg: ModelConfig, p: dict, x):
    """Dense oracle: every expert on every token (no capacity drops)."""
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    weights, idx, aux = _route(cfg, p, x_flat)
    h = glu_act(cfg, torch.einsum("td,edf->tef", x_flat, p["wg"]))
    h = h * torch.einsum("td,edf->tef", x_flat, p["wu"])
    all_out = torch.einsum("tef,efd->ted", h, p["wd"])  # (T, E, d)
    sel = torch.take_along_dim(all_out, idx[..., None], dim=1)  # (T, k, d)
    out = (sel * weights[..., None]).sum(dim=1)
    if cfg.num_shared_experts:
        out = out + mlp_apply(cfg, p["shared"], x_flat)
    return out.reshape(B, S, d), aux
