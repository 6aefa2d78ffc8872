"""Attention: GQA/MQA/MHA self- and cross-attention, full sequence and
one-token decode (the JAX package's `models/attention.py`).

Projection weights keep heads factored as (kv_heads, q_per_group), as
the JAX package lays them out:

    wq: (d, KV, G, hd)   q = einsum('bsd,dkgh->bskgh')
    wk: (d, KV, hd)      k = einsum('bsd,dkh->bskh')
    wv: (d, KV, hd)
    wo: (KV, G, hd, d)

The full-sequence paths, self-attention and cross-attention onto a
memory of Sm positions (non-causal, no rope, Sq != Sm), go through the
flash-attention wrapper (`repro_torch.kernels.flash_attention`): the
hand-written kernel on the card, its plain version on the CPU. One-token
decode, of either kind, stays plain torch (einsum and softmax in
float32), as the JAX package computes it outside any Pallas kernel; a
cross-attention block reads the memory's K/V that the prefill computed
once (`precompute_cross_cache`).
"""
from __future__ import annotations

import torch

from repro_torch import spmd
from repro_torch.core import timing
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import ModelConfig, ParamMeta
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def attn_metas(cfg: ModelConfig) -> dict:
    d, kv, hd = cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim
    g = cfg.num_heads // kv
    return {
        "wq": ParamMeta((d, kv, g, hd), ("attn_embed", "kv_heads", "qgroups", "unsharded")),
        "wk": ParamMeta((d, kv, hd), ("attn_embed", "kv_heads", "unsharded")),
        "wv": ParamMeta((d, kv, hd), ("attn_embed", "kv_heads", "unsharded")),
        "wo": ParamMeta((kv, g, hd, d), ("kv_heads", "qgroups", "unsharded", "attn_embed")),
    }


def _sharded_first(w, dims) -> list:
    """``dims`` of DTensor w, those it is sharded along first (each group
    in its own order): merged in that order, a head shard leads the
    merged dim, which DTensor can then keep sharded."""
    sharded = {p.dim % w.ndim for p in w.placements if p.is_shard()}
    return [d for d in dims if d in sharded] + [d for d in dims if d not in sharded]


def _project(eq: str, x, w):
    """``einsum(eq, x, w)`` for x (B, S, d) and w (d, *heads): (B, S,
    *heads). On DTensors it is the one product it decomposes into,
    (B, S, d) @ (d, prod(heads)), its head dims merged sharded dim first
    (`_sharded_first`) and split by `spmd.split_last`: DTensor may shard
    the product's merged head dim where the heads cannot be split back
    out of it."""
    if not spmd.is_dtensor(x):
        return torch.einsum(eq, x, w)
    order = _sharded_first(w, range(1, w.ndim))
    wp = w.permute(0, *order)
    y = spmd.split_last(x @ wp.flatten(1), wp.shape[1:])
    back = [2 + order.index(d) for d in range(1, w.ndim)]
    return y.permute(0, 1, *back)


def _project_out(o, wo):
    """``einsum('bskgh,kghd->bsd', o, wo)``; on DTensors (B, S, KV*G*hd) @
    (KV*G*hd, d), the heads merged sharded dim first (`_sharded_first`)
    by `spmd.merge_last` (whose gradient `_project`'s split takes care
    of)."""
    if not spmd.is_dtensor(o):
        return torch.einsum("bskgh,kghd->bsd", o, wo)
    order = _sharded_first(wo, range(3))
    return (spmd.merge_last(o.permute(0, 1, *(2 + d for d in order)), 3)
            @ wo.permute(*order, 3).flatten(0, 2))


def _proj_qkv(cfg: ModelConfig, p: dict, x, x_kv=None, positions=None,
              rope: bool = True):
    """q from x, k and v from x_kv (x itself for self-attention)."""
    x_kv = x if x_kv is None else x_kv
    q = _project("bsd,dkgh->bskgh", x, p["wq"])
    k = _project("bsd,dkh->bskh", x_kv, p["wk"])
    v = _project("bsd,dkh->bskh", x_kv, p["wv"])
    if rope and cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def self_attention(cfg: ModelConfig, p: dict, x, *, window: int, positions,
                   causal=True):
    """Full-sequence self attention. Returns (out, (k, v)) — k/v feed the
    prefill KV cache."""
    q, k, v = _proj_qkv(cfg, p, x, positions=positions)
    eff_window = window
    if cfg.attn_window_override and not window:
        eff_window = cfg.attn_window_override  # long-context SWA variant
    o = flash_attention(q, k, v, causal=causal, window=eff_window,
                        softcap=cfg.attn_logit_softcap)
    out = _project_out(o, p["wo"])
    return out, (k, v)


def cross_attention(cfg: ModelConfig, p: dict, x, memory):
    """Cross attention of x (B, S, d) onto the memory (B, Sm, d): no causal
    mask, no rope (the memory has its own implicit positions)."""
    q, k, v = _proj_qkv(cfg, p, x, x_kv=memory, rope=False)
    o = flash_attention(q, k, v, causal=False, window=0,
                        softcap=cfg.attn_logit_softcap)
    return _project_out(o, p["wo"])


def decode_self_attention(cfg: ModelConfig, p: dict, x, cache, pos: int, *,
                          window: int):
    """One-token decode. x: (B,1,d); cache: dict(k,v) each (B,R,KV,hd);
    pos: the current position (same for the whole batch).

    Unlike the JAX package, which returns a new cache, the new key and
    value are written into ``cache`` in place (a full-size cache is
    gigabytes; a copy per token would double it).

    Ring cache: when cfg.decode_window_slicing is on and the block is
    windowed, R == min(seq, window) and slot j holds absolute position
    pos - ((pos - j) mod R). Returns (out, cache). One
    ``attention.decode_self`` span (`core.timing.span`)."""
    with timing.span("attention.decode_self"):
        positions = spmd.like(torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                                         device=x.device), x)
        q, k_new, v_new = _proj_qkv(cfg, p, x, positions=positions)
        R = cache["k"].shape[1]
        eff_window = window or cfg.attn_window_override
        ring = bool(cfg.decode_window_slicing and eff_window)
        slot = pos % R if ring else pos
        _write_position(cache["k"], slot, k_new[:, 0].to(cache["k"].dtype))
        _write_position(cache["v"], slot, v_new[:, 0].to(cache["v"].dtype))
        j = spmd.like(torch.arange(R, device=x.device), x)
        kp = pos - torch.remainder(pos - j, R) if ring else j
        if spmd.is_dtensor(cache["k"]):
            o = _decode_attention_sharded(
                q, cache, kp, lambda q, k, kp: _decode_scores(cfg, q, k, kp, pos, eff_window))
            return _project_out(o.to(x.dtype), p["wo"]), cache
        pr = torch.softmax(_decode_scores(cfg, q, cache["k"], kp, pos, eff_window), dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", pr,
                         cache["v"].to(torch.float32)).to(x.dtype)
        out = _project_out(o, p["wo"])
        return out, cache


def _decode_scores(cfg: ModelConfig, q, k, kp=None, pos: int = 0, eff_window: int = 0):
    """The token's float32 scores (B, KV, G, 1, R) against the cached keys
    k (B, R, KV, hd) at positions kp (R,): scaled, softcapped, and masked
    to the positions at or before ``pos`` (within ``eff_window`` of it
    where it is set). Without kp, cross-attention's: scaled only."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32), k.to(torch.float32))
    s = s * (cfg.resolved_head_dim**-0.5)
    if kp is None:
        return s
    if cfg.attn_logit_softcap:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    mask = (kp <= pos) & (kp >= 0)
    if eff_window:
        mask &= kp > pos - eff_window
    return s.masked_fill(~mask, NEG_INF)


def _decode_attention_sharded(q, cache, kp, scores):
    """A decode step's attention on DTensors: the token's q moves to where
    the cache lies (its batch and kv-head shards, whole over the mesh
    dims that shard the positions) and each rank attends over its own
    positions kp (`spmd.local`), with the single-card code's
    ``scores(q, k, kp)`` (`_decode_scores`) but keeping its rows' max,
    sum and unnormalised output. Where the positions are sharded the shards'
    rows are then combined: an all-reduce of the maxima, each shard's
    terms rescaled to the common max, all-reduces of the sums and
    outputs. Returns o (B, 1, KV, G, hd) float32."""
    from torch.distributed.tensor import Partial

    ck = cache["k"]
    q = q.redistribute(placements=spmd.operand(ck, (0, 2), {0: 0, 2: 2})[0])
    seq = [p.is_shard(1) for p in ck.placements]
    pc = spmd.operand(ck, (0, 1, 2))[0]
    pk = spmd.operand(ck, (1,), {1: 0})[0]
    row = spmd.operand(ck, (0, 2), {0: 0, 2: 2})[0]  # (B, 1, KV, G, *) results
    stat_max = [Partial("max") if sq else r for sq, r in zip(seq, row)]
    stat_sum = [Partial() if sq else r for sq, r in zip(seq, row)]

    def attend(q, k, v, kp):
        s = scores(q, k, kp)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        o = torch.einsum("bkgqs,bskh->bqkgh", e, v.to(torch.float32))
        return o, m.permute(0, 3, 1, 2, 4), e.sum(dim=-1, keepdim=True).permute(0, 3, 1, 2, 4)

    o, m, l = spmd.local(attend, (stat_sum, stat_max, stat_sum),
                         (row, pc, pc, pk))(q, ck, cache["v"], kp)
    if any(seq):
        top = m.redistribute(placements=row)  # the rows' max over every shard

        def rescale(o, l, m, top):
            w = torch.exp(m - top)
            return o * w, l * w

        o, l = spmd.local(rescale, (stat_sum, stat_sum),
                          (stat_sum, stat_sum, stat_max, row))(o, l, m, top)
        o, l = spmd.reduced(o), spmd.reduced(l)
    return o / l


def _write_position(c, slot: int, new):
    """``c[:, slot] = new`` in place: c (B, R, KV, hd), new (B, KV, hd). A
    DTensor cache whose positions are sharded is written on the shard
    that holds ``slot`` (`spmd.write_index`), as a sharded cache update
    is, without gathering the cache."""
    if spmd.is_dtensor(c) and any(p.is_shard(1) for p in c.placements):
        spmd.write_index(c, 1, slot, new)
    else:
        c[:, slot] = new


def decode_cross_attention(cfg: ModelConfig, p: dict, x, mem_cache):
    """Decode-time cross attention against the memory's K/V from the
    prefill; mem_cache: dict(k, v) each (B, Sm, KV, hd), only read. One
    ``attention.decode_cross`` span (`core.timing.span`)."""
    with timing.span("attention.decode_cross"):
        q = _project("bsd,dkgh->bskgh", x, p["wq"])
        if spmd.is_dtensor(mem_cache["k"]):
            kp = spmd.like(torch.arange(mem_cache["k"].shape[1], device=x.device), x)
            o = _decode_attention_sharded(q, mem_cache, kp,
                                          lambda q, k, kp: _decode_scores(cfg, q, k))
            return _project_out(o.to(x.dtype), p["wo"])
        pr = torch.softmax(_decode_scores(cfg, q, mem_cache["k"]), dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", pr,
                         mem_cache["v"].to(torch.float32)).to(x.dtype)
        return _project_out(o, p["wo"])


def precompute_cross_cache(cfg: ModelConfig, p: dict, memory):
    """The memory's K and V (B, Sm, KV, hd), computed once at prefill."""
    k = _project("bsd,dkh->bskh", memory, p["wk"])
    v = _project("bsd,dkh->bskh", memory, p["wv"])
    return {"k": k, "v": v}
