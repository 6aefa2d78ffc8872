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


def _proj_qkv(cfg: ModelConfig, p: dict, x, x_kv=None, positions=None,
              rope: bool = True):
    """q from x, k and v from x_kv (x itself for self-attention)."""
    x_kv = x if x_kv is None else x_kv
    q = torch.einsum("bsd,dkgh->bskgh", x, p["wq"])
    k = torch.einsum("bsd,dkh->bskh", x_kv, p["wk"])
    v = torch.einsum("bsd,dkh->bskh", x_kv, p["wv"])
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
    out = torch.einsum("bskgh,kghd->bsd", o, p["wo"])
    return out, (k, v)


def cross_attention(cfg: ModelConfig, p: dict, x, memory):
    """Cross attention of x (B, S, d) onto the memory (B, Sm, d): no causal
    mask, no rope (the memory has its own implicit positions)."""
    q, k, v = _proj_qkv(cfg, p, x, x_kv=memory, rope=False)
    o = flash_attention(q, k, v, causal=False, window=0,
                        softcap=cfg.attn_logit_softcap)
    return torch.einsum("bskgh,kghd->bsd", o, p["wo"])


def decode_self_attention(cfg: ModelConfig, p: dict, x, cache, pos: int, *,
                          window: int):
    """One-token decode. x: (B,1,d); cache: dict(k,v) each (B,R,KV,hd);
    pos: the current position (same for the whole batch).

    Unlike the JAX package, which returns a new cache, the new key and
    value are written into ``cache`` in place (a full-size cache is
    gigabytes; a copy per token would double it).

    Ring cache: when cfg.decode_window_slicing is on and the block is
    windowed, R == min(seq, window) and slot j holds absolute position
    pos - ((pos - j) mod R). Returns (out, cache)."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _proj_qkv(cfg, p, x, positions=positions)
    R = cache["k"].shape[1]
    eff_window = window or cfg.attn_window_override
    ring = bool(cfg.decode_window_slicing and eff_window)
    slot = pos % R if ring else pos
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    j = torch.arange(R, device=x.device)
    kp = pos - torch.remainder(pos - j, R) if ring else j
    s = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32),
                     cache["k"].to(torch.float32))
    s = s * (cfg.resolved_head_dim**-0.5)
    if cfg.attn_logit_softcap:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    mask = (kp <= pos) & (kp >= 0)
    if eff_window:
        mask &= kp > pos - eff_window
    s = s.masked_fill(~mask, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", pr,
                     cache["v"].to(torch.float32)).to(x.dtype)
    out = torch.einsum("bskgh,kghd->bsd", o, p["wo"])
    return out, cache


def decode_cross_attention(cfg: ModelConfig, p: dict, x, mem_cache):
    """Decode-time cross attention against the memory's K/V from the
    prefill; mem_cache: dict(k, v) each (B, Sm, KV, hd), only read."""
    q = torch.einsum("bsd,dkgh->bskgh", x, p["wq"])
    s = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32),
                     mem_cache["k"].to(torch.float32))
    s = s * (cfg.resolved_head_dim**-0.5)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", pr,
                     mem_cache["v"].to(torch.float32)).to(x.dtype)
    return torch.einsum("bskgh,kghd->bsd", o, p["wo"])


def precompute_cross_cache(cfg: ModelConfig, p: dict, memory):
    """The memory's K and V (B, Sm, KV, hd), computed once at prefill."""
    k = torch.einsum("bsd,dkh->bskh", memory, p["wk"])
    v = torch.einsum("bsd,dkh->bskh", memory, p["wv"])
    return {"k": k, "v": v}
