"""Generic decoder stack (the JAX package's `models/transformer.py`).

Every architecture is a repeated `pattern` of block kinds. The port runs

    attn        full causal self-attention + MLP
    attn_local  sliding-window causal self-attention + MLP
    attn_nc     non-causal self-attention + MLP
    moe         full causal self-attention + MoE
    moe_local   sliding-window self-attention + MoE (mixtral)

and raises ``NotImplementedError`` for the others (``xattn``,
``attn_xattn``, ``mamba``, ``rwkv``, the shared attention block and the
encoder), which wait for ROADMAP §1 item 7.

Parameters for each pattern position are stacked over groups, as in the
JAX package (``groups/b{i}`` leaves of shape (num_groups, ...)). Where
the JAX package scans over that axis, the port loops over it in Python,
indexing each leaf; there is no backward pass, so there is no remat. The
MoE blocks' load-balance losses are summed over the stack as the JAX
package sums them: per group, then over the groups.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ModelConfig, ParamMeta, norm_meta, stack_group
from repro_torch.models.layers import (
    apply_norm,
    embed_apply,
    embed_metas,
    mlp_apply,
    mlp_metas,
    unembed_apply,
)

DENSE_KINDS = ("attn", "attn_local", "attn_nc")
MOE_KINDS = ("moe", "moe_local")
PORTED_KINDS = DENSE_KINDS + MOE_KINDS


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP §1 item 7: Mamba2, RWKV6, "
        "cross-attention, the shared attention block and the encoder)")


def _check_ported(cfg: ModelConfig):
    for kind in cfg.pattern:
        if kind not in PORTED_KINDS:
            raise _not_ported(f"block kind {kind!r}")
    if cfg.shared_attn:
        raise _not_ported("shared_attn")
    if cfg.encoder_layers:
        raise _not_ported("encoder_layers")


# ---------------------------------------------------------------------------
# Metas
# ---------------------------------------------------------------------------


def block_metas(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    if kind in PORTED_KINDS:
        m = {"ln1": norm_meta(d), "attn": attn.attn_metas(cfg), "ln2": norm_meta(d)}
        if kind in MOE_KINDS:
            m["moe"] = moe_mod.moe_metas(cfg)
        else:
            m["mlp"] = mlp_metas(cfg)
        if cfg.post_norm:
            m["ln1_post"] = norm_meta(d)
            m["ln2_post"] = norm_meta(d)
        return m
    raise _not_ported(f"block kind {kind!r}")


def model_metas(cfg: ModelConfig) -> dict:
    _check_ported(cfg)
    groups = {
        f"b{i}": stack_group(block_metas(cfg, kind), cfg.num_groups)
        for i, kind in enumerate(cfg.pattern)
    }
    return {"embed": embed_metas(cfg), "groups": groups,
            "final_norm": norm_meta(cfg.d_model)}


# ---------------------------------------------------------------------------
# Block apply (full sequence / prefill)
# ---------------------------------------------------------------------------


def _window_for(cfg: ModelConfig, kind: str) -> int:
    return cfg.window_size if kind in ("attn_local", "moe_local") else 0


def _attn_sub(cfg, p, x, kind, positions, want_cache):
    h = apply_norm(cfg, x, p["ln1"])
    causal = kind != "attn_nc"
    out, kv = attn.self_attention(
        cfg, p["attn"], h, window=_window_for(cfg, kind), positions=positions,
        causal=causal)
    if cfg.post_norm:
        out = apply_norm(cfg, out, p["ln1_post"])
    cache = {"k": kv[0], "v": kv[1]} if want_cache else None
    return x + out, cache


def _ffn(cfg: ModelConfig, kind: str, p: dict, h):
    """The block's MLP or MoE on its normed input: (out, aux_loss), aux
    None for an MLP."""
    if kind in MOE_KINDS:
        return moe_mod.moe_apply(cfg, p["moe"], h)
    return mlp_apply(cfg, p["mlp"], h), None


def block_apply(cfg: ModelConfig, kind: str, p: dict, x, *, positions,
                want_cache: bool = False):
    """Returns (x, aux_loss, cache_or_None)."""
    if kind not in PORTED_KINDS:
        raise _not_ported(f"block kind {kind!r}")
    x, cache = _attn_sub(cfg, p, x, kind, positions, want_cache)
    h = apply_norm(cfg, x, p["ln2"])
    out, aux = _ffn(cfg, kind, p, h)
    if cfg.post_norm:
        out = apply_norm(cfg, out, p["ln2_post"])
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux, cache


def group_params(params: dict, g: int) -> dict:
    """Group ``g``'s block params: every stacked ``groups`` leaf indexed at
    g (views, no copy)."""
    return tree.tree_map(lambda l: l[g], params["groups"])


def _stack_forward(cfg: ModelConfig, params: dict, x, positions):
    """Decoder trunk (no embed/unembed). Returns (x, total_aux): each
    group's blocks' aux losses summed, then the groups' sums."""
    auxs = []
    for g in range(cfg.num_groups):
        gp = group_params(params, g)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(cfg.pattern):
            x, a, _ = block_apply(cfg, kind, gp[f"b{i}"], x, positions=positions)
            aux = aux + a
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device).expand(B, S)


def forward(cfg: ModelConfig, params: dict, tokens):
    """tokens: (B,S) int. Returns (logits (B,S,V), aux): aux is the MoE
    load-balance loss summed over the stack (0 for dense stacks)."""
    _check_ported(cfg)
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = embed_apply(cfg, params["embed"], tokens, positions)
    x, aux = _stack_forward(cfg, params, x, positions)
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed_apply(cfg, params["embed"], x), aux


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def ring_len(cfg: ModelConfig, kind: str, seq: int) -> int:
    """Self-attention cache length for a block: the full seq, or the ring
    size min(seq, window) under the ring-cache option."""
    if not cfg.decode_window_slicing:
        return seq
    if kind in ("attn_local", "moe_local") and cfg.window_size:
        w = cfg.window_size
    else:
        w = cfg.attn_window_override
    return min(seq, w) if w else seq


def cache_metas(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """ParamMeta tree describing the decode cache: for each pattern
    position, k and v of shape (num_groups, batch, R, KV, hd)."""
    _check_ported(cfg)
    kv, hd, G = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_groups
    caches = {}
    for i, kind in enumerate(cfg.pattern):
        r = ring_len(cfg, kind, seq)
        caches[f"b{i}"] = {"k": ParamMeta((G, batch, r, kv, hd), init="zeros"),
                           "v": ParamMeta((G, batch, r, kv, hd), init="zeros")}
    return caches


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=None, device="cuda"):
    dtype = dtype or cfg.cdtype
    return {b: {key: torch.zeros(m.shape, dtype=dtype, device=device)
                for key, m in c.items()}
            for b, c in cache_metas(cfg, batch, seq).items()}


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def block_decode(cfg: ModelConfig, kind: str, p: dict, x, cache, pos: int):
    """One-token decode for a single block. Returns (x, cache), with the
    cache updated in place."""
    if kind not in ("attn", "attn_local") + MOE_KINDS:
        raise _not_ported(f"decode of block kind {kind!r}")
    h = apply_norm(cfg, x, p["ln1"])
    out, cache = attn.decode_self_attention(cfg, p["attn"], h, cache, pos,
                                            window=_window_for(cfg, kind))
    if cfg.post_norm:
        out = apply_norm(cfg, out, p["ln1_post"])
    x = x + out
    h = apply_norm(cfg, x, p["ln2"])
    out, _ = _ffn(cfg, kind, p, h)
    if cfg.post_norm:
        out = apply_norm(cfg, out, p["ln2_post"])
    return x + out, cache


def decode_step(cfg: ModelConfig, params: dict, caches: dict, tokens, pos: int):
    """serve_step: one new token against a cache of `seq` positions.
    tokens: (B,1) int; pos: int. Returns (logits (B,1,V), caches), the
    caches written in place."""
    _check_ported(cfg)
    B = tokens.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=tokens.device)
    x = embed_apply(cfg, params["embed"], tokens, positions)
    for g in range(cfg.num_groups):
        gp = group_params(params, g)
        for i, kind in enumerate(cfg.pattern):
            c = caches[f"b{i}"]
            x, _ = block_decode(cfg, kind, gp[f"b{i}"], x,
                                {"k": c["k"][g], "v": c["v"][g]}, pos)
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed_apply(cfg, params["embed"], x), caches


def to_ring(c, out):
    """Write one group's prompt K or V (B, Sp, KV, hd) into its decode
    cache slice ``out`` (B, R, KV, hd): at the front (the rest stays zero),
    or, when the ring is shorter than the prompt, the last R positions
    rolled into their ``p mod R`` slots."""
    Sp, R = c.shape[1], out.shape[1]
    if Sp <= R:  # slots p % R == p: plain end-padding
        out[:, :Sp] = c
    else:
        out.copy_(torch.roll(c[:, Sp - R:], Sp % R, dims=1))


def prefill(cfg: ModelConfig, params: dict, tokens, cache_len: int):
    """Run the full prompt, returning (logits of the last position (B,1,V),
    caches sized cache_len). Each block's prompt K/V is written into a
    cache allocated once at its final size (the JAX package stacks them,
    then pads or rolls)."""
    _check_ported(cfg)
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = embed_apply(cfg, params["embed"], tokens, positions)
    caches = {}
    for g in range(cfg.num_groups):
        gp = group_params(params, g)
        for i, kind in enumerate(cfg.pattern):
            x, _, c = block_apply(cfg, kind, gp[f"b{i}"], x, positions=positions,
                                  want_cache=True)
            key = f"b{i}"
            if key not in caches:
                R = ring_len(cfg, kind, cache_len)
                shape = (cfg.num_groups, B, R) + tuple(c["k"].shape[2:])
                caches[key] = {kk: torch.zeros(shape, dtype=c[kk].dtype, device=x.device)
                               for kk in ("k", "v")}
            for kk in ("k", "v"):
                to_ring(c[kk], caches[key][kk][g])
    x = apply_norm(cfg, x, params["final_norm"])
    logits = unembed_apply(cfg, params["embed"], x[:, -1:])
    return logits, caches
