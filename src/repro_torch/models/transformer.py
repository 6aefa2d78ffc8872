"""Generic decoder stack (the JAX package's `models/transformer.py`).

Every architecture is a repeated `pattern` of block kinds:

    attn        full causal self-attention + MLP
    attn_local  sliding-window causal self-attention + MLP
    attn_nc     non-causal self-attention + MLP (whisper encoder)
    xattn       gated cross-attention (onto stub frontend memory) + MLP
    attn_xattn  self-attn + cross-attn + MLP in one block (whisper decoder)
    moe         full causal self-attention + MoE
    moe_local   sliding-window self-attention + MoE (mixtral)
    mamba       Mamba2 SSD block (no separate MLP)
    rwkv        RWKV6 time-mix + channel-mix

An unknown kind raises ``ValueError``, as in the JAX package.

`cfg.encoder_layers` (whisper): an encoder of that many ``attn_nc``
blocks runs over the memory (stub frame embeddings) before the decoder
stack, which attends to its output; without an encoder the memory goes
to the cross-attention as it is, cast to the compute dtype.

`cfg.shared_attn` (zamba2): one *shared* attention block (weights outside
the groups) is applied at the start of every group; its KV caches are
per group.

Parameters for each pattern position are stacked over groups, as in the
JAX package (``groups/b{i}`` leaves of shape (num_groups, ...)). Where
the JAX package scans over that axis, the port loops over it in Python,
indexing each leaf. With ``cfg.remat``, where autograd records, each
group's body (and each encoder layer) runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, where
the JAX package wraps its scan bodies in ``jax.checkpoint``: backward
recomputes the body's forward, kernels included, instead of keeping its
activations. The MoE blocks' load-balance losses are summed over the
stack as the JAX package sums them: per group, then over the groups.

`distill_loss` is the trainer's loss: float32 cross-entropy of the
logits against the labels plus ``router_aux_weight`` times the aux
loss.

Caches: attention blocks keep K/V, cross-attention blocks the memory's
K/V (``xk``, ``xv``: computed once at prefill, only read in decode, never
in a ring), a Mamba2 block its SSM state and the last conv inputs, an
RWKV6 block its wkv state and the last normed inputs of its time- and
channel-mix (`cache_dtype`: the recurrent states in float32, the rest in
the model dtype). `prefill` hands the chunked
scans' final states to decode; `decode_step` writes every cache in place.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import spmd, tree
from repro_torch.core import timing
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
from repro_torch.models.ssm import mamba2, rwkv6

DENSE_KINDS = ("attn", "attn_local", "attn_nc")
MOE_KINDS = ("moe", "moe_local")
ATTN_KINDS = DENSE_KINDS + MOE_KINDS
RECURRENT_KINDS = ("mamba", "rwkv")


# ---------------------------------------------------------------------------
# Metas
# ---------------------------------------------------------------------------


def block_metas(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    if kind == "mamba":
        return {"ln1": norm_meta(d), "mamba": mamba2.mamba2_metas(cfg)}
    if kind == "rwkv":
        return {"ln1": norm_meta(d), "ln2": norm_meta(d), "rwkv": rwkv6.rwkv6_metas(cfg)}
    if kind == "xattn":
        return {"ln1": norm_meta(d), "xattn": attn.attn_metas(cfg),
                "ln2": norm_meta(d), "mlp": mlp_metas(cfg),
                "gate": ParamMeta((1,), ("unsharded",), init="zeros")}
    if kind == "attn_xattn":
        return {"ln1": norm_meta(d), "attn": attn.attn_metas(cfg),
                "lnx": norm_meta(d), "xattn": attn.attn_metas(cfg),
                "ln2": norm_meta(d), "mlp": mlp_metas(cfg)}
    if kind in ATTN_KINDS:
        m = {"ln1": norm_meta(d), "attn": attn.attn_metas(cfg), "ln2": norm_meta(d)}
        if kind in MOE_KINDS:
            m["moe"] = moe_mod.moe_metas(cfg)
        else:
            m["mlp"] = mlp_metas(cfg)
        if cfg.post_norm:
            m["ln1_post"] = norm_meta(d)
            m["ln2_post"] = norm_meta(d)
        return m
    raise ValueError(f"unknown block kind {kind}")


def model_metas(cfg: ModelConfig) -> dict:
    groups = {
        f"b{i}": stack_group(block_metas(cfg, kind), cfg.num_groups)
        for i, kind in enumerate(cfg.pattern)
    }
    m = {"embed": embed_metas(cfg), "groups": groups,
         "final_norm": norm_meta(cfg.d_model)}
    if cfg.shared_attn:  # drawn once, outside the groups
        d = cfg.d_model
        m["shared_attn"] = {"ln1": norm_meta(d), "attn": attn.attn_metas(cfg),
                            "ln2": norm_meta(d), "mlp": mlp_metas(cfg)}
    if cfg.encoder_layers:
        m["encoder"] = {
            "groups": {"b0": stack_group(block_metas(cfg, "attn_nc"), cfg.encoder_layers)},
            "final_norm": norm_meta(cfg.d_model),
        }
    return m


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


def _no_aux(x):
    return spmd.like(torch.zeros((), dtype=torch.float32, device=x.device), x)


def _gate(p: dict, x):
    """An ``xattn`` block's output scale: tanh(gate) in float32, cast to
    x's dtype (0 at init, so the block starts as its MLP alone)."""
    return torch.tanh(p["gate"].to(torch.float32)).to(x.dtype)


def _cross_cache(cfg: ModelConfig, p: dict, memory) -> dict:
    xc = attn.precompute_cross_cache(cfg, p["xattn"], memory)
    return {"xk": xc["k"], "xv": xc["v"]}


def block_apply(cfg: ModelConfig, kind: str, p: dict, x, *, positions, memory=None,
                want_cache: bool = False):
    """Returns (x, aux_loss, cache_or_None). ``memory`` (B, Sm, d) feeds
    the cross-attention blocks."""
    if kind == "xattn":
        h = apply_norm(cfg, x, p["ln1"])
        x = x + _gate(p, x) * attn.cross_attention(cfg, p["xattn"], h, memory)
        h = apply_norm(cfg, x, p["ln2"])
        x = x + mlp_apply(cfg, p["mlp"], h)
        return x, _no_aux(x), (_cross_cache(cfg, p, memory) if want_cache else None)
    if kind == "attn_xattn":
        h = apply_norm(cfg, x, p["ln1"])
        out, kv = attn.self_attention(cfg, p["attn"], h, window=0, positions=positions)
        x = x + out
        h = apply_norm(cfg, x, p["lnx"])
        x = x + attn.cross_attention(cfg, p["xattn"], h, memory)
        h = apply_norm(cfg, x, p["ln2"])
        x = x + mlp_apply(cfg, p["mlp"], h)
        cache = ({"k": kv[0], "v": kv[1], **_cross_cache(cfg, p, memory)}
                 if want_cache else None)
        return x, _no_aux(x), cache
    if kind == "mamba":
        h = apply_norm(cfg, x, p["ln1"])
        if want_cache:
            out, st = mamba2.mamba2_apply(cfg, p["mamba"], h, want_state=True)
            return x + out, _no_aux(x), st
        return x + mamba2.mamba2_apply(cfg, p["mamba"], h), _no_aux(x), None
    if kind == "rwkv":
        h1 = apply_norm(cfg, x, p["ln1"])
        if want_cache:
            out, wkv = rwkv6.rwkv6_time_mix(cfg, p["rwkv"]["tm"], h1, want_state=True)
        else:
            out, wkv = rwkv6.rwkv6_time_mix(cfg, p["rwkv"]["tm"], h1), None
        x = x + out
        h2 = apply_norm(cfg, x, p["ln2"])
        x = x + rwkv6.rwkv6_channel_mix(cfg, p["rwkv"]["cm"], h2)
        cache = (
            {"wkv": wkv, "tm_last": h1[:, -1], "cm_last": h2[:, -1]} if want_cache else None
        )
        return x, _no_aux(x), cache
    if kind not in ATTN_KINDS:
        raise ValueError(f"unknown block kind {kind}")
    x, cache = _attn_sub(cfg, p, x, kind, positions, want_cache)
    h = apply_norm(cfg, x, p["ln2"])
    out, aux = _ffn(cfg, kind, p, h)
    if cfg.post_norm:
        out = apply_norm(cfg, out, p["ln2_post"])
    return x + out, (_no_aux(x) if aux is None else aux), cache


def _shared_attn_apply(cfg: ModelConfig, sp: dict, x, positions):
    """The shared attention + MLP block over the full sequence. Returns
    (x, (k, v)): its K/V feed the group's prefill cache."""
    h = apply_norm(cfg, x, sp["ln1"])
    out, kv = attn.self_attention(cfg, sp["attn"], h, window=cfg.window_size,
                                  positions=positions)
    x = x + out
    h = apply_norm(cfg, x, sp["ln2"])
    return x + mlp_apply(cfg, sp["mlp"], h), kv


def group_params(params: dict, g: int) -> dict:
    """Group ``g``'s block params: every stacked ``groups`` leaf indexed at
    g (views, no copy)."""
    return tree.tree_map(lambda l: l[g], params["groups"])


def _remat(cfg: ModelConfig, params, body, x):
    """``body(x)``, under activation checkpointing where ``cfg.remat`` asks
    for it and autograd records (grad mode on, and x or a leaf of
    ``params`` requires grad); serving runs the body as it is."""
    if cfg.remat and torch.is_grad_enabled() and (
            x.requires_grad or any(l.requires_grad for l in tree.leaves(params))):
        return checkpoint(body, x, use_reentrant=False)
    return body(x)


def _group_body(cfg: ModelConfig, shared, gp: dict, x, *, positions, memory):
    """One group: the shared attention block (where the config has one),
    then the pattern's blocks. Returns (x, the blocks' aux losses
    summed)."""
    aux = _no_aux(x)
    gp = spmd.at_use(gp, "groups")  # inside the body: a recompute uses them again
    if shared is not None:
        x, _ = _shared_attn_apply(cfg, spmd.at_use(shared, "shared_attn"), x, positions)
    for i, kind in enumerate(cfg.pattern):
        x, a, _ = block_apply(cfg, kind, gp[f"b{i}"], x, positions=positions,
                              memory=memory)
        aux = aux + a
    return x, aux


def _stack_forward(cfg: ModelConfig, params: dict, x, positions, memory=None):
    """Decoder trunk (no embed/unembed). Returns (x, total_aux): each
    group's blocks' aux losses summed, then the groups' sums."""
    auxs = []
    shared = params.get("shared_attn")
    for g in range(cfg.num_groups):
        gp = group_params(params, g)
        body = functools.partial(_group_body, cfg, shared, gp, positions=positions,
                                 memory=memory)
        x, aux = _remat(cfg, gp if shared is None else (gp, shared), body, x)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


def _positions(B: int, S: int, ref):
    """(B, S) positions 0..S-1 on ``ref``'s device (replicated over its
    mesh where ``ref`` is a DTensor)."""
    return spmd.like(torch.arange(S, device=ref.device).expand(B, S), ref)


def encode(cfg: ModelConfig, params: dict, frames):
    """Whisper-style encoder over stub frame embeddings (B, Sf, d): the
    ``attn_nc`` blocks, then the encoder's final norm. No positions are
    added to the frames: the blocks apply rope only when ``pos == "rope"``,
    as the JAX package's do. One ``transformer.encode`` span
    (`core.timing.span`)."""
    with timing.span("transformer.encode"):
        enc = params["encoder"]
        positions = _positions(frames.shape[0], frames.shape[1], frames)
        x = frames.to(cfg.cdtype)
        for layer in range(cfg.encoder_layers):
            p = group_params(enc, layer)["b0"]

            def body(h, p=p):
                return block_apply(cfg, "attn_nc", spmd.at_use(p, "encoder"), h,
                                   positions=positions)[0]
            x = _remat(cfg, p, body, x)
        return apply_norm(cfg, x, enc["final_norm"])


def _memory(cfg: ModelConfig, params: dict, memory):
    """The cross-attention blocks' memory: encoded where the model has an
    encoder, else cast to the compute dtype; None stays None."""
    if memory is None:
        return None
    if cfg.encoder_layers:
        return encode(cfg, params, memory)
    return memory.to(cfg.cdtype)


def forward(cfg: ModelConfig, params: dict, tokens, memory=None):
    """tokens: (B,S) int; memory: (B,Sm,d) stub embeddings (vlm/audio).
    Returns (logits (B,S,V), aux): aux is the MoE load-balance loss summed
    over the stack (0 for dense stacks)."""
    B, S = tokens.shape
    positions = _positions(B, S, tokens)
    memory = _memory(cfg, params, memory)
    x = embed_apply(cfg, spmd.at_use(params["embed"], "embed"), tokens, positions)
    x, aux = _stack_forward(cfg, params, x, positions, memory)
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed_apply(cfg, spmd.at_use(params["embed"], "embed"), x), aux


def distill_loss(cfg: ModelConfig, params: dict, batch: dict):
    """Token-level knowledge-distillation loss (the JAX package's
    `distill_loss`): cross-entropy of the student's float32 logits
    against the teacher's hard labels, plus ``router_aux_weight`` times
    the MoE load-balance aux loss. batch: {tokens, labels[, memory]}.
    Returns (loss, {"ce": ce, "aux": aux})."""
    logits, aux = forward(cfg, params, batch["tokens"], batch.get("memory"))
    logits = logits.to(torch.float32)
    lse = spmd.logsumexp(logits, dim=-1)
    # the label's logit keeps its trailing axis: a vocab-sharded DTensor
    # gather leaves a masked partial sum that must be reduced at that rank
    lab = torch.gather(logits, -1, batch["labels"][..., None].long())
    ce = (lse[..., None] - lab).mean()
    loss = ce + cfg.router_aux_weight * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# KV / state caches
# ---------------------------------------------------------------------------


def ring_len(cfg: ModelConfig, kind: str, seq: int) -> int:
    """Self-attention cache length for a block (``kind`` "shared" for the
    shared attention block): the full seq, or the ring size min(seq,
    window) under the ring-cache option."""
    if not cfg.decode_window_slicing:
        return seq
    if kind in ("attn_local", "moe_local") and cfg.window_size:
        w = cfg.window_size
    elif kind == "shared":
        w = cfg.window_size or cfg.attn_window_override
    else:
        w = cfg.attn_window_override
    return min(seq, w) if w else seq


def cache_metas(cfg: ModelConfig, batch: int, seq: int, mem_len: int = 0) -> dict:
    """ParamMeta tree describing the decode cache (shapes and the JAX
    package's logical axes), each leaf stacked over the groups: k and v
    (num_groups, batch, R, KV, hd) for an attention block (and under
    ``shared`` for the shared attention block); xk and xv (num_groups,
    batch, mem_len, KV, hd) for a cross-attention block (with k and v for
    ``attn_xattn``); ssm, conv_x and conv_bc for a Mamba2 block; wkv,
    tm_last and cm_last for an RWKV6 block. Self-attention caches put
    their positions on "cache_seq", the memory's on "mem_seq" (odd
    lengths, 1,601 or 1,500: never sharded)."""
    kv, hd, G = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_groups

    def meta(shape, axes):
        return ParamMeta((G, batch) + shape, ("layers", "batch") + axes, init="zeros")

    def kv_meta(length, seq_ax="cache_seq"):
        return meta((length, kv, hd), (seq_ax, "kv_heads", "unsharded"))

    caches = {}
    for i, kind in enumerate(cfg.pattern):
        if kind in ATTN_KINDS:
            r = ring_len(cfg, kind, seq)
            caches[f"b{i}"] = {"k": kv_meta(r), "v": kv_meta(r)}
        elif kind == "xattn":
            caches[f"b{i}"] = {"xk": kv_meta(mem_len, "mem_seq"),
                               "xv": kv_meta(mem_len, "mem_seq")}
        elif kind == "attn_xattn":
            r = ring_len(cfg, kind, seq)
            caches[f"b{i}"] = {"k": kv_meta(r), "v": kv_meta(r),
                               "xk": kv_meta(mem_len, "mem_seq"),
                               "xv": kv_meta(mem_len, "mem_seq")}
        elif kind == "mamba":
            d_inner, H, P, N = mamba2._dims(cfg)
            caches[f"b{i}"] = {
                "ssm": meta((H, P, N), ("unsharded",) * 3),
                "conv_x": meta((cfg.ssm_conv - 1, d_inner), ("unsharded", "ff")),
                "conv_bc": meta((cfg.ssm_conv - 1, 2 * N), ("unsharded", "unsharded"))}
        elif kind == "rwkv":
            H, P = rwkv6._dims(cfg)
            caches[f"b{i}"] = {"wkv": meta((H, P, P), ("unsharded",) * 3),
                               "tm_last": meta((cfg.d_model,), ("embed",)),
                               "cm_last": meta((cfg.d_model,), ("embed",))}
    if cfg.shared_attn:
        r = ring_len(cfg, "shared", seq)
        caches["shared"] = {"k": kv_meta(r), "v": kv_meta(r)}
    return caches


def cache_dtype(path_key: str, default_dtype):
    """SSM/wkv recurrent states stay float32; K/V, conv taps and the
    RWKV token-shift carries use the model dtype."""
    return torch.float32 if path_key in ("ssm", "wkv") else default_dtype


def init_cache(cfg: ModelConfig, batch: int, seq: int, mem_len: int = 0, dtype=None,
               device="cuda"):
    dtype = dtype or cfg.cdtype
    return {b: {key: torch.zeros(m.shape, dtype=cache_dtype(key, dtype), device=device)
                for key, m in c.items()}
            for b, c in cache_metas(cfg, batch, seq, mem_len).items()}


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def block_decode(cfg: ModelConfig, kind: str, p: dict, x, cache, pos: int):
    """One-token decode for a single block. Returns (x, new cache): an
    attention block's cache is the one given, its K/V written in place
    (a cross-attention block's memory K/V only read); a recurrent block's
    holds new tensors (the caller writes them back)."""
    if kind == "mamba":
        h = apply_norm(cfg, x, p["ln1"])
        out, new_cache = mamba2.mamba2_decode(cfg, p["mamba"], h, cache)
        return x + out, new_cache
    if kind == "rwkv":
        h = apply_norm(cfg, x, p["ln1"])
        out, new_cache = rwkv6.rwkv6_decode(cfg, p["rwkv"], h, cache)
        x = x + out
        h = apply_norm(cfg, x, p["ln2"])
        out = rwkv6.rwkv6_channel_mix(cfg, p["rwkv"]["cm"], h, last=cache["cm_last"])
        return x + out, dict(new_cache, cm_last=h[:, 0])
    if kind == "xattn":
        h = apply_norm(cfg, x, p["ln1"])
        out = attn.decode_cross_attention(cfg, p["xattn"], h,
                                          {"k": cache["xk"], "v": cache["xv"]})
        x = x + _gate(p, x) * out
        h = apply_norm(cfg, x, p["ln2"])
        return x + mlp_apply(cfg, p["mlp"], h), cache
    if kind == "attn_xattn":
        h = apply_norm(cfg, x, p["ln1"])
        out, _ = attn.decode_self_attention(cfg, p["attn"], h, cache, pos, window=0)
        x = x + out
        h = apply_norm(cfg, x, p["lnx"])
        x = x + attn.decode_cross_attention(cfg, p["xattn"], h,
                                            {"k": cache["xk"], "v": cache["xv"]})
        h = apply_norm(cfg, x, p["ln2"])
        return x + mlp_apply(cfg, p["mlp"], h), cache
    if kind not in ("attn", "attn_local") + MOE_KINDS:
        raise ValueError(f"unknown block kind {kind}")
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


def _shared_attn_decode(cfg: ModelConfig, sp: dict, x, cache, pos: int):
    """One token through the shared attention + MLP block, against its
    group's K/V ``cache`` (written in place)."""
    h = apply_norm(cfg, x, sp["ln1"])
    out, _ = attn.decode_self_attention(cfg, sp["attn"], h, cache, pos,
                                        window=cfg.window_size)
    x = x + out
    h = apply_norm(cfg, x, sp["ln2"])
    return x + mlp_apply(cfg, sp["mlp"], h)


def _group_cache(c: dict, g: int) -> dict:
    """Group g's slice of every leaf of a block's cache (views)."""
    return {k: v[g] for k, v in c.items()}


def decode_step(cfg: ModelConfig, params: dict, caches: dict, tokens, pos: int):
    """serve_step: one new token against a cache of `seq` positions.
    tokens: (B,1) int; pos: int. Returns (logits (B,1,V), caches), the
    caches written in place."""
    B = tokens.shape[0]
    positions = spmd.like(torch.full((B, 1), pos, dtype=torch.int32, device=tokens.device),
                          tokens)
    x = embed_apply(cfg, spmd.at_use(params["embed"], "embed"), tokens, positions)
    shared = params.get("shared_attn")
    for g in range(cfg.num_groups):
        gp = spmd.at_use(group_params(params, g), "groups")
        if shared is not None:
            x = _shared_attn_decode(cfg, spmd.at_use(shared, "shared_attn"), x,
                                    _group_cache(caches["shared"], g), pos)
        for i, kind in enumerate(cfg.pattern):
            view = _group_cache(caches[f"b{i}"], g)
            x, new = block_decode(cfg, kind, gp[f"b{i}"], x, view, pos)
            for k, t in new.items():
                if t is not view[k]:
                    view[k].copy_(t)
    x = apply_norm(cfg, x, params["final_norm"])
    return unembed_apply(cfg, spmd.at_use(params["embed"], "embed"), x), caches


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


def _store(cfg: ModelConfig, caches: dict, key: str, kind: str, c: dict, g: int,
           cache_len: int):
    """Write group g's prefill cache ``c`` of block ``key`` into
    ``caches``, allocating each leaf at its final (num_groups, ...) size
    on first sight: K/V laid out for decode by `to_ring`, the memory's
    K/V and the recurrent states (the chunked scans' final states and the
    last inputs) as they come, in the dtype they come in."""
    out = caches.setdefault(key, {})
    for k, t in c.items():
        ring = k in ("k", "v")
        if k not in out:
            shape = ((t.shape[0], ring_len(cfg, kind, cache_len)) + tuple(t.shape[2:])
                     if ring else tuple(t.shape))
            # a DTensor's cache is placed as its first group's value is
            place = (spmd.operand(t, range(t.ndim), {d: d + 1 for d in range(t.ndim)})[0]
                     if spmd.is_dtensor(t) else None)
            out[k] = spmd.zeros((cfg.num_groups,) + shape, t.dtype, t, place)
        if ring:
            to_ring(t, out[k][g])
        else:
            out[k][g].copy_(t)


def prefill(cfg: ModelConfig, params: dict, tokens, cache_len: int, memory=None):
    """Run the full prompt, returning (logits of the last position (B,1,V),
    caches sized cache_len). Each block's prompt K/V (and the memory's, for
    a cross-attention block), and each recurrent block's final state, is
    written into a cache allocated once at its final size (the JAX package
    stacks them, then pads or rolls)."""
    B, S = tokens.shape
    positions = _positions(B, S, tokens)
    memory = _memory(cfg, params, memory)
    x = embed_apply(cfg, spmd.at_use(params["embed"], "embed"), tokens, positions)
    shared = params.get("shared_attn")
    caches = {}
    for g in range(cfg.num_groups):
        gp = spmd.at_use(group_params(params, g), "groups")
        if shared is not None:
            x, kv = _shared_attn_apply(cfg, spmd.at_use(shared, "shared_attn"), x,
                                       positions)
            _store(cfg, caches, "shared", "shared", {"k": kv[0], "v": kv[1]}, g, cache_len)
        for i, kind in enumerate(cfg.pattern):
            x, _, c = block_apply(cfg, kind, gp[f"b{i}"], x, positions=positions,
                                  memory=memory, want_cache=True)
            _store(cfg, caches, f"b{i}", kind, c, g, cache_len)
    x = apply_norm(cfg, x, params["final_norm"])
    logits = unembed_apply(cfg, spmd.at_use(params["embed"], "embed"), x[:, -1:])
    return logits, caches
