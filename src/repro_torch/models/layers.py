"""Primitive layers: norms, rotary and sinusoidal positions, MLPs,
embedding/unembedding (the JAX package's `models/layers.py`).

Convention: every norm stores its scale as an *offset* w with effective
scale (1 + w) (zeros-init). RMSNorm goes through the hand-written kernel
(`repro_torch.kernels.rmsnorm`) on the card and its plain version on the
CPU; LayerNorm stays plain.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import spmd
from repro_torch.kernels.rmsnorm.ops import rms_norm as _rms_norm_kernel
from repro_torch.models.common import ModelConfig, ParamMeta, dense_meta

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps=1e-6):
    return _rms_norm_kernel(x, w, eps)


def layer_norm(x, w, eps=1e-5):
    """LayerNorm with scale (1 + w), in float32, in x's dtype. A DTensor x
    is normed on its local rows (`spmd.local`), d_model whole, as
    `kernels.rmsnorm.ops.rms_norm` norms it."""
    if spmd.is_dtensor(x):
        rows = range(x.ndim - 1)
        (px, gx), (pw, gw) = spmd.operand(x, rows), spmd.operand(x, rows, {})
        return spmd.local(lambda a, b: layer_norm(a, b, eps), px, (px, pw), (gx, gw))(x, w)
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
    return out.to(dt)


def apply_norm(cfg: ModelConfig, x, w):
    return rms_norm(x, w) if cfg.norm == "rms" else layer_norm(x, w)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x: (B, seq, *head_dims, head_dim); positions: (B, seq). Rotates
    halves (not interleaved pairs), in float32, cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = spmd.like(rope_freqs(hd, theta, x.device), x)  # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, seq, hd/2)
    expand = (slice(None), slice(None)) + (None,) * (x.dim() - 3) + (slice(None),)
    cos = torch.cos(ang)[expand]  # (B, seq, 1..., hd/2)
    sin = torch.sin(ang)[expand]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Softcap
# ---------------------------------------------------------------------------


def softcap(x, cap: float):
    if not cap:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _gated(cfg: ModelConfig) -> bool:
    return cfg.mlp_act in ("swiglu", "geglu")


def mlp_metas(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, (d_ff or cfg.d_ff)
    if _gated(cfg):
        return {"wg": dense_meta(d, ff, "embed", "ff"), "wu": dense_meta(d, ff, "embed", "ff"),
                "wd": dense_meta(ff, d, "ff", "embed")}
    # plain gelu (whisper)
    return {"wu": dense_meta(d, ff, "embed", "ff"), "wd": dense_meta(ff, d, "ff", "embed")}


def glu_act(cfg: ModelConfig, g):
    """The gate's activation: SiLU for SwiGLU, tanh-approximated GELU for
    GeGLU."""
    return F.silu(g) if cfg.mlp_act == "swiglu" else F.gelu(g, approximate="tanh")


def mlp_apply(cfg: ModelConfig, p: dict, x):
    """The gated MLP, act(x @ wg) * (x @ wu) @ wd, or the plain one,
    gelu(x @ wu) @ wd, with the tanh-approximated GELU as in the JAX
    package (torch's default erf form differs by up to ~1e-3)."""
    if _gated(cfg):
        return (glu_act(cfg, x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    return F.gelu(x @ p["wu"], approximate="tanh") @ p["wd"]


# ---------------------------------------------------------------------------
# Embedding / unembedding (tied)
# ---------------------------------------------------------------------------


def sinusoidal_pos(positions, d_model: int, dtype=torch.float32):
    """The classic sinusoidal encoding, [sin, cos] concatenated; positions:
    (..., seq). The frequency denominator is max(half - 1, 1), as in the
    JAX package."""
    half = d_model // 2
    freqs = spmd.like(torch.exp(-torch.arange(half, dtype=torch.float32,
                                              device=positions.device)
                                * (math.log(10000.0) / max(half - 1, 1))), positions)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def embed_metas(cfg: ModelConfig) -> dict:
    m = {"tok": ParamMeta((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          init="embed")}
    if cfg.pos == "learned":
        m["pos"] = ParamMeta((cfg.max_position, cfg.d_model), ("unsharded", "embed"),
                             init="embed")
    return m


def embed_apply(cfg: ModelConfig, p: dict, tokens, positions=None):
    """Token embedding, plus learned or sinusoidal positions where the
    config has them (RoPE enters in attention instead)."""
    # a DTensor table goes through F.embedding, whose sharding rules
    # DTensor keeps for every torch (indexing's backward has none on some)
    x = (spmd.embedding(tokens, p["tok"]) if spmd.is_dtensor(tokens)
         else p["tok"][tokens]).to(cfg.cdtype)
    if cfg.embed_scale:
        # the scale is rounded to the compute dtype first, as the JAX
        # package does (sqrt(3584) is 60.0 in bf16, not 59.87)
        x = x * spmd.like(torch.tensor(cfg.d_model**0.5, dtype=cfg.cdtype, device=x.device),
                          x)
    if cfg.pos == "learned":
        x = x + p["pos"][positions].to(cfg.cdtype)
    elif cfg.pos == "sinusoidal":
        x = x + sinusoidal_pos(positions, cfg.d_model, cfg.cdtype)
    return x


def unembed_apply(cfg: ModelConfig, p: dict, x):
    logits = x @ p["tok"].T.to(cfg.cdtype)
    return softcap(logits, cfg.final_logit_softcap)
