"""Analytic FLOP and byte model per (architecture x input shape) (the JAX
package's `roofline/analytic.py`, term for term, so that both packages
give the same numbers for a config).

``analytic_cost(cfg, ShapeSpec(kind, seq_len, global_batch))`` returns
the FLOPs and HBM bytes of one train, prefill or decode step over all
devices, and the model FLOPs (2 or 6 x active parameters x tokens) that
an MFU divides by. The counts follow the JAX package's implementation:
attention counts the full S^2 score term of every (q, kv) block, where
the port's flash-attention kernel skips the masked ones; MoE counts
``capacity_factor`` times the routed experts' products; decode counts
the routed experts that ``B * k`` tokens can touch, not the whole
(E, cap, d) products that the dispatch computes (PERF.md §7).

Parameter counts come from the port's `model_metas`. An unknown block
kind raises ``ValueError``, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.common import ModelConfig, param_count
from repro_torch.models.transformer import model_metas


def _glu_flops(d, ff):
    return 6 * d * ff  # wg + wu + wd matmuls, 2mnk each


def _mlp_flops(cfg: ModelConfig, d, ff):
    return _glu_flops(d, ff) if cfg.mlp_act in ("swiglu", "geglu") else 4 * d * ff


def _attn_proj_flops(cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    return 2 * d * H * hd + 2 * 2 * d * KV * hd + 2 * H * hd * d


def _attn_score_flops(cfg: ModelConfig, ctx: int):
    """Per query token against `ctx` keys (qk^T + pv)."""
    return 2 * 2 * cfg.num_heads * cfg.resolved_head_dim * ctx


def _moe_flops(cfg: ModelConfig):
    d = cfg.d_model
    routed = _glu_flops(d, cfg.expert_d_ff) * cfg.experts_per_token * cfg.capacity_factor
    shared = _glu_flops(d, cfg.num_shared_experts * cfg.expert_d_ff) if cfg.num_shared_experts else 0
    return 2 * d * cfg.num_experts + routed + shared


def _mamba_flops(cfg: ModelConfig):
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    H = d_inner // cfg.ssm_head_dim
    P, N, Lc = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
    proj = 2 * d * (2 * d_inner + 2 * N + H) + 2 * d_inner * d
    conv = 2 * cfg.ssm_conv * (d_inner + 2 * N)
    # per token: intra-chunk (G-matrix, y_intra) + state path
    intra = 2 * Lc * N + 2 * Lc * H * P * 2
    state = 3 * 2 * H * P * N
    return proj + conv + intra + state


def _rwkv_flops(cfg: ModelConfig):
    d = cfg.d_model
    P = cfg.ssm_head_dim
    H = d // P
    Lc = 64
    proj = 5 * 2 * d * d + 2 * 2 * d * 32  # r,k,v,g,o + decay lora
    wkv = 2 * Lc * H * P * 3 + 2 * 2 * H * P * P
    cmix = 2 * 2 * d * cfg.d_ff
    return proj + wkv + cmix


def _decode_ctx(cfg: ModelConfig, kind: str, S: int) -> int:
    """Effective attended context per decode step for a block kind (reflects
    the window-slicing optimization when enabled)."""
    if not cfg.decode_window_slicing:
        return S
    if kind in ("attn_local", "moe_local") and cfg.window_size:
        return min(S, cfg.window_size)
    if cfg.attn_window_override:
        return min(S, cfg.attn_window_override)
    return S


def _block_flops(cfg: ModelConfig, kind: str, ctx: int, mem_len: int):
    d = cfg.d_model
    if kind in ("attn", "attn_local", "attn_nc"):
        return _attn_proj_flops(cfg) + _attn_score_flops(cfg, ctx) + _mlp_flops(cfg, d, cfg.d_ff)
    if kind in ("moe", "moe_local"):
        return _attn_proj_flops(cfg) + _attn_score_flops(cfg, ctx) + _moe_flops(cfg)
    if kind == "xattn":
        return _attn_proj_flops(cfg) + _attn_score_flops(cfg, mem_len) + _mlp_flops(cfg, d, cfg.d_ff)
    if kind == "attn_xattn":
        return (2 * _attn_proj_flops(cfg) + _attn_score_flops(cfg, ctx)
                + _attn_score_flops(cfg, mem_len) + _mlp_flops(cfg, d, cfg.d_ff))
    if kind == "mamba":
        return _mamba_flops(cfg)
    if kind == "rwkv":
        return _rwkv_flops(cfg)
    raise ValueError(kind)


@dataclass(frozen=True)
class ShapeSpec:
    kind: str  # train | prefill | decode | decode_long
    seq_len: int
    global_batch: int


def analytic_cost(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    """Global (all-chip) FLOPs and HBM bytes for one step."""
    B, S = spec.global_batch, spec.seq_len
    decode = spec.kind in ("decode", "decode_long")
    n_q = B * (1 if decode else S)  # query tokens this step
    mem = cfg.num_xattn_tokens

    def ctx_for(kind):
        # the jnp path computes the full (masked) context except where the
        # decode window-slicing optimization is enabled
        return _decode_ctx(cfg, kind, S) if decode else S

    per_tok = sum(_block_flops(cfg, k, ctx_for(k), mem) for k in cfg.pattern) * cfg.num_groups
    if cfg.shared_attn:
        shared_ctx = ctx_for("attn_local" if cfg.window_size else "attn")
        per_tok += (_attn_proj_flops(cfg) + _attn_score_flops(cfg, shared_ctx)
                    + _mlp_flops(cfg, cfg.d_model, cfg.d_ff)) * cfg.num_groups
    head = 2 * cfg.d_model * cfg.vocab_size  # unembed per evaluated position

    # encoder (whisper): runs over mem tokens, full self-attention
    enc = 0.0
    if cfg.encoder_layers and mem:
        enc_tok = (_attn_proj_flops(cfg) + _attn_score_flops(cfg, mem)
                   + _mlp_flops(cfg, cfg.d_model, cfg.d_ff)) * cfg.encoder_layers
        enc = enc_tok * B * mem

    pc = param_count(model_metas(cfg))
    pbytes = pc * cfg.pdtype.itemsize

    if spec.kind == "train":
        fwd = per_tok * n_q + head * n_q + enc
        mult = 4.0 if cfg.remat else 3.0  # fwd + (recompute) + bwd(2x)
        flops = fwd * mult + 10.0 * pc  # + optimizer elementwise
        act_bytes = cfg.num_layers * n_q * cfg.d_model * 2 * 12  # ~12 tensors r/w per layer
        opt_bytes = pc * (2 + 2 + 4 + 4 + 4 + 4 + 4 + 1)  # p rw bf16, m rw? v rw fp32, u w, g r, mask
        wbytes = pbytes * 3  # fwd read + bwd re-read + grad write
        byt = wbytes + opt_bytes + act_bytes
        useful = 6.0 * _active_params(cfg) * n_q
    elif spec.kind == "prefill":
        flops = per_tok * n_q + head * B + enc
        kv_bytes = _cache_bytes(cfg, B, S, mem)
        byt = pbytes + kv_bytes + cfg.num_layers * n_q * cfg.d_model * 2 * 8
        useful = 2.0 * _active_params(cfg) * n_q
    else:  # decode
        flops = per_tok * n_q + head * n_q + (enc if False else 0.0)
        touched = _decode_touched_params(cfg, B) * cfg.pdtype.itemsize
        byt = (touched + _cache_read_bytes(cfg, B, S, mem)
               + n_q * cfg.d_model * 2 * 8 * cfg.num_layers)
        useful = 2.0 * _active_params(cfg) * n_q
    return {"flops": float(flops), "bytes": float(byt), "model_flops": float(useful)}


def _active_params(cfg: ModelConfig) -> float:
    """Per-token active parameters (MoE: only routed top-k + shared)."""
    pc = param_count(model_metas(cfg))
    if not cfg.num_experts:
        return pc
    n_moe_layers = sum(1 for k in cfg.pattern if k.startswith("moe")) * cfg.num_groups
    d, eff = cfg.d_model, cfg.expert_d_ff
    expert_pc = 3 * d * eff * cfg.num_experts  # routed experts only
    active_expert = 3 * d * eff * cfg.experts_per_token
    return pc - n_moe_layers * expert_pc + n_moe_layers * active_expert


def _decode_touched_params(cfg: ModelConfig, batch: int) -> float:
    pc = param_count(model_metas(cfg))
    if not cfg.num_experts:
        return pc
    d, eff, E = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    n_moe_layers = sum(1 for k in cfg.pattern if k.startswith("moe")) * cfg.num_groups
    expert_pc = 3 * d * eff * E
    frac = min(1.0, batch * cfg.experts_per_token / E)
    return pc - n_moe_layers * expert_pc * (1 - frac)


def _cache_read_bytes(cfg: ModelConfig, B: int, S: int, mem: int) -> float:
    """Per-decode-step cache traffic: reads of the attended window (plus the
    one-slot write, negligible). Honors decode window slicing."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    total = 0.0
    for k in cfg.pattern:
        if k in ("attn", "attn_local", "attn_nc", "moe", "moe_local"):
            total += 2 * B * _decode_ctx(cfg, k, S) * kv * hd * 2
        elif k == "xattn":
            total += 2 * B * mem * kv * hd * 2
        elif k == "attn_xattn":
            total += 2 * B * (_decode_ctx(cfg, k, S) + mem) * kv * hd * 2
        elif k == "mamba":
            d_inner = cfg.ssm_expand * cfg.d_model
            H = d_inner // cfg.ssm_head_dim
            total += 2 * B * H * cfg.ssm_head_dim * cfg.ssm_state * 4
        elif k == "rwkv":
            H = cfg.d_model // cfg.ssm_head_dim
            total += 2 * B * H * cfg.ssm_head_dim**2 * 4
    total *= cfg.num_groups
    if cfg.shared_attn:
        ctx = _decode_ctx(cfg, "attn_local" if cfg.window_size else "attn", S)
        total += cfg.num_groups * 2 * B * ctx * kv * hd * 2
    return total


def _cache_bytes(cfg: ModelConfig, B: int, S: int, mem: int) -> float:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    total = 0.0
    for k in cfg.pattern:
        if k in ("attn", "attn_local", "attn_nc", "moe", "moe_local"):
            total += 2 * B * S * kv * hd * 2
        elif k == "xattn":
            total += 2 * B * mem * kv * hd * 2
        elif k == "attn_xattn":
            total += 2 * B * (S + mem) * kv * hd * 2
        elif k == "mamba":
            d_inner = cfg.ssm_expand * cfg.d_model
            H = d_inner // cfg.ssm_head_dim
            total += B * H * cfg.ssm_head_dim * cfg.ssm_state * 4
        elif k == "rwkv":
            H = cfg.d_model // cfg.ssm_head_dim
            total += B * H * cfg.ssm_head_dim**2 * 4
    total *= cfg.num_groups
    if cfg.shared_attn:
        total += cfg.num_groups * 2 * B * S * kv * hd * 2
    return total
