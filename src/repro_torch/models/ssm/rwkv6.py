"""RWKV-6 "Finch" block: time-mix with data-dependent decay + channel-mix
(the JAX package's `models/ssm/rwkv6.py`).

The per-channel decay w_t is a function of the input (a LoRA bottleneck
on the token-shifted mix); the wkv state is a per-head (P x P) matrix:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)

As in the JAX package, the token-shift coefficients are static learned
vectors. The full-sequence scan (`_wkv_chunked`) is a kernel on the
card and the plain version on the CPU. The kernel (`csrc/wkv6.cu`,
wrapper `kernels/wkv6/ops.py`, counter ``launches``) replaces no Pallas
kernel: it was added for the plain scan's launches and bytes (~30
kernels and an 84 MB float32 decay tensor for each of 125 chunks a layer
at 8,000 tokens). Its bound at RWKV6-3B's prefill (2, 8000, 40, 64) is
its 820 MB read and written once, 0.245 ms a layer at 3.35 TB/s; it
steps the tokens in order with the state held in registers, a block per
(row, head, slice of value columns) so that the 80 (row, head) pairs
fill the SMs, and stages r, k, log w and v through shared memory a few
tokens ahead. The plain version (`kernels/wkv6/ref.py`) walks time
chunks, as the JAX package's `lax.scan` does: within a chunk the
in-chunk keys contribute through causal decay products, the carried
state through one matrix product; the decay is per channel, so a chunk's
decay products are (B, Lc, Lc, H, P), as in the JAX package.
`rwkv6_time_mix_ref` is the per-step oracle.

The decay LoRA and the wkv products are float32; `ln_x` is the RMSNorm
kernel (K3) on the card, at d_model wide rows. The block norms around it
are the model's (LayerNorm for RWKV6-3B), plain as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import spmd
from repro_torch.core import timing
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.models.common import ModelConfig, ParamMeta
from repro_torch.models.layers import rms_norm

LORA_R = 32


def _dims(cfg: ModelConfig):
    P = cfg.ssm_head_dim
    H = cfg.d_model // P
    return H, P


def rwkv6_metas(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    tm = {
        # static token-shift mixes
        "mu_r": ParamMeta((d,), ("unsharded",), init="zeros"),
        "mu_k": ParamMeta((d,), ("unsharded",), init="zeros"),
        "mu_v": ParamMeta((d,), ("unsharded",), init="zeros"),
        "mu_w": ParamMeta((d,), ("unsharded",), init="zeros"),
        "mu_g": ParamMeta((d,), ("unsharded",), init="zeros"),
        "w_r": ParamMeta((d, d), ("embed", "unsharded")),
        "w_k": ParamMeta((d, d), ("embed", "unsharded")),
        "w_v": ParamMeta((d, d), ("embed", "unsharded")),
        "w_g": ParamMeta((d, d), ("embed", "unsharded")),
        "w_o": ParamMeta((d, d), ("unsharded", "embed")),
        # data-dependent decay LoRA: w = exp(-exp(w0 + tanh(x @ a) @ b))
        "decay_w0": ParamMeta((d,), ("unsharded",), init="zeros"),
        "decay_a": ParamMeta((d, LORA_R), ("embed", "unsharded")),
        "decay_b": ParamMeta((LORA_R, d), ("unsharded", "unsharded")),
        "bonus_u": ParamMeta((d,), ("unsharded",), init="zeros"),
        "ln_x": ParamMeta((d,), ("unsharded",), init="zeros"),
    }
    cm = {
        "mu_k": ParamMeta((d,), ("unsharded",), init="zeros"),
        "w_in": ParamMeta((d, cfg.d_ff), ("embed", "ff")),
        "w_out": ParamMeta((cfg.d_ff, d), ("ff", "embed")),
    }
    return {"tm": tm, "cm": cm}


def _shift(x, last=None):
    """Previous-token view. x: (B,S,d); last: (B,d) decode carry or None."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _time_mix_inputs(cfg, p, x, last=None):
    H, P = _dims(cfg)
    B, S, d = x.shape
    xx = _shift(x, last)

    def mix(mu):
        return x + (xx - x) * torch.sigmoid(mu)

    r = spmd.split_last(mix(p["mu_r"]) @ p["w_r"], (H, P))
    k = spmd.split_last(mix(p["mu_k"]) @ p["w_k"], (H, P))
    v = spmd.split_last(mix(p["mu_v"]) @ p["w_v"], (H, P))
    g = F.silu(mix(p["mu_g"]) @ p["w_g"])
    xw = mix(p["mu_w"])
    f32 = torch.float32
    logw = -torch.exp(
        p["decay_w0"].to(f32)
        + torch.tanh(xw.to(f32) @ p["decay_a"].to(f32)) @ p["decay_b"].to(f32)
    )  # (B,S,d) log-decay <= 0, data-dependent
    # clamp: a saturated decay (logw -> -inf) makes cum-sum differences in
    # the chunked path inf - inf = NaN; e^-20 is already an exact-zero decay
    logw = torch.clamp(logw, -20.0, -1e-6)
    w = spmd.split_last(logw, (H, P))
    u = p["bonus_u"].reshape(H, P)
    return r, k, v, g, w, u


def _wkv_chunked(r, k, v, logw, u, chunk: int):
    """The wkv scan over the sequence. r,k,v,logw: (B,S,H,P) float32;
    u: (H,P). Returns y (B,S,H,P) float32 and the final state (B,H,P,P).
    A CUDA tensor launches the wkv kernel (`kernels.wkv6.ops.wkv6`, one
    launch a call; ``chunk`` does not apply there); a CPU tensor takes
    the plain version, the chunk loop at ``chunk`` (`kernels.wkv6.ref`).
    On DTensors the scan runs on local shards (`spmd.local`): it is local
    per batch row and per head."""
    if spmd.is_dtensor(r):
        keep = (0, 2)
        ops = [spmd.operand(r, keep)] * 4 + [spmd.operand(r, keep, {2: 0})]
        outs = (ops[0][0], spmd.operand(r, keep, {0: 0, 2: 1})[0])
        return spmd.local(lambda *a: _wkv_chunked(*a, chunk), outs,
                          [o[0] for o in ops], [o[1] for o in ops])(r, k, v, logw, u)
    return wkv6_ops.wkv6(r, k, v, logw, u, chunk)


def _finish(cfg, p, y, g):
    B, S = y.shape[:2]
    y = y.reshape(B, S, cfg.d_model)
    y = rms_norm(y, p["ln_x"]) * g
    return y @ p["w_o"]


def rwkv6_time_mix(cfg: ModelConfig, p: dict, x, chunk: int = 64, want_state: bool = False):
    """Full-sequence time-mix. x: (B,S,d) -> (B,S,d), or (out, final wkv
    state) when want_state. The chunk length is ``chunk`` (64 by
    default, as in the JAX package), not ``cfg.ssm_chunk``."""
    r, k, v, g, w, u = _time_mix_inputs(cfg, p, x)
    r, k, v = (a.to(torch.float32) for a in (r, k, v))
    with timing.span("rwkv6.wkv_chunked"):
        y, S_fin = _wkv_chunked(r, k, v, w, u, chunk)
    out = _finish(cfg, p, y.to(x.dtype), g)
    return (out, S_fin) if want_state else out


def _wkv_step(rt, kt, vt, wt, u, S_prev):
    """One token of the recurrence: (y (B,H,P), S_new). All (B,H,P) but
    u (H,P) and S_prev (B,H,P,P). On DTensors it runs on local shards
    (`spmd.local`): a token's step is local per batch row and per head,
    and the token moves to where the state lies."""
    if spmd.is_dtensor(S_prev):
        keep = (0, 1)
        ops = ([spmd.operand(S_prev, keep, {0: 0, 1: 1})] * 4
               + [spmd.operand(S_prev, keep, {1: 0}), spmd.operand(S_prev, keep)])
        return spmd.local(_wkv_step, (ops[0][0], ops[5][0]), [o[0] for o in ops],
                          [o[1] for o in ops])(rt, kt, vt, wt, u, S_prev)
    bonus = (rt * u.to(torch.float32) * kt).sum(-1)  # (B,H)
    y = torch.einsum("bhp,bhpq->bhq", rt, S_prev) + bonus[..., None] * vt
    S_new = S_prev * torch.exp(wt)[..., None] + torch.einsum("bhp,bhq->bhpq", kt, vt)
    return y, S_new


def rwkv6_time_mix_ref(cfg: ModelConfig, p: dict, x):
    """Per-step oracle."""
    H, P = _dims(cfg)
    B, S, d = x.shape
    r, k, v, g, w, u = _time_mix_inputs(cfg, p, x)
    r, k, v, w = (a.to(torch.float32) for a in (r, k, v, w))
    S_t = torch.zeros((B, H, P, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        y_t, S_t = _wkv_step(r[:, t], k[:, t], v[:, t], w[:, t], u, S_t)
        ys.append(y_t)
    y = torch.stack(ys, dim=1)
    return _finish(cfg, p, y.to(x.dtype), g)


def rwkv6_channel_mix(cfg: ModelConfig, p: dict, x, last=None):
    xx = _shift(x, last)
    xm = x + (xx - x) * torch.sigmoid(p["mu_k"])
    h = torch.square(F.relu(xm @ p["w_in"]))
    return h @ p["w_out"]


def rwkv6_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu") -> dict:
    H, P = _dims(cfg)
    return {
        "wkv": torch.zeros((batch, H, P, P), dtype=torch.float32, device=device),
        "tm_last": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "cm_last": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
    }


def rwkv6_decode(cfg: ModelConfig, p: dict, x, cache):
    """One-token decode of a layer's time-mix (the caller runs the
    channel-mix). x: (B,1,d), the normed input; p holds ``tm`` and ``cm``.
    Returns (out, new cache); the cache given is not written."""
    r, k, v, g, w, u = _time_mix_inputs(cfg, p["tm"], x, last=cache["tm_last"])
    rt, kt, vt, wt = (a[:, 0].to(torch.float32) for a in (r, k, v, w))
    with timing.span("rwkv6.wkv_step"):
        y, S_new = _wkv_step(rt, kt, vt, wt, u, cache["wkv"])
    out = _finish(cfg, p["tm"], y[:, None].to(x.dtype), g)
    return out, dict(cache, wkv=S_new, tm_last=x[:, 0])
