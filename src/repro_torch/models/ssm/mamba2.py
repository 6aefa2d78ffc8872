"""Mamba2 (SSD) block, chunked (the JAX package's `models/ssm/mamba2.py`).

The recurrence per head h (state S in R^{P x N}, P=head_dim, N=d_state):

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * x_t (outer) B_t
    y_t = C_t . S_t + D_h * x_t

is evaluated chunk-wise (chunk length Lc): an intra-chunk causal matmul
part plus an inter-chunk state carry, the standard SSD decomposition.
`mamba2_scan_ref` is the step-by-step oracle the tests use.

As in the JAX package, the short causal conv runs on x and on (B, C) as
two per-channel convs, summed tap by tap in the model dtype; dt, A, the
state and the SSD products are float32. Where the JAX package scans over
the chunks with `lax.scan`, the port loops over them in Python: all
intra-chunk work stays inside the loop body, so the transients are
O(B * Lc^2 * H). The three-operand products are split so that no chunk
holds a (B, Lc, Lc, H, P) tensor: the (B, Lc, Lc, H) decay-weighted
scores go through one batched matrix product with x * dt.

The inner norm `rms_norm(y * z, norm)` is the RMSNorm kernel (K3) on the
card, at d_inner wide rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import spmd
from repro_torch.core import timing
from repro_torch.models.common import ModelConfig, ParamMeta
from repro_torch.models.layers import rms_norm


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    return d_inner, heads, cfg.ssm_head_dim, cfg.ssm_state


def mamba2_metas(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_inner, H, P, N = _dims(cfg)
    k = cfg.ssm_conv
    return {
        "w_x": ParamMeta((d, d_inner), ("embed", "ff")),
        "w_z": ParamMeta((d, d_inner), ("embed", "ff")),
        "w_bc": ParamMeta((d, 2 * N), ("embed", "unsharded")),
        "w_dt": ParamMeta((d, H), ("embed", "unsharded")),
        "conv_x": ParamMeta((k, d_inner), ("unsharded", "ff"), init="normal", init_scale=0.1),
        "conv_bc": ParamMeta((k, 2 * N), ("unsharded", "unsharded"), init="normal",
                             init_scale=0.1),
        "a_log": ParamMeta((H,), ("unsharded",), init="zeros"),
        "dt_bias": ParamMeta((H,), ("unsharded",), init="zeros"),
        "d_skip": ParamMeta((H,), ("unsharded",), init="ones"),
        "norm": ParamMeta((d_inner,), ("unsharded",), init="zeros"),
        "w_out": ParamMeta((d_inner, d), ("ff", "embed")),
    }


def _causal_conv(x, w, state=None):
    """Per-channel causal conv. x: (B,S,C); w: (k,C). If `state` is given
    ((B,k-1,C), the decode path) it is prepended. Returns (silu(out), the
    last k-1 inputs: the carried state)."""
    k = w.shape[0]
    if state is None:
        pad = spmd.like(torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                                    device=x.device), x)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    # the taps summed in x's dtype in the JAX package's order (Python's sum)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else torch.zeros_like(pad)
    return F.silu(out), new_state


def _inputs(cfg: ModelConfig, p: dict, x, conv_states=None):
    """Shared projection/conv front half. x: (B,S,d)."""
    d_inner, H, P, N = _dims(cfg)
    B, S, _ = x.shape
    z = F.silu(x @ p["w_z"])
    xs = x @ p["w_x"]
    bc = x @ p["w_bc"]
    cs_x = cs_bc = None
    if conv_states is not None:
        cs_x, cs_bc = conv_states["x"], conv_states["bc"]
    xs, new_cs_x = _causal_conv(xs, p["conv_x"], cs_x)
    bc, new_cs_bc = _causal_conv(bc, p["conv_bc"], cs_bc)
    Bm, Cm = torch.split(bc, N, dim=-1)  # (B,S,N) each
    dt = F.softplus((x @ p["w_dt"]).to(torch.float32) + p["dt_bias"])  # (B,S,H)
    A = -torch.exp(p["a_log"].to(torch.float32))  # (H,) negative
    xh = spmd.split_last(xs, (H, P))
    return z, xh, Bm, Cm, dt, A, {"x": new_cs_x, "bc": new_cs_bc}


def _finish(cfg, p, y, z):
    B, S = y.shape[:2]
    y = y.reshape(B, S, -1)
    y = rms_norm(y * z, p["norm"])
    return y @ p["w_out"]


def chunk_len(S: int, chunk: int) -> int:
    """The JAX package's chunk rule: the largest length <= min(chunk, S)
    that divides S (8,000 tokens at chunk 128 run chunks of 125)."""
    Lc = min(chunk, S)
    while S % Lc:
        Lc -= 1
    return Lc


def _ssd_chunked(xh, Bm, Cm, dt, A, d_skip, Lc: int, out_dtype):
    """The SSD scan over chunks of Lc. xh (B,S,H,P), Bm/Cm (B,S,N) in the
    model dtype; dt (B,S,H) and A (H,) float32. Returns y (B,S,H,P) in
    ``out_dtype`` (the float32 result cast) and the final state (B,H,P,N)
    float32. On DTensors the scan runs on local shards (`spmd.local`): it
    is local per batch row and per head."""
    if spmd.is_dtensor(xh):
        keep = (0, 2)
        ops = [spmd.operand(xh, keep), spmd.operand(xh, keep, {0: 0}),
               spmd.operand(xh, keep, {0: 0}), spmd.operand(xh, keep, {0: 0, 2: 2}),
               spmd.operand(xh, keep, {2: 0}), spmd.operand(xh, keep, {2: 0})]
        outs = (ops[0][0], spmd.operand(xh, keep, {0: 0, 2: 1})[0])
        return spmd.local(lambda *a: _ssd_chunked(*a, Lc, out_dtype), outs,
                          [o[0] for o in ops], [o[1] for o in ops])(
            xh, Bm, Cm, dt, A, d_skip)
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    causal = torch.ones((Lc, Lc), dtype=torch.bool, device=xh.device).tril()
    d_skip = d_skip[:, None]
    y = torch.empty((B, S, H, P), dtype=out_dtype, device=xh.device)
    S_prev = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    for c0 in range(0, S, Lc):
        sl = slice(c0, c0 + Lc)
        xi = xh[:, sl].to(torch.float32)  # (B,Lc,H,P)
        bi = Bm[:, sl].to(torch.float32)  # (B,Lc,N)
        ci = Cm[:, sl].to(torch.float32)
        dti = dt[:, sl]  # (B,Lc,H)
        cum_a = torch.cumsum(dti * A, dim=1)  # inclusive log-decay
        xdt = xi * dti[..., None]
        # intra-chunk: L[i,j] = exp(cum_a_i - cum_a_j) for i >= j (incl.
        # diag); above the diagonal exp overflows to inf and is replaced
        seg = cum_a[:, :, None, :] - cum_a[:, None, :, :]  # (B,i,j,H)
        L = torch.where(causal[None, :, :, None], torch.exp(seg), 0.0)
        G = torch.einsum("bin,bjn->bij", ci, bi)
        y_intra = torch.einsum("bijh,bjhp->bihp", G[..., None] * L, xdt)
        # carried state applies with decay from chunk start
        y_inter = torch.einsum("bin,bhpn->bihp", ci, S_prev) * torch.exp(cum_a)[..., None]
        # state update
        decay_to_end = torch.exp(cum_a[:, -1:, :] - cum_a)  # (B,Lc,H)
        S_chunk = torch.einsum("bjhp,bjn->bhpn", xdt * decay_to_end[..., None], bi)
        S_prev = S_prev * torch.exp(cum_a[:, -1, :])[..., None, None] + S_chunk
        y[:, sl] = y_intra + y_inter + d_skip * xi
    return y, S_prev


def mamba2_apply(cfg: ModelConfig, p: dict, x, chunk: int | None = None,
                 want_state: bool = False):
    """Full-sequence chunked SSD. x: (B,S,d) -> (B,S,d), or ((B,S,d), the
    decode-ready cache {ssm, conv_x, conv_bc}) when want_state."""
    Lc = chunk_len(x.shape[1], chunk or cfg.ssm_chunk)
    z, xh, Bm, Cm, dt, A, conv_states = _inputs(cfg, p, x)
    with timing.span("mamba2.ssd_chunked"):
        y, S_fin = _ssd_chunked(xh, Bm, Cm, dt, A, p["d_skip"], Lc, x.dtype)
    out = _finish(cfg, p, y, z)
    if want_state:
        return out, {"ssm": S_fin, "conv_x": conv_states["x"], "conv_bc": conv_states["bc"]}
    return out


def _ssd_step(S_prev, xt, bt, ct, dtt, A, d_skip):
    """One token of the recurrence. S_prev (B,H,P,N) float32; xt (B,H,P),
    bt/ct (B,N) in the model dtype; dtt (B,H) float32. Returns (y (B,H,P)
    float32, S_new). On DTensors it runs on local shards (`spmd.local`): a
    token's step is local per batch row and per head, and the token moves
    to where the state lies."""
    if spmd.is_dtensor(S_prev):
        keep = (0, 1)
        ops = [spmd.operand(S_prev, keep), spmd.operand(S_prev, keep, {0: 0, 1: 1}),
               spmd.operand(S_prev, keep, {0: 0}), spmd.operand(S_prev, keep, {0: 0}),
               spmd.operand(S_prev, keep, {0: 0, 1: 1}), spmd.operand(S_prev, keep, {1: 0})]
        args = [S_prev, xt, bt, ct, dtt, A]
        if d_skip is not None:
            ops.append(spmd.operand(S_prev, keep, {1: 0}))
            args.append(d_skip)
        return spmd.local(lambda *a: _ssd_step(*a, *(() if d_skip is not None else (None,))),
                          (ops[1][0], ops[0][0]), [o[0] for o in ops],
                          [o[1] for o in ops])(*args)
    S_new = S_prev * torch.exp(dtt * A)[..., None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", xt.to(torch.float32), bt.to(torch.float32), dtt)
    y = torch.einsum("bhpn,bn->bhp", S_new, ct.to(torch.float32))
    if d_skip is not None:
        y = y + d_skip[:, None] * xt.to(torch.float32)
    return y, S_new


def mamba2_scan_ref(cfg: ModelConfig, p: dict, x):
    """Step-by-step recurrence oracle (tests)."""
    d_inner, H, P, N = _dims(cfg)
    B, S, _ = x.shape
    z, xh, Bm, Cm, dt, A, _ = _inputs(cfg, p, x)
    S_t = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        y_t, S_t = _ssd_step(S_t, xh[:, t], Bm[:, t], Cm[:, t], dt[:, t], A, None)
        ys.append(y_t)
    y = torch.stack(ys, dim=1) + p["d_skip"][:, None] * xh.to(torch.float32)
    return _finish(cfg, p, y.to(x.dtype), z)


def mamba2_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                      device="cpu") -> dict:
    d_inner, H, P, N = _dims(cfg)
    k = cfg.ssm_conv
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, k - 1, d_inner), dtype=dtype, device=device),
        "conv_bc": torch.zeros((batch, k - 1, 2 * cfg.ssm_state), dtype=dtype, device=device),
    }


def mamba2_decode(cfg: ModelConfig, p: dict, x, cache):
    """One-token decode. x: (B,1,d); cache as from mamba2_init_cache.
    Returns (out, new cache); the cache given is not written."""
    z, xh, Bm, Cm, dt, A, new_conv = _inputs(
        cfg, p, x, conv_states={"x": cache["conv_x"], "bc": cache["conv_bc"]})
    with timing.span("mamba2.ssd_step"):
        y, S_new = _ssd_step(cache["ssm"], xh[:, 0], Bm[:, 0], Cm[:, 0], dt[:, 0], A,
                             p["d_skip"])
    out = _finish(cfg, p, y[:, None].to(x.dtype), z)
    return out, {"ssm": S_new, "conv_x": new_conv["x"], "conv_bc": new_conv["bc"]}
