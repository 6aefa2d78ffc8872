"""Whisper (arXiv:2212.04356) as the port serves it, in plain float32
PyTorch: an encoder of pre-LN non-causal self-attention blocks over the
frame embeddings, then a decoder of pre-LN causal self-attention,
cross-attention onto the encoded frames and a GELU MLP, its logits
through the tied token table.

Departures from the published model, which the port makes and this
reference follows: the frontend is a stub (the frames are given as
embeddings, positions included), the decoder adds the sinusoidal
encoding where Whisper learns a table, no projection or norm has a bias,
the GELU is the tanh form, and a norm's scale is stored as an offset w,
applied as (1 + w).

Weights are the benchmark's (`weights`), laid out as the port's
parameter tree: ``wq`` (d, KV, G, hd), ``wk``/``wv`` (d, KV, hd), ``wo``
(KV, G, hd, d), each layer's leaves stacked on a leading axis.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.common import F32, Precision, fan_in, gelu_tanh, layer_norm, leaf, stacked

NORM_STD = 0.1  # a norm's offset w, so that (1 + w) is not all ones


def weights(m: dict) -> dict:
    """The weight table: every leaf's shape and draw."""
    d, H, KV, hd, ff = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"], m["d_ff"]
    G = H // KV

    def attn():
        return {"wq": fan_in((d, KV, G, hd), d), "wk": fan_in((d, KV, hd), d),
                "wv": fan_in((d, KV, hd), d), "wo": fan_in((KV, G, hd, d), H * hd)}

    def norm():
        return leaf((d,), NORM_STD)

    mlp = {"wu": fan_in((d, ff), d), "wd": fan_in((ff, d), ff)}
    dec = {"ln1": norm(), "attn": attn(), "lnx": norm(), "xattn": attn(), "ln2": norm(),
           "mlp": mlp}
    enc = {"ln1": norm(), "attn": attn(), "ln2": norm(), "mlp": dict(mlp)}
    return {
        "embed": {"tok": leaf((m["vocab_size"], d), 1.0)},
        "groups": {"b0": stacked(dec, m["num_layers"])},
        "final_norm": norm(),
        "encoder": {"groups": {"b0": stacked(enc, m["encoder_layers"])}, "final_norm": norm()},
    }


def sinusoid(T: int, d: int, device) -> torch.Tensor:
    """(T, d): [sin, cos] of position times exp(-i ln(10000) / (d/2 - 1))."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=F32, device=device)
                      * (math.log(10000.0) / max(half - 1, 1)))
    ang = torch.arange(T, dtype=F32, device=device)[:, None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attend(prec: Precision, p: dict, l: int, x, kv, causal: bool):
    """Multi-head attention of x (R, T, d) onto kv (R, S, d)."""
    wq, wk, wv, wo = (p[k][l].to(F32) for k in ("wq", "wk", "wv", "wo"))
    d, KV, G, hd = wq.shape
    R, T, S = x.shape[0], x.shape[1], kv.shape[1]
    q = prec.mm(x, wq.reshape(d, -1)).reshape(R, T, KV, G, hd)
    k = prec.mm(kv, wk.reshape(d, -1)).reshape(R, S, KV, hd)
    v = prec.mm(kv, wv.reshape(d, -1)).reshape(R, S, KV, hd)
    s = torch.einsum("rtkgh,rskh->rkgts", prec.cast(q), prec.cast(k)) / math.sqrt(hd)
    if causal:
        mask = torch.ones(T, S, dtype=torch.bool, device=x.device).tril(S - T)
        s = s.masked_fill(~mask, -torch.inf)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("rkgts,rskh->rtkgh", prec.cast(a), prec.cast(v))
    return prec.mm(o.reshape(R, T, -1), wo.reshape(-1, d))


def _mlp(prec: Precision, p: dict, l: int, x):
    return prec.mm(gelu_tanh(prec.mm(x, p["wu"][l].to(F32))), p["wd"][l].to(F32))


def encode(prec: Precision, params: dict, frames):
    enc = params["encoder"]
    p = enc["groups"]["b0"]
    x = frames.to(F32)
    for l in range(p["ln1"].shape[0]):
        h = layer_norm(x, p["ln1"][l])
        x = x + _attend(prec, p["attn"], l, h, h, causal=False)
        x = x + _mlp(prec, p["mlp"], l, layer_norm(x, p["ln2"][l]))
    return layer_norm(x, enc["final_norm"])


def logits(params: dict, m: dict, tokens, memory, start: int,
           prec: Precision | None = None):
    """Float32 logits (R, T - start, V) at positions start..T-1 of the
    token rows ``tokens`` (R, T), the decoder attending to ``memory`` (R,
    Sm, d), the frames, encoded here."""
    prec = prec or Precision()
    mem = encode(prec, params, memory)
    p = params["groups"]["b0"]
    tok = params["embed"]["tok"]
    T = tokens.shape[1]
    x = tok[tokens].to(F32) + sinusoid(T, tok.shape[1], tokens.device)
    for l in range(p["ln1"].shape[0]):
        h = layer_norm(x, p["ln1"][l])
        x = x + _attend(prec, p["attn"], l, h, h, causal=True)
        x = x + _attend(prec, p["xattn"], l, layer_norm(x, p["lnx"][l]), mem, causal=False)
        x = x + _mlp(prec, p["mlp"], l, layer_norm(x, p["ln2"][l]))
    x = layer_norm(x[:, start:], params["final_norm"])
    return prec.mm(x, tok.to(F32).T)
