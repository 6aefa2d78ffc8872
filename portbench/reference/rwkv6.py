"""RWKV-6 "Finch" (arXiv:2404.05892) as the port serves it, in plain
float32 PyTorch. Each layer: a pre-LN time-mix, whose per-head state
follows

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),

with the decay w_t = exp(-exp(w0 + tanh(x_w A) B)) a function of the
input, then a pre-LN channel-mix, relu(x_k W_in)^2 W_out. The logits go
through the tied token table.

Departures from the published model, which the port makes and this
reference follows: the token-shift mixes are static learned vectors
(sigmoid(mu)) where RWKV-6 computes them from the input, the decay's
low-rank inner size is 32, the time-mix output is normed by an RMSNorm
over d_model (scale 1 + w) where RWKV-6 has a GroupNorm per head, there
is no LayerNorm after the embedding, the channel-mix has no receptance
gate, and the head is tied to the embedding. The port clamps log w_t to
[-20, -1e-6]; this reference leaves the clamp out: with the benchmark's
draws |log w_t| never falls to 1e-6, and where it passes 20 both sides
decay the state by e^-20 or less, nought beside what the token adds.

`wkv` walks the sequence in chunks of `CHUNK` tokens: inside a chunk the
keys reach the later queries through exp(c_{t-1} - c_s), the decays'
cumulative logs, which are at most 0 and so never overflow; the state
carries the rest. It is the recurrence above, regrouped, in float32
(`wkv_steps` is the recurrence step by step, which the tests hold it
to).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import F32, Precision, fan_in, layer_norm, leaf, rms_norm, stacked

CHUNK = 64
LORA_R = 32


def weights(m: dict) -> dict:
    """The weight table: every leaf's shape and draw. Mixes N(0, 1) (a
    sigmoid of 0.27-0.73), w0 N(-3.5, 1.25^2) (decays exp(-exp(w0)) of 0.90
    to 0.99 within one deviation of its mean), u N(0, 0.5^2), norm offsets
    N(0, 0.1^2)."""
    d, ff = m["d_model"], m["d_ff"]
    tm = {
        **{f"mu_{c}": leaf((d,), 1.0) for c in "rkvwg"},
        **{f"w_{c}": fan_in((d, d), d) for c in "rkvgo"},
        "decay_w0": leaf((d,), 1.25, -3.5),
        "decay_a": fan_in((d, LORA_R), d),
        "decay_b": fan_in((LORA_R, d), LORA_R),
        "bonus_u": leaf((d,), 0.5),
        "ln_x": leaf((d,), 0.1),
    }
    cm = {"mu_k": leaf((d,), 1.0), "w_in": fan_in((d, ff), d), "w_out": fan_in((ff, d), ff)}
    block = {"ln1": leaf((d,), 0.1), "ln2": leaf((d,), 0.1), "rwkv": {"tm": tm, "cm": cm}}
    return {"embed": {"tok": leaf((m["vocab_size"], d), 1.0)},
            "groups": {"b0": stacked(block, m["num_layers"])},
            "final_norm": leaf((d,), 0.1)}


def wkv(r, k, v, logw, u):
    """y (R, T, H, P) for r, k, v, logw (R, T, H, P) and u (H, P), the
    state starting at 0."""
    R, T, H, P = r.shape
    S = torch.zeros(R, H, P, P, dtype=F32, device=r.device)
    ys = []
    for c0 in range(0, T, CHUNK):
        rc, kc, vc, wc = (a[:, c0:c0 + CHUNK] for a in (r, k, v, logw))
        n = rc.shape[1]
        cum = torch.cumsum(wc, dim=1)  # c_t, inclusive
        before = cum - wc  # c_{t-1}
        later = torch.ones(n, n, dtype=torch.bool, device=r.device).tril(-1)  # s < t
        expo = (before[:, :, None] - cum[:, None, :]).masked_fill(~later[None, :, :, None, None],
                                                                  -torch.inf)
        att = torch.einsum("rthp,rtshp,rshp->rtsh", rc, torch.exp(expo), kc)
        y = torch.einsum("rtsh,rshq->rthq", att, vc)
        y = y + (rc * u * kc).sum(-1, keepdim=True) * vc
        y = y + torch.einsum("rthp,rhpq->rthq", rc * torch.exp(before), S)
        S = (S * torch.exp(cum[:, -1])[..., None]
             + torch.einsum("rshp,rshq->rhpq", kc * torch.exp(cum[:, -1:] - cum), vc))
        ys.append(y)
    return torch.cat(ys, dim=1)


def wkv_steps(r, k, v, logw, u):
    """The recurrence one token at a time (slow; for the tests)."""
    R, T, H, P = r.shape
    S = torch.zeros(R, H, P, P, dtype=F32, device=r.device)
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("rhp,rhpq->rhq", r[:, t], S + u[..., None] * kv))
        S = torch.exp(logw[:, t])[..., None] * S + kv
    return torch.stack(ys, dim=1)


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _time_mix(prec: Precision, p: dict, l: int, x, H: int):
    R, T, d = x.shape
    xx = _shift(x)

    def mixed(c):
        return x + (xx - x) * torch.sigmoid(p[f"mu_{c}"][l].to(F32))

    def proj(c, inp):
        return prec.mm(inp, p[f"w_{c}"][l].to(F32))

    r, k, v = (proj(c, mixed(c)).reshape(R, T, H, -1) for c in "rkv")
    g = F.silu(proj("g", mixed("g")))
    lora = prec.mm(torch.tanh(prec.mm(mixed("w"), p["decay_a"][l].to(F32))),
                   p["decay_b"][l].to(F32))
    logw = -torch.exp(p["decay_w0"][l].to(F32) + lora).reshape(R, T, H, -1)
    u = p["bonus_u"][l].to(F32).reshape(H, -1)
    y = wkv(r, k, v, logw, u).reshape(R, T, d)
    return proj("o", rms_norm(y, p["ln_x"][l]) * g)


def _channel_mix(prec: Precision, p: dict, l: int, x):
    xk = x + (_shift(x) - x) * torch.sigmoid(p["mu_k"][l].to(F32))
    return prec.mm(torch.relu(prec.mm(xk, p["w_in"][l].to(F32))).square(),
                   p["w_out"][l].to(F32))


def logits(params: dict, m: dict, tokens, memory, start: int,
           prec: Precision | None = None):
    """Float32 logits (R, T - start, V) at positions start..T-1 of the
    token rows ``tokens`` (R, T); ``memory`` is None (no cross-attention)."""
    prec = prec or Precision()
    H = m["d_model"] // m["ssm_head_dim"]
    p = params["groups"]["b0"]
    tok = params["embed"]["tok"]
    x = tok[tokens].to(F32)
    for l in range(p["ln1"].shape[0]):
        x = x + _time_mix(prec, p["rwkv"]["tm"], l, layer_norm(x, p["ln1"][l]), H)
        x = x + _channel_mix(prec, p["rwkv"]["cm"], l, layer_norm(x, p["ln2"][l]))
    x = layer_norm(x[:, start:], params["final_norm"])
    return prec.mm(x, tok.to(F32).T)
