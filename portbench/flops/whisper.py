"""Operations and bytes of Whisper's serving calls, from the shapes.

A product of (m, k) by (k, n) is 2 m k n operations. Attention counts
4 hd operations for each live (query, key) pair of each head (Q K^T and
P V): all Sq Skv pairs without a mask, S (S + 1) / 2 under the causal
mask of a prompt. Norms, softmax and the element-wise work are left out.
The prefill counts the encoder over the frames, the cross-attention's
K and V projections of the encoded frames and the decoder over the
prompt, with logits at the last position only, as the port computes
them. A decode step counts one position per row against every earlier
one and the whole memory.

Bytes are what a step must move at the least: each weight it uses read
once, each cache read once (the cross-attention's K and V over the
memory, the self-attention's over the positions so far), the new K and V
written; activations are left out.
"""
from __future__ import annotations


def _sizes(m: dict):
    d, H, KV, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    return d, H, KV, hd, m["d_ff"], m["vocab_size"], m["num_layers"], m["encoder_layers"]


def _proj_self(d, H, KV, hd):
    """Per token: q, k, v and the output projection."""
    return 2 * d * (H + 2 * KV) * hd + 2 * H * hd * d


def prefill(m: dict, batch: int, prompt: int, memory: int) -> dict:
    """{"flops"}: one prefill of ``batch`` rows of ``prompt`` tokens over
    ``memory`` frames."""
    d, H, KV, hd, ff, V, L, Le = _sizes(m)
    mlp = 4 * d * ff
    enc = Le * (memory * (_proj_self(d, H, KV, hd) + mlp) + 4 * hd * H * memory * memory)
    xkv = L * memory * 2 * (2 * d * KV * hd)
    dec_tok = _proj_self(d, H, KV, hd) + 2 * (2 * d * H * hd) + mlp
    pairs = prompt * (prompt + 1) // 2 + prompt * memory
    dec = L * (prompt * dec_tok + 4 * hd * H * pairs)
    return {"flops": batch * (enc + xkv + dec + 2 * d * V)}


def decode(m: dict, batch: int, prompt: int, memory: int, steps: int,
           weight_bytes: int = 2, cache_bytes: int = 2) -> dict:
    """{"flops", "bytes"} of ``steps`` decode steps after a prompt of
    ``prompt`` tokens, summed; step i places position prompt + i."""
    d, H, KV, hd, ff, V, L, Le = _sizes(m)
    per_tok = L * (_proj_self(d, H, KV, hd) + 2 * (2 * d * H * hd) + 4 * d * ff) + 2 * d * V
    w_layer = d * (H + 2 * KV) * hd + H * hd * d + 2 * d * H * hd + 2 * d * ff + 3 * d
    weights = weight_bytes * (L * w_layer + V * d + d)
    flops = nbytes = 0
    for i in range(steps):
        seen = prompt + i + 1  # positions the new token attends to
        flops += batch * (per_tok + L * 4 * hd * H * (seen + memory))
        cache = L * 2 * KV * hd * (seen + memory)  # K and V read
        nbytes += weights + batch * cache_bytes * (cache + L * 2 * KV * hd)  # + new K, V
    return {"flops": flops, "bytes": nbytes}


def attention_calls(m: dict, batch: int, prompt: int, memory: int) -> list[dict]:
    """The prefill's attention calls, one entry a kind: how many, and
    the shapes of each (q (B, Sq, H, hd); k, v (B, Skv, KV, hd))."""
    d, H, KV, hd, ff, V, L, Le = _sizes(m)
    shape = {"B": batch, "H": H, "KV": KV, "hd": hd}
    return [dict(shape, n=Le, Sq=memory, Skv=memory, causal=False),
            dict(shape, n=L, Sq=prompt, Skv=prompt, causal=True),
            dict(shape, n=L, Sq=prompt, Skv=memory, causal=False)]
