"""Operations and bytes of RWKV-6's serving calls, from the shapes.

A product of (m, k) by (k, n) is 2 m k n operations. Per token and
layer: the time-mix's five d x d projections (r, k, v, g, out), the
decay's low-rank pair (d x 32, 32 x d), the channel-mix's two (d x ff,
ff x d), and the recurrence at 4 P^2 a head (r_t S and k_t v_t^T added
in), its decay and bonus left out, as norms and element-wise work are.
The prefill's logits are at the last position only, as the port
computes them.

Bytes of a decode step: each weight read once, each float32 wkv state
read and written once; activations are left out.
"""
from __future__ import annotations

LORA_R = 32


def _per_token(m: dict) -> int:
    d, ff, P = m["d_model"], m["d_ff"], m["ssm_head_dim"]
    return m["num_layers"] * (5 * 2 * d * d + 2 * 2 * d * LORA_R + 2 * 2 * d * ff + 4 * P * d)


def prefill(m: dict, batch: int, prompt: int, memory: int = 0) -> dict:
    """{"flops"}: one prefill of ``batch`` rows of ``prompt`` tokens."""
    return {"flops": batch * (prompt * _per_token(m) + 2 * m["d_model"] * m["vocab_size"])}


def decode(m: dict, batch: int, prompt: int, memory: int, steps: int,
           weight_bytes: int = 2, state_bytes: int = 4) -> dict:
    """{"flops", "bytes"} of ``steps`` decode steps, summed."""
    d, ff, P, V, L = m["d_model"], m["d_ff"], m["ssm_head_dim"], m["vocab_size"], m["num_layers"]
    w_layer = 5 * d * d + 2 * d * LORA_R + 2 * d * ff + 11 * d  # + six mixes, w0, u, three norms
    weights = weight_bytes * (L * w_layer + V * d + d)
    states = state_bytes * 2 * L * (d // P) * P * P  # read and written
    flops = batch * steps * (_per_token(m) + 2 * d * V)
    return {"flops": flops, "bytes": steps * (weights + batch * states)}


def attention_calls(m: dict, batch: int, prompt: int, memory: int = 0) -> list[dict]:
    """No attention: RWKV-6 has none."""
    return []
