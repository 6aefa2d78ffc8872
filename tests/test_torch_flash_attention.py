"""The port's flash attention (K4's wrapper; on CPU tensors its plain
version) against the JAX package's Pallas kernel in interpret mode and
its model function `models.attention.flash_attention`, on the same numpy
inputs in the model's (B, S, KV, G, hd) layout.

Tolerances: float32 within 2e-5 (the plain version's two-pass softmax
against the JAX versions' online softmax over 32-row tiles; the JAX
package holds its kernel to its oracle at 3e-5); bfloat16 within one
bf16 unit in the last place (all three compute in float32 and round
once), plus 1e-5 absolute for outputs near zero, where float32 sums of
O(1) terms cancel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_pallas
from repro.models.attention import flash_attention as flash_jax
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

CASES = [  # B, S, KV, G, hd, causal, window, softcap
    (2, 128, 2, 2, 32, True, 0, 0.0),    # tests/test_kernels.py's five
    (1, 256, 1, 4, 16, True, 64, 0.0),   # MQA + sliding window
    (2, 64, 2, 1, 32, False, 0, 0.0),    # non-causal
    (1, 128, 2, 2, 32, True, 0, 30.0),   # softcap
    (1, 96, 3, 1, 16, True, 0, 0.0),     # non-pow2 blocks
    (1, 100, 2, 2, 32, True, 0, 50.0),   # S not a multiple of the tile
    (1, 96, 2, 2, 32, True, 20, 50.0),   # a row's first live tile fully masked
]


def within_bf16_ulp(got: np.ndarray, want: np.ndarray, atol: float = 1e-5) -> bool:
    """|got - want| <= one bf16 ulp of want, plus ``atol`` for values near
    zero, where float32 sums of O(1) terms cancel."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return bool(np.all(np.abs(got - want) <= ulp + atol))


@pytest.mark.parametrize("B,S,KV,G,hd,causal,window,softcap", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(rng, B, S, KV, G, hd, causal, window, softcap,
                                     dtype):
    q = rng.normal(size=(B, S, KV, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window)
    qt, kt, vt = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    n0 = attn_ops.launches
    got = attn_ops.flash_attention(qt, kt, vt, softcap=softcap, **kw)
    assert attn_ops.launches == n0  # the plain version ran, not the kernel
    assert got.dtype == qt.dtype and got.shape == qt.shape
    got = got.float().numpy()
    qj, kj, vj = (jnp.asarray(a, dtype) for a in (q, k, v))
    wants = (flash_attention_pallas(qj, kj, vj, softcap=softcap, block_q=32, block_k=32,
                                    interpret=True, **kw),
             flash_jax(qj, kj, vj, logit_softcap=softcap, q_chunk=32, kv_chunk=32, **kw))
    for want in wants:
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        else:
            assert within_bf16_ulp(got, want)


def test_masked_rows_use_the_finite_neg_inf():
    """A fully masked score row (no key passes the window) is uniform over
    its keys, as with the JAX versions' finite -1e30, not NaN."""
    q = torch.randn(1, 4, 1, 1, 16, generator=torch.Generator().manual_seed(0))
    k = torch.randn(1, 4, 1, 16, generator=torch.Generator().manual_seed(1))
    v = torch.randn(1, 4, 1, 16, generator=torch.Generator().manual_seed(2))
    out = flash_attention_ref(q, k, v, causal=True, window=-3)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0, 0, 0, 0], v[0, :, 0].mean(0))


# ---------------------------------------------------------------------------
# The bfloat16 kernel's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

LOG2E = np.float32(1.4426950408889634)


def _bf16_parts(x, n):
    """x (float32) as n bf16 terms, largest first: x - sum(parts) is what
    n bf16 values cannot hold (nothing for n=3)."""
    parts = []
    for _ in range(n):
        parts.append(x.bfloat16().float())
        x = x - parts[-1]
    return parts


def split_p_emulation(q, k, v, *, causal, window, softcap, bq=128, bk=64):
    """What the bf16 tensor-core kernel computes, step by step, in torch:
    128-row q tiles over 64-row kv tiles (zero-padded, as TMA fills rows
    past S), only the tiles the causal and window bounds leave live; S as
    float32 sums of exact bf16 products, 16 hd columns at a time, added in
    float32; s * hd^-0.5 and softcap * tanh(s / softcap); the finite -1e30
    mask; the online softmax in float32 with p = 2^((s - m) log2 e); l
    summed from the float32 p; each tile's P V from P split into three
    bf16 terms (exact), added to O * corr; O / max(l, 1e-30) rounded to
    bf16."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    pad_q, pad_k = -(-Sq // bq) * bq, -(-Skv // bk) * bk
    qf = torch.zeros(B, KV, G, pad_q, hd)
    qf[:, :, :, :Sq] = q.float().permute(0, 2, 3, 1, 4)
    kf, vf = (torch.zeros(B, KV, 1, pad_k, hd) for _ in range(2))
    kf[:, :, 0, :Skv] = k.float().permute(0, 2, 1, 3)
    vf[:, :, 0, :Skv] = v.float().permute(0, 2, 1, 3)
    scale = np.float32(hd ** -0.5)
    out = torch.zeros(B, KV, G, pad_q, hd)
    for q0 in range(0, Sq, bq):
        rows = torch.arange(q0, q0 + bq)[:, None]
        q_last = min(q0 + bq, Sq) - 1
        hi = -(-Skv // bk)
        if causal:
            hi = min(hi, q_last // bk + 1)
        lo = max(q0 - window + 1, 0) // bk if window > 0 else 0
        m = torch.full((B, KV, G, bq, 1), -1e30)
        l = torch.zeros(B, KV, G, bq, 1)
        acc = torch.zeros(B, KV, G, bq, hd)
        for kt in range(lo, hi):
            k0 = kt * bk
            qt, kt_ = qf[:, :, :, q0:q0 + bq], kf[:, :, :, k0:k0 + bk]
            s = sum((qt[..., c:c + 16].double() @ kt_[..., c:c + 16].double()
                     .transpose(-1, -2)).float() for c in range(0, hd, 16))
            s = s * scale
            if softcap:
                s = np.float32(softcap) * torch.tanh(s * np.float32(1 / softcap))
            keys = torch.arange(k0, k0 + bk)[None, :]
            live = keys < Skv
            if causal:
                live = live & (rows >= keys)
            if window > 0:
                live = live & (rows - keys < window)
            s = torch.where(live, s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2((m - m_new) * LOG2E)
            p = torch.exp2((s - m_new) * LOG2E)
            l = l * corr + p.sum(-1, keepdim=True)
            vt = vf[:, :, :, k0:k0 + bk].bfloat16().double()
            pv = sum(part.double() @ vt for part in _bf16_parts(p, 3)).float()
            acc = acc * corr + pv
            m = m_new
        out[:, :, :, q0:q0 + bq] = acc / l.clamp_min(1e-30)
    return out[:, :, :, :Sq].permute(0, 3, 1, 2, 4).to(torch.bfloat16)


@pytest.mark.parametrize("B,S,KV,G,hd,causal,window,softcap",
                         CASES + [(1, 200, 2, 2, 64, True, 0, 50.0)])
def test_split_p_design_meets_the_bf16_contract(rng, B, S, KV, G, hd, causal, window,
                                                softcap):
    """The bf16 kernel's rounding (P split into three bf16 terms, exp2 with
    log2 e folded in, S summed per 16 hd columns, each tile's P V added to
    O) stays within one bf16 ulp (+1e-5) of the JAX package's Pallas kernel
    in interpret mode and of the port's plain version."""
    q = rng.normal(size=(B, S, KV, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = split_p_emulation(qt, kt, vt, softcap=softcap, **kw).float().numpy()
    qj, kj, vj = (jnp.asarray(a, "bfloat16") for a in (q, k, v))
    pallas = flash_attention_pallas(qj, kj, vj, softcap=softcap, block_q=32,
                                    block_k=32, interpret=True, **kw)
    plain = flash_attention_ref(qt, kt, vt, softcap=softcap, **kw)
    assert within_bf16_ulp(got, np.asarray(pallas, np.float32))
    assert within_bf16_ulp(got, plain.float().numpy())
