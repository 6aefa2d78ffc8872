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
