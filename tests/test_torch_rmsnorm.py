"""The port's RMSNorm (K3's wrapper; on CPU tensors its plain version)
against the JAX package's Pallas kernel in interpret mode and its model
function `models.layers.rms_norm`, on the same numpy inputs.

Tolerances: float32 within 1e-6 relative (the same float32 expression;
sums taken in another order); bfloat16 within one bf16 unit in the last
place (float32 results that differ in their last float32 bits can round
to neighbouring bf16 values), plus 1e-5 absolute near zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ops import rms_norm_pallas
from repro.models.layers import rms_norm as rms_norm_jax
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.models import layers

SHAPES = [(8, 128), (3, 7, 64), (1, 256), (5, 33),   # tests/test_kernels_rmsnorm.py
          (4, 3584),                                  # Gemma-2 9B d_model
          (2, 3, 1001)]                               # ragged d


def within_bf16_ulp(got: np.ndarray, want: np.ndarray, atol: float = 1e-5) -> bool:
    """|got - want| <= one bf16 ulp of want, plus ``atol`` for values near
    zero, where float32 sums of O(1) terms cancel."""
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return bool(np.all(np.abs(got - want) <= ulp + atol))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(rng, shape, dtype, wdtype):
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    w = (rng.normal(size=shape[-1]) * 0.1).astype(np.float32)
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, wdtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    wt = torch.from_numpy(w).to(getattr(torch, wdtype))
    n0 = norm_ops.launches
    got = layers.rms_norm(xt, wt)
    assert norm_ops.launches == n0  # the plain version ran, not the kernel
    assert got.dtype == xt.dtype and got.shape == xt.shape
    got = got.float().numpy()
    for want in (rms_norm_pallas(xj, wj, interpret=True), rms_norm_jax(xj, wj)):
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            assert within_bf16_ulp(got, want)


def test_layer_norm_matches_jax(rng):
    from repro.models.layers import layer_norm as layer_norm_jax

    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    w = (rng.normal(size=48) * 0.1).astype(np.float32)
    got = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(layer_norm_jax(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
