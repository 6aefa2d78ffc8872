"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels
at first use) and skip on a host without one; on the GPU host run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

K1 (masked Adam) must equal its plain version bit for bit; K2 (top-k
threshold bits) exactly, with byte-identical masks.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.core import masked_adam, selection
from repro_torch.kernels.masked_adam import ops as adam_ops
from repro_torch.kernels.masked_adam.ref import masked_adam_ref
from repro_torch.kernels.topk_mask import ops as topk_ops
from repro_torch.kernels.topk_mask.ref import topk_threshold_bits_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtypes", [
    (torch.float32,) * 4,
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float16, torch.float32, torch.float16, torch.float16),
])
def test_masked_adam_kernel_bitwise(dev, dtypes):
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (3, 17, 128)
    p, gr, m, v = (torch.randn(shape, generator=g, device=dev).to(dt) for dt in dtypes)
    v = v.abs()
    mask = torch.rand(shape, generator=g, device=dev) < 0.3
    _, bc = adam_ops.bias_correction(torch.tensor([0, 4, 30], dtype=torch.int32,
                                                  device=dev), lr=1e-3, b1=0.9, b2=0.999)
    n0 = adam_ops.launches
    out_k = adam_ops.masked_adam_3d(p, gr, m, v, mask, bc, b1=0.9, b2=0.999, eps=1e-8)
    assert adam_ops.launches == n0 + 1
    out_r = masked_adam_ref(p, gr, m, v, mask, bc, b1=0.9, b2=0.999, eps=1e-8)
    for k, r in zip(out_k, out_r):
        assert k.dtype == r.dtype and torch.equal(k, r)


def test_sequential_update_takes_the_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    params = {"w": torch.randn(37, 5, generator=g, device=dev),
              "b": torch.randn(3, generator=g, device=dev)}
    grads = tree.tree_map(lambda l: torch.randn(l.shape, generator=g, device=dev), params)
    mask = tree.tree_map(lambda l: torch.rand(l.shape, generator=g, device=dev) < 0.5, params)
    n0 = adam_ops.launches
    p1, st1, u1 = masked_adam.masked_adam_update(
        params, grads, masked_adam.init_state(params), mask)
    assert adam_ops.launches == n0 + 1
    cpu = lambda t: tree.tree_map(lambda l: l.cpu(), t)  # noqa: E731
    p2, st2, u2 = masked_adam.masked_adam_update(
        cpu(params), cpu(grads), cpu(masked_adam.init_state(params)), cpu(mask))
    for a, b in zip(tree.leaves((p1, st1, u1)), tree.leaves((p2, st2, u2))):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["mixed", "ties", "zeros", "nan"])
def test_topk_kernel_exact(dev, case):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 4001)).astype(np.float32)
    if case == "ties":
        x = rng.choice([0.5, -0.5, 2.0, 0.0], size=x.shape).astype(np.float32)
    elif case == "zeros":
        x[:] = 0.0
    elif case == "nan":
        x[:, ::997] = np.nan
    u = {"w": torch.from_numpy(x).to(dev)}
    bits, n = topk_ops.abs_bits_buffer(u)
    k = topk_ops.selection_count(n, 0.05)
    n0 = topk_ops.launches
    thr = topk_ops.topk_threshold_bits(bits, k)
    assert topk_ops.launches == n0 + 1
    assert torch.equal(thr, topk_threshold_bits_ref(bits, k))
    masks = selection.stacked_gradient_guided_masks(u, 0.05)
    cpu = selection.stacked_gradient_guided_masks({"w": u["w"].cpu()}, 0.05)
    assert torch.equal(masks["w"].cpu(), cpu["w"])


def test_topk_kernel_takes_large_sessions(dev):
    """Sessions well above the Pallas kernel's 4M-coordinate budget still go
    through the kernel: it streams from global memory. Above 2**31 - 1
    coordinates its int counts would overflow, and the wrapper raises."""
    g = torch.Generator(device=dev).manual_seed(3)
    u = {"a": torch.randn(2, 3_000_001, generator=g, device=dev),
         "b": torch.randn(2, 1_700, 1_000, generator=g, device=dev)}
    n0 = topk_ops.launches
    masks = selection.stacked_gradient_guided_masks(u, 0.05)
    assert topk_ops.launches == n0 + 1
    bits, n = topk_ops.abs_bits_buffer(u)
    assert n == 4_700_001
    k = topk_ops.selection_count(n, 0.05)
    thr = topk_threshold_bits_ref(bits, k)
    assert torch.equal(topk_ops.topk_threshold_bits(bits, k), thr)
    ref = topk_ops.masks_from_threshold(u, thr)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(masks), tree.leaves(ref)))
    too_big = torch.empty(1, 2**31 // 128, 128, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        topk_ops.topk_threshold_bits(too_big, 1)
