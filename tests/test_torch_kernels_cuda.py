"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests need an NVIDIA GPU with ``nvcc`` (they build the kernels
at first use) and skip on a host without one; on the GPU host run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

K1 (masked Adam) must equal its plain version bit for bit, also with the
trainer's clip fused in (given the gradient-norm kernel's own norm: every
output and the clipped gradients it writes back, at B = 1 and B = 8, in
place, with infinite and NaN gradients and a non-finite norm) and inside
a CUDA graph; the gradient-norm kernel must agree with a float64 norm
within 1e-6 relative and give the same bits twice; K2 (top-k
threshold bits) exactly, with byte-identical masks; K3 (RMSNorm) and K4
(flash attention) within one bf16 ulp (+1e-5) in bfloat16, and within 2e-6
and 2e-5 in float32. K4's bfloat16 cases go through its tensor-core
kernel, its float32 cases through its CUDA-core kernel.

K4 at head dim 112 (Zamba2-7B's shared attention) on both routes: the
bf16 route runs its hd 128 instantiation over 112-wide tensor maps. K4
onto a memory (cross-attention: non-causal, Sq != Skv, Sq under the bf16
kernel's 128-row q tile, one live column in the last kv tile) on both
routes, and one cross-attention block of each kind (Llama-3.2-Vision's
gated ``xattn``, Whisper's ``attn_xattn``) against itself on the CPU.

Also on the card, though no kernel of the port computes them: one Mamba2
and one RWKV6 layer against themselves on the CPU (their scans are plain
torch; their inner norms are K3), the MoE
layer's dispatch (the same routing, positions and keep mask as on the
CPU, outputs within 1e-5 in relative norm in float32, and two runs equal
bit for bit), and the student's ReLU6 gradient at its kinks (0.5, as the JAX package's
``jnp.clip``; ROADMAP F9), whose closed-interval bound below 0 is a
subnormal.

The fused phase's execution shapes (`core/batched.py`): the K loop as one
CUDA graph against the eager loop at B = 3 and 8, bit for bit, on a small
MLP loss and on the student (whose loss/grad is deterministic on the
card: ROADMAP F13). Also K1's launch count under replay (the counter and
a profiler trace of one replay), the auto race's record, no aliasing
between groups replayed through one graph, and `cache_clear` returning
the graphs' memory.

The backward kernels (K4-bwd, K3-bwd) against their plain versions on
the same inputs (K4-bwd on every option the forward takes, q, k, v as
strided views of one projection; float32 within 1e-4 relative + 2e-5 of
the largest |value|, bfloat16 one bf16 ulp + 1e-4 of it), each run twice
bit for bit (no atomics); K4's row log-sum-exp against the plain one and
the forward's output unchanged by writing it; K3 and K4 outputs carrying
a ``grad_fn`` with gradients reaching every input (F11); a float16 input
refused; Gemma 2B's smoke model's loss and gradients under remat on the
card against the CPU (1e-4 relative norm) with the exact launch counts;
`FlatMaskedAdam` in place bit for bit against the tree step.

The wrappers' meta branches (the dry run's) against the CUDA routes at
the paths' shapes: the meta call's outputs have the CUDA call's shapes,
strides and dtypes, and its traced bytes above its arguments are what the
CUDA call allocated (within 2 MiB an allocation: the caching allocator
may hand out a block with a large segment's tail); K3-bwd's dw partial
rows as the C planner sizes them on the card.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.core import masked_adam, selection
from repro_torch.kernels.grad_norm import ops as gnorm_ops
from repro_torch.kernels.grad_norm.ref import grad_norm_ref
from repro_torch.kernels.masked_adam import ops as adam_ops
from repro_torch.kernels.masked_adam.ref import clip_ref, masked_adam_ref
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


def _norm_f64(bufs) -> float:
    return float(sum(b.double().square().sum() for b in bufs).sqrt())


@pytest.mark.parametrize("rows,dtypes", [
    ((1,), (torch.float32,)),
    ((1000, 3, 33333), (torch.bfloat16, torch.float32, torch.float16)),
    ((2613, 8 * 2613), (torch.float32, torch.bfloat16)),
    ((1 << 19,), (torch.bfloat16,)),  # 67M values: the grid strides, unrolled
])
def test_grad_norm_kernel_against_float64_and_deterministic(dev, rows, dtypes):
    g = torch.Generator(device=dev).manual_seed(20)
    bufs = [(torch.randn((1, r, 128), generator=g, device=dev) * 10.0 ** -j).to(dt)
            for j, (r, dt) in enumerate(zip(rows, dtypes))]
    n0 = gnorm_ops.launches
    gn = gnorm_ops.grad_norm(bufs)
    again = gnorm_ops.grad_norm(bufs)
    assert gnorm_ops.launches == n0 + 2
    assert gn.shape == () and gn.dtype == torch.float32 and gn.device == dev
    assert torch.equal(gn.view(torch.int32), again.view(torch.int32))
    truth = _norm_f64(bufs)
    assert abs(float(gn) - truth) <= 1e-6 * truth
    assert abs(float(grad_norm_ref(bufs)) - truth) <= 1e-5 * truth


@pytest.mark.parametrize("bad,want", [(float("inf"), "inf"), (float("nan"), "nan"),
                                      (3e30, "inf")])
def test_grad_norm_kernel_non_finite(dev, bad, want):
    """An infinite or NaN gradient, or squares whose sum overflows float32,
    give the plain version's non-finite norm."""
    a = torch.zeros((1, 40, 128), device=dev)
    b = torch.ones((1, 3, 128), dtype=torch.bfloat16, device=dev)
    a[0, 17, 5] = bad
    if bad == 3e30:
        a[0, 18, :] = bad
    gn, ref = gnorm_ops.grad_norm([a, b]), grad_norm_ref([a, b])
    check = torch.isinf if want == "inf" else torch.isnan
    assert bool(check(gn)) and bool(check(ref))


def _clip_case(dev, b, rows, dtypes, case, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, rows, 128)
    p, gr, m, v = (torch.randn(shape, generator=g, device=dev).to(dt) for dt in dtypes)
    v = v.abs()
    if case == "nonfinite_g":
        flat = gr.view(-1)
        flat[5], flat[-3], flat[flat.numel() // 2] = float("inf"), float("nan"), -float("inf")
    mask = torch.rand(shape, generator=g, device=dev) < 0.3
    _, bc = adam_ops.bias_correction(torch.arange(b, dtype=torch.int32, device=dev) * 3,
                                     lr=1e-3, b1=0.9, b2=0.999)
    if case in ("over", "nonfinite_g"):
        gn = gnorm_ops.grad_norm([gr])  # the kernel's own norm
    elif case == "under":
        gn = gnorm_ops.grad_norm([gr]) * 1e-6  # below the clip: scale 1
    else:
        gn = torch.full((), float(case), device=dev)  # "nan", "inf"
    return p, gr, m, v, mask, bc, gn


@pytest.mark.parametrize("b,rows", [(1, 2613), (8, 2613), (1, 17), (3, 1000)])
@pytest.mark.parametrize("dtypes", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float32,) * 4,
    (torch.float16, torch.float16, torch.float32, torch.float16),
])
@pytest.mark.parametrize("case", ["over", "under", "nonfinite_g", "nan", "inf"])
def test_masked_adam_fused_clip_bitwise_in_place(dev, b, rows, dtypes, case):
    """K1 with the clip, in place (p, m, v, u and the clipped g), against
    `clip_ref` + `masked_adam_ref` on copies of the inputs, given the same
    norm: bit for bit."""
    p, gr, m, v, mask, bc, gn = _clip_case(dev, b, rows, dtypes, case, 21)
    clip = 1.0
    g_want = clip_ref(gr, gn, clip)
    want = masked_adam_ref(p, g_want, m, v, mask, bc, b1=0.9, b2=0.999, eps=1e-8)
    u = torch.empty(p.shape, device=dev)
    n0 = adam_ops.launches
    out = adam_ops.masked_adam_3d(p, gr, m, v, mask, bc, b1=0.9, b2=0.999, eps=1e-8,
                                  out=(p, m, v, u), gn=gn, clip=clip)
    assert adam_ops.launches == n0 + 1 and out[0] is p and out[3] is u
    for k, r in zip((p, m, v, u, gr), (*want, g_want)):
        assert k.dtype == r.dtype and torch.equal(k.view(torch.uint8), r.view(torch.uint8))
    if case in ("nan", "inf"):
        assert not bool(gr.any())
    if case == "nonfinite_g":
        assert bool(torch.isfinite(gr).all())


@pytest.mark.parametrize("b,rows", [(1, 2613), (8, 2613), (1, 1)])
def test_masked_adam_kernel_bitwise_in_place_without_clip(dev, b, rows):
    """No clip: the step in place equals the plain version bit for bit and
    leaves g untouched."""
    p, gr, m, v, mask, bc, _ = _clip_case(
        dev, b, rows, (torch.float32, torch.bfloat16, torch.bfloat16, torch.float32), "over", 22)
    g0 = gr.clone()
    want = masked_adam_ref(p, gr, m, v, mask, bc, b1=0.9, b2=0.999, eps=1e-8)
    u = torch.empty(p.shape, device=dev)
    adam_ops.masked_adam_3d(p, gr, m, v, mask, bc, b1=0.9, b2=0.999, eps=1e-8,
                            out=(p, m, v, u))
    for k, r in zip((p, m, v, u), want):
        assert torch.equal(k.view(torch.uint8), r.view(torch.uint8))
    assert torch.equal(gr, g0)


def test_masked_adam_kernel_in_a_cuda_graph(dev):
    """K1 without the clip captured into a CUDA graph and replayed: the
    eager call's bits."""
    p, gr, m, v, mask, bc, _ = _clip_case(dev, 8, 2613, (torch.float32,) * 4, "over", 23)
    want = adam_ops.masked_adam_3d(p, gr, m, v, mask, bc, b1=0.9, b2=0.999, eps=1e-8)
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(s):
        adam_ops.masked_adam_3d(p, gr, m, v, mask, bc, b1=0.9, b2=0.999, eps=1e-8)
        with torch.cuda.graph(graph, stream=s):
            got = adam_ops.masked_adam_3d(p, gr, m, v, mask, bc, b1=0.9, b2=0.999, eps=1e-8)
    torch.cuda.current_stream(dev).wait_stream(s)
    for t in got:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for k, r in zip(got, want):
        assert torch.equal(k.view(torch.uint8), r.view(torch.uint8))


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


@pytest.mark.parametrize("b,rows,k", [
    (1, 2613, 16_720),    # one session (the sequential path's)
    (13, 40, 1),          # k = 1, sessions not a multiple of anything
    (3, 40, 40 * 128),    # k = n: the smallest value, padding included
    (8, 2613, 334_464),   # k = n at the main shape
])
def test_topk_kernel_k_and_sessions(dev, b, rows, k):
    g = torch.Generator(device=dev).manual_seed(7)
    u = torch.randn(b, rows * 128 - 5, generator=g, device=dev)
    bits, n = topk_ops.abs_bits_buffer({"w": u})
    assert bits.shape == (b, rows, 128)
    n0 = topk_ops.launches
    thr = topk_ops.topk_threshold_bits(bits, k)
    assert topk_ops.launches == n0 + 1
    assert torch.equal(thr, topk_threshold_bits_ref(bits, k))
    if k == 1:
        assert torch.equal(thr.view(torch.float32), u.abs().max(dim=1).values)
    if k == rows * 128:  # the zero padding is the smallest value
        assert not bool(thr.any())


def test_topk_kernel_exactly_k_nonzero(dev):
    """A session with exactly k non-zero values: the threshold is the
    smallest of them; with k + 1 it is 0, as in the counting search."""
    g = torch.Generator(device=dev).manual_seed(8)
    b, rows, k = 3, 300, 1_234
    u = torch.zeros(b, rows * 128, device=dev)
    for i in range(b):
        idx = torch.randperm(rows * 128, generator=g, device=dev)[:k]
        u[i, idx] = torch.randn(k, generator=g, device=dev).abs() + 1e-30
    bits = u.view(torch.int32).reshape(b, rows, 128).contiguous()
    thr = topk_ops.topk_threshold_bits(bits, k)
    assert torch.equal(thr, topk_threshold_bits_ref(bits, k))
    smallest = torch.where(u > 0, u, torch.inf).min(dim=1).values
    assert torch.equal(thr.view(torch.float32), smallest)
    assert torch.equal(topk_ops.topk_threshold_bits(bits, k + 1),
                       torch.zeros(b, dtype=torch.int32, device=dev))


def test_topk_kernel_runs_on_many_blocks(dev):
    """At the main shape the grid holds more than one block per session,
    and the wrapper raises on a k above the coordinates of a session."""
    bits = torch.zeros(8, 2613, 128, dtype=torch.int32, device=dev)
    assert topk_ops.blocks_per_session(bits) > 1
    n0 = topk_ops.launches
    with pytest.raises(ValueError):
        topk_ops.topk_threshold_bits(bits, 2613 * 128 + 1)
    assert topk_ops.launches == n0


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


# ---------------------------------------------------------------------------
# K3 (RMSNorm) and K4 (flash attention), at the Gemma-2 9B path's shapes
# ---------------------------------------------------------------------------


def _within_bf16_ulp(got, want, atol=1e-5):
    """Every value of ``got`` within one bf16 unit in the last place of
    ``want``'s (two float32 results a few float32 roundings apart may
    round to neighbouring bf16 values), plus ``atol`` near zero, where
    float32 sums of O(1) terms cancel."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    return bool(((g - w).abs() <= ulp + atol).all())


def _check_rmsnorm(x, w):
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.rmsnorm.ref import rms_norm_ref

    n0 = norm_ops.launches
    got = norm_ops.rms_norm(x, w)
    assert norm_ops.launches == n0 + 1
    want = rms_norm_ref(x, w)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == x.shape
    if x.dtype == torch.float32:  # sums taken in another order: ~1e-6 relative
        torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-6)
    else:
        assert _within_bf16_ulp(got, want)


@pytest.mark.parametrize("shape,dtype,wdtype,variant", [
    ((16_000, 3584), torch.bfloat16, torch.bfloat16, "warp_per_row"),  # the prefill's rows
    ((2, 1, 3584), torch.bfloat16, torch.bfloat16, "split_row"),       # a decode step's
    ((3, 7, 3584), torch.float32, torch.float32, "split_row"),
    ((5, 33), torch.float32, torch.bfloat16, "block_per_row"),         # ragged d: scalar path
    ((4, 40_000), torch.bfloat16, torch.float32, "block_per_row"),     # d beyond the registers
    ((3000, 1024), torch.float32, torch.bfloat16, "warp_per_row"),
])
def test_rmsnorm_kernel(dev, shape, dtype, wdtype, variant):
    from repro_torch.kernels.rmsnorm import ops as norm_ops

    g = torch.Generator(device=dev).manual_seed(4)
    x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
    w = (torch.randn(shape[-1], generator=g, device=dev) * 0.1).to(wdtype)
    assert norm_ops.variant(x, w) == variant
    _check_rmsnorm(x, w)


@pytest.mark.parametrize("side", [-1, 0])
def test_rmsnorm_kernel_either_side_of_the_row_switch(dev, side):
    """The host takes a warp per row from 16 rows per SM up, a block per
    row split into 16-byte chunks below."""
    from repro_torch.kernels.rmsnorm import ops as norm_ops

    rows = 16 * torch.cuda.get_device_properties(dev).multi_processor_count + side
    g = torch.Generator(device=dev).manual_seed(9)
    x = (torch.randn(rows, 3584, generator=g, device=dev) * 3).to(torch.bfloat16)
    w = (torch.randn(3584, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    assert norm_ops.variant(x, w) == ("split_row" if side < 0 else "warp_per_row")
    _check_rmsnorm(x, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_kernel_unaligned_rows(dev, dtype):
    """A contiguous x that starts one element into its storage is not
    16-byte aligned: it goes element by element."""
    from repro_torch.kernels.rmsnorm import ops as norm_ops

    g = torch.Generator(device=dev).manual_seed(10)
    flat = (torch.randn(64 * 3584 + 1, generator=g, device=dev) * 3).to(dtype)
    x = flat[1:].view(64, 3584)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = (torch.randn(3584, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    assert norm_ops.variant(x, w) == "block_per_row"
    _check_rmsnorm(x, w)


@pytest.mark.parametrize("S,H,KV,hd,window,softcap,dtype", [
    (8000, 16, 8, 256, 4096, 50.0, torch.bfloat16),  # Gemma-2 9B local layer
    (8000, 16, 8, 256, 0, 50.0, torch.bfloat16),     # Gemma-2 9B global layer
    (8000, 16, 16, 128, 0, 0.0, torch.bfloat16),     # Moonlight-16B-A3B (G = 1)
    (1000, 8, 1, 256, 0, 0.0, torch.bfloat16),       # MQA (Gemma 2B)
    (777, 8, 1, 256, 300, 30.0, torch.float32),      # ragged S, window, float32
])
def test_flash_attention_kernel(dev, S, H, KV, hd, window, softcap, dtype):
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B = 2 if S == 8000 else 1
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(B, S, KV, H // KV, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
    n0 = attn_ops.launches
    got = attn_ops.flash_attention(q, k, v, causal=True, window=window, softcap=softcap)
    assert attn_ops.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    # the plain version in pieces of one batch row (its scores are
    # B*H*S*S float32)
    for b in range(B):
        want = flash_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=True,
                                   window=window, softcap=softcap)
        if dtype == torch.float32:  # online vs two-pass softmax, other sums
            torch.testing.assert_close(got[b:b + 1], want, rtol=2e-5, atol=2e-5)
        else:
            assert _within_bf16_ulp(got[b:b + 1], want)


# bfloat16 K4 on the tensor-core route, off the Gemma-2 9B shape: other head
# dims, ragged S, a row whose first visited tile is fully masked,
# non-causal, MQA, and large inputs (q ~ N(0, 42^2), k and v ~ N(0, 21^2):
# scores of ~10^4 before the scale, a mostly saturated softcap). The rare
# rows whose sums nearly cancel, where a kernel with S chained on the
# tensor cores missed the contract, are checked by chip_smoke.py on the
# Gemma-2 prefill's own layer inputs.
@pytest.mark.parametrize("B,S,KV,G,hd,causal,window,softcap,qs,kvs", [
    (1, 1000, 2, 2, 64, True, 0, 50.0, 1, 1),      # hd 64
    (1, 1000, 2, 2, 128, True, 300, 30.0, 1, 1),   # hd 128, window
    (1, 1000, 2, 2, 256, True, 0, 50.0, 1, 1),     # S not a multiple of 128
    (1, 96, 2, 2, 256, True, 20, 50.0, 1, 1),      # a row's first live tile fully masked
    (2, 1000, 2, 2, 256, False, 0, 0.0, 1, 1),     # non-causal
    (1, 1000, 1, 8, 256, True, 0, 0.0, 1, 1),      # MQA
    (1, 1000, 16, 1, 128, True, 0, 0.0, 1, 1),     # hd 128, G = 1, no softcap (Moonlight)
    (2, 3000, 2, 2, 256, True, 0, 50.0, 42, 21),   # Gemma-2's input magnitudes
])
def test_flash_attention_bf16_route(dev, B, S, KV, G, hd, causal, window, softcap,
                                    qs, kvs):
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(6)
    q = (torch.randn(B, S, KV, G, hd, generator=g, device=dev) * qs).to(torch.bfloat16)
    k = (torch.randn(B, S, KV, hd, generator=g, device=dev) * kvs).to(torch.bfloat16)
    v = (torch.randn(B, S, KV, hd, generator=g, device=dev) * kvs).to(torch.bfloat16)
    kw = dict(causal=causal, window=window, softcap=softcap)
    n0, r0 = attn_ops.launches, attn_ops.launches_by_route["bf16_wgmma"]
    got = attn_ops.flash_attention(q, k, v, **kw)
    assert attn_ops.launches == n0 + 1
    assert attn_ops.launches_by_route["bf16_wgmma"] == r0 + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    assert _within_bf16_ulp(got, flash_attention_ref(q, k, v, **kw))


@pytest.mark.parametrize("B,S,KV,G,causal,window,softcap,dtype", [
    (2, 8000, 32, 1, True, 0, 0.0, torch.bfloat16),     # Zamba2-7B's shared attention
    (1, 1000, 2, 2, False, 0, 0.0, torch.bfloat16),     # non-causal
    (1, 333, 4, 1, True, 100, 50.0, torch.bfloat16),    # ragged S, window, softcap
    (1, 777, 1, 4, True, 300, 30.0, torch.float32),     # ragged S on the CUDA cores
    (2, 1000, 2, 2, False, 0, 0.0, torch.float32),      # non-causal on the CUDA cores
])
def test_flash_attention_head_dim_112(dev, B, S, KV, G, causal, window, softcap, dtype):
    """Head dim 112 on both routes against the plain version (one batch
    row at a time): bf16 within one bf16 ulp, float32 within 2e-5; the
    launch counted on the route of its dtype."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    hd = 112
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(B, S, KV, G, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    route = attn_ops.ROUTES[dtype][0]
    n0, r0 = attn_ops.launches, attn_ops.launches_by_route[route]
    got = attn_ops.flash_attention(q, k, v, **kw)
    assert attn_ops.launches == n0 + 1 and attn_ops.launches_by_route[route] == r0 + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    for b in range(B):
        want = flash_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw)
        if dtype == torch.float32:
            torch.testing.assert_close(got[b:b + 1], want, rtol=2e-5, atol=2e-5)
        else:
            assert _within_bf16_ulp(got[b:b + 1], want)


# K4 attending onto a memory: non-causal with Sq != Skv, as cross-attention
# calls it (Whisper's decoder: 64 queries over 1,500 encoder frames at hd 64
# and G = 1, a q tile of 64 under the kernel's 128 rows; Llama-3.2-Vision:
# queries over 1,601 patch embeddings, one live column in the last kv tile,
# at hd 128 and G = 8), scaled down in batch and heads; then Sq below 128
# and ragged on both sides, and Whisper's decoder self-attention (causal,
# Sq = Skv = 64).
@pytest.mark.parametrize("B,Sq,Skv,KV,G,hd,causal", [
    (2, 64, 1500, 4, 1, 64, False),     # Whisper's cross-attention
    (1, 1000, 1601, 2, 8, 128, False),  # Llama-3.2-Vision's
    (1, 40, 37, 2, 2, 64, False),       # Sq < 128, both ragged, Skv < Sq
    (3, 1, 1601, 1, 8, 128, False),     # one query row
    (2, 64, 64, 4, 1, 64, True),        # Whisper's decoder self-attention
    (1, 1500, 1500, 4, 1, 64, False),   # Whisper's encoder
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_over_a_memory(dev, B, Sq, Skv, KV, G, hd, causal, dtype):
    """Against the plain version: bf16 within one bf16 ulp, float32 within
    2e-5; the launch counted on the route of its dtype. A q that is a slice
    of a taller buffer (rows past Sq hold other data, which the bf16
    kernel's 128-row q box must not read) gives what its contiguous copy
    gives."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn(B, Sq, KV, G, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Skv, KV, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Skv, KV, hd, generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, window=0, softcap=0.0)
    route = attn_ops.ROUTES[dtype][0]
    n0, r0 = attn_ops.launches, attn_ops.launches_by_route[route]
    got = attn_ops.flash_attention(q, k, v, **kw)
    assert attn_ops.launches == n0 + 1 and attn_ops.launches_by_route[route] == r0 + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    want = flash_attention_ref(q, k, v, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert _within_bf16_ulp(got, want)
    big = torch.randn(B, Sq + 64, KV, G, hd, generator=g, device=dev).to(dtype) * 100
    got2 = attn_ops.flash_attention(big[:, :Sq], k, v, **kw)
    assert torch.equal(got2, attn_ops.flash_attention(big[:, :Sq].contiguous(), k, v, **kw))


def test_flash_attention_bf16_near_hard_max_as_close_to_float64_as_plain(dev):
    """Large scores without a softcap (q ~ N(0, 42^2), k and v ~ N(0,
    21^2): scores of ~1e4 before the scale) make the softmax nearly a hard
    max, and outputs that mix two keys cancel: there the float32 plain
    version is itself many bf16 ulps from the float64 value, so one ulp of
    it cannot be asked. K4 must put no more outputs than the plain version
    more than one bf16 ulp (+1e-5) from attention in float64."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(6)
    B, S, KV, hd = 2, 1500, 16, 128
    q = (torch.randn(B, S, KV, 1, hd, generator=g, device=dev) * 42).to(torch.bfloat16)
    k = (torch.randn(B, S, KV, hd, generator=g, device=dev) * 21).to(torch.bfloat16)
    v = (torch.randn(B, S, KV, hd, generator=g, device=dev) * 21).to(torch.bfloat16)
    got = attn_ops.flash_attention(q, k, v, causal=True, window=0, softcap=0.0).double()
    want = flash_attention_ref(q, k, v, causal=True).double()
    s = torch.einsum("bqkgh,bskh->bkgqs", q.double(), k.double()) * hd**-0.5
    s.masked_fill_(~torch.ones(S, S, dtype=torch.bool, device=dev).tril(), -1e300)
    truth = torch.einsum("bkgqs,bskh->bqkgh", torch.softmax(s, dim=-1), v.double())
    ulp = torch.exp2(torch.floor(torch.log2(truth.abs().clamp_min(1e-30))) - 7)
    kernel_off = int(((got - truth).abs() > ulp + 1e-5).sum())
    plain_off = int(((want - truth).abs() > ulp + 1e-5).sum())
    assert plain_off > 0  # the case is as ill-conditioned as described
    assert kernel_off <= plain_off, (kernel_off, plain_off)


def test_flash_attention_bf16_rejects_strides_tma_cannot_take(dev):
    """A row stride that is not a multiple of 16 bytes, or a stride of 0
    (an expanded batch), has no tensor map: the wrapper raises before any
    launch."""
    from repro_torch.kernels.flash_attention import ops as attn_ops

    q = torch.zeros(1, 64, 2, 2, 64, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=dev)
    padded = torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16, device=dev)[..., :64]
    expanded = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16,
                           device=dev).expand(2, 64, 2, 64)
    n0 = attn_ops.launches
    with pytest.raises(ValueError):
        attn_ops.flash_attention(q, padded, k)
    with pytest.raises(ValueError):
        attn_ops.flash_attention(q.expand(2, *q.shape[1:]), expanded, expanded)
    assert attn_ops.launches == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_student_relu6_gradient_at_the_kinks(dev, dtype):
    from repro_torch.models.seg.student import _ReLU6

    x = torch.tensor([-7.0, -1e-30, -0.0, 0.0, 1e-30, 3.0, 6.0, 9.0], dtype=dtype,
                     device=dev, requires_grad=True)
    y = _ReLU6.apply(x)
    y.sum().backward()
    assert torch.equal(y.detach(), torch.clamp(x.detach(), 0.0, 6.0))
    assert x.grad.tolist() == [0.0, 0.0, 0.5, 0.5, 1.0, 1.0, 0.5, 0.0]


@pytest.mark.parametrize("mode", ["loop", "graph"])
def test_train_many_fuses_on_the_card_with_exact_launches(dev, mode):
    """Two width-1.0 serving sessions co-trained by `serving.train_many`
    on the pool slot's card: the first phase (random masks) launches K1
    K times at B = 2 and no K2; the second runs one stacked selection (K2
    once, its three digit passes counted as one launch) and K1 K times
    again. Under ``graph`` the first phase also warms one iteration before
    its capture (one more K1), and every replay counts its K launches.
    The deltas land on the edges, which stay on the card."""
    from repro_torch.core import batched
    from repro_torch.core.server import AMSConfig
    from repro_torch.models.seg.student import SegConfig, make_student
    from repro_torch.serving import GPUPool, train_many
    from repro_torch.sim.multiclient import build_sessions

    seg = SegConfig(n_classes=5, width=1.0)
    ams = AMSConfig(t_update=5.0, t_horizon=20.0, k_iters=4, batch_size=4,
                    gamma=0.05, lr=2e-3)
    sessions = build_sessions(2, make_student(seg, 0, dev), seg, ams,
                              duration=20.0,
                              video_kw=dict(height=64, width=64, fps=2.0))
    slot = GPUPool(1, device_backend="torch").device(0).torch_device
    assert slot == dev
    for s in sessions:
        s.label_and_ingest(list(range(8)), 4.0)
    info0 = batched.update_pipeline_info()
    batched.cache_clear()
    batched.set_exec_mode(mode)
    try:
        for t, k2, warm in ((5.0, 0, 1), (10.0, 1, 0)):
            adam_ops.launches = topk_ops.launches = 0
            deltas = train_many(sessions, t, device=slot)
            torch.cuda.synchronize()
            extra = warm if mode == "graph" else 0
            assert (adam_ops.launches, topk_ops.launches) == (ams.k_iters + extra, k2)
            for s, d in zip(sessions, deltas):
                s.apply_delta(d, t, t + 1.0)
    finally:
        batched.set_exec_mode("auto")
        batched.cache_clear()
    info = batched.update_pipeline_info()
    assert info["stacked_select_launches"] - info0["stacked_select_launches"] == 1
    assert info["stacked_encode_sessions"] - info0["stacked_encode_sessions"] == 4
    for s in sessions:
        assert s.phases == 2
        assert all(l.device == dev for l in tree.leaves(
            (s.session.params, s.session.opt_state, s.edge.active)))
        s.evaluate(12.0)
        assert 0.0 <= s.mious[-1] <= 1.0


def _phase_inputs(dev, b, k=3, hw=32, seed=0):
    """A B-stacked width-1.0 student group on the card: params, Adam state
    at different step counts, a 5% mask, K seeded batches of 4 frames."""
    from repro_torch.core import batched
    from repro_torch.models.seg.student import SegConfig, make_student
    from repro_torch.sim.seg_world import SegWorld

    seg = SegConfig(n_classes=5, width=1.0)
    lg = SegWorld(video=None, teacher=None, seg_cfg=seg).loss_and_grad
    params = batched.stack_trees([make_student(seg, seed + i, dev) for i in range(b)])
    st = masked_adam.init_state(params)
    opt = st._replace(count=torch.arange(b, dtype=torch.int32, device=dev) * 3)
    rng = np.random.default_rng(seed)
    mask = tree.tree_map(lambda l: torch.from_numpy(rng.random(l.shape) < 0.05).to(dev),
                         params)
    frames = torch.from_numpy(rng.random((k, b, 4, hw, hw, 3), np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 5, (k, b, 4, hw, hw), np.int32)).to(dev)
    return lg, (params, opt, mask, frames, labels)


def _runner(lg, args, mode):
    from repro_torch.core import batched

    batched.set_exec_mode(mode)
    try:
        return batched.fused_phase_fn(
            lg, struct=tree.struct(args), k_iters=args[3].shape[0], optimizer="adam",
            lr=2e-3, b1=0.9, b2=0.999, eps=1e-8, momentum=0.9, device=args[3].device)
    finally:
        batched.set_exec_mode("auto")


def _fp16_ulps(a, b):
    def key(x):
        i = x.to(torch.float16).view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return (key(a) - key(b)).abs()


def _bitwise(x, y):
    return all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(tree.leaves(x), tree.leaves(y)))


def _mlp_loss_and_grad(params, frames, labels):
    """A loss whose gradient has no atomics (matrix products, tanh, a
    mean), so two eager runs agree bit for bit."""
    def loss(p):
        x = frames.reshape(frames.shape[0], -1)[:, :96]
        y = labels.reshape(labels.shape[0], -1)[:, :5].to(torch.float32)
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return ((h @ p["w2"] - y) ** 2).mean()

    grads, value = torch.func.grad_and_value(loss)(params)
    return value, grads


def _mlp_inputs(dev, b, k=3):
    rng = np.random.default_rng(b)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(dev)

    params = {"w1": t(b, 96, 64, scale=0.1), "b1": t(b, 64, scale=0.1),
              "w2": t(b, 64, 5, scale=0.1)}
    opt = masked_adam.init_state(params)._replace(
        count=torch.arange(b, dtype=torch.int32, device=dev))
    mask = tree.tree_map(lambda l: torch.from_numpy(rng.random(l.shape) < 0.3).to(dev),
                         params)
    frames = torch.from_numpy(rng.random((k, b, 4, 8, 8, 3), np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 5, (k, b, 4, 8, 8), np.int32)).to(dev)
    return _mlp_loss_and_grad, (params, opt, mask, frames, labels)


@pytest.mark.parametrize("b", [3, 8])
def test_graph_phase_is_the_loop_bitwise(dev, b):
    """The graph replays the eager loop's kernels in the same order: where
    two eager runs agree bit for bit, the graph agrees with them too."""
    from repro_torch.core import batched

    batched.cache_clear()
    lg, args = _mlp_inputs(dev, b)
    loop, graph = _runner(lg, args, "loop"), _runner(lg, args, "graph")
    out_l1, out_l2 = loop(*args), loop(*args)
    out_g1, out_g2 = graph(*args), graph(*args)
    torch.cuda.synchronize()
    assert _bitwise(out_l1, out_l2)  # the premise: this loss is deterministic
    assert _bitwise(out_g1, out_l1) and _bitwise(out_g2, out_l1)
    batched.cache_clear()


@pytest.mark.parametrize("b", [3, 8])
def test_graph_phase_on_the_student_is_the_loop_bitwise(dev, b):
    """The student's loss/grad is deterministic on the card (its upsample
    is matrix products, its convolutions cuDNN's deterministic algorithms;
    ROADMAP F13): two eager runs of a phase agree bit for bit, and two
    replays of its graph agree with them."""
    from repro_torch.core import batched

    batched.cache_clear()
    lg, args = _phase_inputs(dev, b)
    loop, graph = _runner(lg, args, "loop"), _runner(lg, args, "graph")
    out_l1, out_l2 = loop(*args), loop(*args)
    out_g1, out_g2 = graph(*args), graph(*args)
    torch.cuda.synchronize()
    assert _bitwise(out_l1, out_l2)
    assert _bitwise(out_g1, out_l1) and _bitwise(out_g2, out_l1)
    for a in tree.leaves(out_g1):
        assert bool(torch.isfinite(a.float()).all())
    batched.cache_clear()


def test_graph_replay_counts_k1_launches_exactly(dev):
    from repro_torch.core import batched

    batched.cache_clear()
    lg, args = _phase_inputs(dev, 3, k=5)
    graph = _runner(lg, args, "graph")
    info0 = batched.exec_info()
    adam_ops.launches = 0
    graph(*args)
    torch.cuda.synchronize()
    assert adam_ops.launches == 5 + 1  # one warm-up iteration, one replay
    pad = torch.zeros(1, device=dev)
    for n in (2, 3):
        # the tracer drops records from the end of a trace that stops right
        # after the work; small launches and a pause take that tail (see
        # chip_smoke.py)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            graph(*args)
            torch.cuda.synchronize()
            for _ in range(512):
                pad.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.2)
        assert adam_ops.launches == 5 * n + 1
        # what the counter adds per replay is what the device ran
        assert sum(ev.device_type == torch.autograd.DeviceType.CUDA
                   and "masked_adam_kernel" in ev.name for ev in prof.events()) == 5
    info = batched.exec_info()
    assert {k: info[k] - info0[k] for k in info} == {
        "loop_runs": 0, "graph_captures": 1, "graph_replays": 3, "warm_iters": 1}
    batched.cache_clear()


def test_auto_race_records_a_winner_and_both_times(dev):
    from repro_torch.core import batched

    batched.cache_clear()
    lg, args = _phase_inputs(dev, 3)
    adam_ops.launches = 0
    race = _runner(lg, args, "auto")
    out = race(*args)
    torch.cuda.synchronize()
    # 1 warm + 2 timed runs of each shape, and the capture's warm-up step
    assert adam_ops.launches == 3 * 6 + 1
    ((backend, key), rec), = batched.race_info().items()
    assert backend == "cuda" and rec["winner"] in ("graph", "loop")
    assert rec["graph_s"] > 0 and rec["loop_s"] > 0
    assert rec["winner"] == min(("graph", "loop"), key=lambda m: (rec[f"{m}_s"], m))
    assert batched.auto_mode_info() == {(backend, key): rec["winner"]}
    assert batched.cache_info() == {"size": 1, "hits": 0, "misses": 1}
    again = _runner(lg, args, "auto")
    assert batched.cache_info() == {"size": 1, "hits": 1, "misses": 1}
    assert len(tree.leaves(again(*args))) == len(tree.leaves(out))
    batched.cache_clear()


def test_groups_through_one_graph_do_not_alias(dev):
    """The second group's replay overwrites the graph's outputs; the first
    group's results were cloned out and keep their values."""
    from repro_torch.core import batched

    batched.cache_clear()
    lg, args1 = _phase_inputs(dev, 3, seed=0)
    _, args2 = _phase_inputs(dev, 3, seed=10)
    graph = _runner(lg, args1, "graph")
    assert _runner(lg, args2, "graph") is graph  # one compile key
    out1 = graph(*args1)
    kept = tree.tree_map(torch.clone, out1)
    out2 = graph(*args2)
    torch.cuda.synchronize()
    assert _bitwise(out1, kept)
    assert not _bitwise(out1[0], out2[0])
    batched.cache_clear()


def test_cache_clear_returns_the_graph_memory(dev):
    from repro_torch.core import batched

    batched.cache_clear()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(dev)
    lg, args = _phase_inputs(dev, 8, hw=64)
    graph = _runner(lg, args, "graph")
    graph(*args)
    torch.cuda.synchronize()
    del args
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(dev)
    assert held > base  # the graph's pool and static buffers
    del graph
    batched.cache_clear()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(dev) < held
    assert torch.cuda.memory_reserved(dev) <= base + (held - base) // 4


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x22b"])
def test_moe_on_the_card(dev, arch):
    """`moe_apply` on the card: against itself on the CPU in float32 (in
    norm: cuBLAS sums in another order; the routing and positions are held
    equal first), and twice on the card, bit for bit: the dispatch writes
    each kept (expert, position) row once, so nothing depends on the order
    of atomics."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import moe
    from repro_torch.models.common import init_params

    cfg = get_smoke(arch).replace(capacity_factor=1.0)
    params = init_params(moe.moe_metas(cfg), torch.Generator().manual_seed(0),
                         torch.float32, torch.device("cpu"))
    x = torch.randn(2, 256, cfg.d_model, generator=torch.Generator().manual_seed(1))
    want, aux_want = moe.moe_apply(cfg, params, x)
    params_d = {k: (v.to(dev) if isinstance(v, torch.Tensor)
                    else {kk: vv.to(dev) for kk, vv in v.items()})
                for k, v in params.items()}
    x_d = x.to(dev)
    _, idx, _ = moe._route(cfg, params, x.reshape(-1, cfg.d_model))
    _, idx_d, _ = moe._route(cfg, params_d, x_d.reshape(-1, cfg.d_model))
    assert torch.equal(idx_d.cpu(), idx)
    pos, keep = moe.dispatch(cfg, idx)
    pos_d, keep_d = moe.dispatch(cfg, idx_d)
    assert torch.equal(pos_d.cpu(), pos) and torch.equal(keep_d.cpu(), keep)
    assert (~keep).any()
    got, aux = moe.moe_apply(cfg, params_d, x_d)
    again, aux_again = moe.moe_apply(cfg, params_d, x_d)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(aux, aux_again)
    rel = float((got.cpu() - want).norm() / want.norm())
    assert rel < 1e-5, rel
    assert abs(float(aux) - float(aux_want)) < 1e-5


def _to(params, dev):
    from repro_torch import tree

    return tree.tree_map(lambda t: t.to(dev), params)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_recurrent_layer_on_the_card(dev, arch):
    """One Mamba2 block (Zamba2-7B's widths: d_model 3584, d_inner 7168,
    d_state 64; 300 tokens, chunks of 100 and 3 decode steps) and one
    RWKV6 block (RWKV6-3B's: d_model 2560, 40 heads of 64; 200 tokens,
    chunks of 64 shrunk to 50) on the card against the same block on the
    CPU, in float32 (in relative norm, 1e-5: cuBLAS and the reductions sum
    in another order), with the prefill's hand-off state and the decode
    steps; the inner norm launches K3 once a call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import init_params

    cfg = get_config(arch, num_layers=len(get_config(arch).pattern), param_dtype="float32",
                     compute_dtype="float32")
    kind = cfg.pattern[0]
    metas = tfm.block_metas(cfg, kind)
    params = init_params(metas, torch.Generator().manual_seed(0), torch.float32,
                         torch.device("cpu"))
    if kind == "mamba":  # decays of a few steps, as a trained model has
        params["mamba"]["a_log"].normal_(0.0, 0.5, generator=torch.Generator().manual_seed(1))
    S = 300 if kind == "mamba" else 200
    x = torch.randn(2, S + 3, cfg.d_model, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(S).expand(2, S)

    def run(p, xs):  # K3 takes contiguous rows, as the model hands it
        out, _, cache = tfm.block_apply(cfg, kind, p, xs[:, :S].contiguous(),
                                        positions=pos.to(xs.device), want_cache=True)
        outs = [out]
        for t in range(S, S + 3):
            o, new = tfm.block_decode(cfg, kind, p, xs[:, t:t + 1].contiguous(), cache, t)
            cache = dict(cache, **new)
            outs.append(o)
        return torch.cat(outs, dim=1), cache

    want, cache_want = run(params, x)
    n0 = norm_ops.launches
    got, cache_got = run(_to(params, dev), x.to(dev))
    torch.cuda.synchronize()
    # a call: Mamba2's ln1 and inner norm; RWKV6's ln_x (its block norms
    # are LayerNorm); 1 prefill + 3 decode calls
    assert norm_ops.launches - n0 == {"mamba": 2, "rwkv": 1}[kind] * 4
    for a, b in [(got, want)] + [(cache_got[k], cache_want[k]) for k in cache_want]:
        a = a.cpu()
        assert torch.isfinite(a).all()
        rel = float((a - b).norm() / b.norm())
        assert rel < 1e-5, rel


@pytest.mark.parametrize("arch,kind", [("llama-3.2-vision-90b", "xattn"),
                                       ("whisper-large-v3", "attn_xattn")])
def test_cross_attention_block_on_the_card(dev, arch, kind):
    """One gated cross-attention block (Llama-3.2-Vision's heads: 64 of 128
    over 8 KV heads, at d_model 1,024 and d_ff 2,048 instead of 8,192 and
    28,672; 200 tokens over 1,601 patch embeddings; the gate at 1.0) and
    one Whisper decoder block (its full widths: d_model 1,280, 20 heads of
    64; 64 tokens over 1,500 frames) on the card against the same block on
    the CPU, in float32 (in relative norm, 1e-5: cuBLAS and the reductions
    sum in another order; the attention projections drawn at fan-in
    d_model), with the prefill's caches (the memory's K/V, and Whisper's
    self K/V) and 2 decode steps that read the cross cache. K4
    launches once per attention of the prefill (1 and 2), on its float32
    route; K3 twice a call where the norms are RMSNorm (Llama), never for
    Whisper's LayerNorm."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import init_params

    narrow = dict(d_model=1024, d_ff=2048) if kind == "xattn" else {}
    cfg = get_config(arch, param_dtype="float32", compute_dtype="float32", **narrow)
    params = init_params(tfm.block_metas(cfg, kind), torch.Generator().manual_seed(0),
                         torch.float32, torch.device("cpu"))
    if kind == "xattn":
        params["gate"].fill_(1.0)
    # the attention projections at fan-in d_model: the init's fan-in (G for
    # wq, KV for wk and wv) leaves the softmax nearly a hard max, where
    # float32 runs on the two devices part by ~1e-4 in relative norm
    g = cfg.num_heads // cfg.num_kv_heads
    for sub in ("attn", "xattn"):
        if sub in params:
            params[sub]["wq"].mul_((g / cfg.d_model) ** 0.5)
            params[sub]["wk"].mul_((cfg.num_kv_heads / cfg.d_model) ** 0.5)
            params[sub]["wv"].mul_((cfg.num_kv_heads / cfg.d_model) ** 0.5)
    S, n_dec = (200 if kind == "xattn" else 64), 2
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, S + n_dec, cfg.d_model, generator=gen)
    mem = torch.randn(2, cfg.num_xattn_tokens, cfg.d_model, generator=gen)
    pos = torch.arange(S).expand(2, S)

    def run(p, xs, memory):
        out, _, cache = tfm.block_apply(cfg, kind, p, xs[:, :S].contiguous(),
                                        positions=pos.to(xs.device), memory=memory,
                                        want_cache=True)
        for key in ("k", "v"):  # self K/V padded to the decode length
            if key in cache:
                c = cache[key]
                cache[key] = torch.zeros((2, S + n_dec) + tuple(c.shape[2:]), device=c.device)
                cache[key][:, :S] = c
        outs = [out]
        for t in range(S, S + n_dec):
            o, cache = tfm.block_decode(cfg, kind, p, xs[:, t:t + 1].contiguous(), cache, t)
            outs.append(o)
        return torch.cat(outs, dim=1), cache

    want, cache_want = run(params, x, mem)
    n3, n4 = norm_ops.launches, attn_ops.launches
    r4 = attn_ops.launches_by_route["f32_cuda_cores"]
    got, cache_got = run(_to(params, dev), x.to(dev), mem.to(dev))
    torch.cuda.synchronize()
    n_attn = 1 if kind == "xattn" else 2
    assert attn_ops.launches - n4 == n_attn
    assert attn_ops.launches_by_route["f32_cuda_cores"] - r4 == n_attn
    assert norm_ops.launches - n3 == (2 * (1 + n_dec) if kind == "xattn" else 0)
    assert sorted(cache_got) == sorted(cache_want)
    assert cache_got["xk"].shape[1] == cfg.num_xattn_tokens
    for a, b in [(got, want)] + [(cache_got[k], cache_want[k]) for k in cache_want]:
        a = a.cpu()
        assert torch.isfinite(a).all()
        rel = float((a - b).norm() / b.norm())
        assert rel < 1e-5, (a.shape, rel)


# ---------------------------------------------------------------------------
# The backward kernels (K4-bwd, K3-bwd) and the training path on the card
# ---------------------------------------------------------------------------


def _close_bf16_or_f32(got, want):
    """float32: within 1e-4 relative and 2e-5 of the largest |value| (the
    kernel and the plain version sum in other orders; dq and dk cancel);
    bfloat16: one bf16 ulp plus 1e-4 of the largest |value|."""
    scale = float(want.float().abs().max())
    if want.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5 * scale)
    else:
        assert _within_bf16_ulp(got, want, atol=1e-4 * scale)


# every option the forward takes: causal or not, window, softcap, G 1/2/8,
# Sq != Skv, hd 64/112/128/256, bf16 and float32
BWD_CASES = [  # B, Sq, Skv, KV, G, hd, causal, window, softcap, dtype
    (2, 2048, 2048, 1, 8, 256, True, 0, 0.0, torch.bfloat16),  # the Gemma 2B trainer's
    (2, 256, 256, 1, 8, 256, True, 0, 0.0, torch.bfloat16),    # Gemma 2B's heads
    (1, 300, 300, 2, 2, 256, True, 0, 50.0, torch.bfloat16),   # softcap, ragged S
    (1, 300, 300, 2, 2, 128, True, 64, 30.0, torch.bfloat16),  # window + softcap
    (2, 200, 200, 4, 1, 64, False, 0, 0.0, torch.bfloat16),    # non-causal, G = 1
    (1, 100, 333, 2, 2, 112, False, 0, 0.0, torch.bfloat16),   # Sq != Skv, hd 112
    (1, 333, 100, 1, 8, 128, True, 0, 0.0, torch.bfloat16),    # Sq > Skv, causal
    (1, 96, 96, 2, 2, 256, True, 20, 50.0, torch.float32),     # a fully masked first tile
    (1, 257, 257, 1, 8, 112, True, 0, 0.0, torch.float32),
    (2, 130, 70, 2, 2, 64, False, 0, 20.0, torch.float32),
]


@pytest.mark.parametrize("B,Sq,Skv,KV,G,hd,causal,window,softcap,dtype", BWD_CASES)
def test_flash_attention_bwd_kernel(dev, B, Sq, Skv, KV, G, hd, causal, window, softcap,
                                    dtype):
    """dq, dk, dv from the backward kernel against the plain backward on the
    same q, k, v, output, log-sum-exp and dO; q, k and v are strided views
    of one projection, as in the model; two runs equal bit for bit. bf16
    goes through the wgmma kernels, float32 through the CUDA-core ones."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    g = torch.Generator(device=dev).manual_seed(11)
    qkv = torch.randn(B, max(Sq, Skv), KV, G + 2, hd, generator=g, device=dev).to(dtype)
    q, k, v = qkv[:, :Sq, :, :G], qkv[:, :Skv, :, G], qkv[:, :Skv, :, G + 1]
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = attn_ops._forward(q, k, v, causal, window, softcap, want_lse=True)
    do = torch.randn(out.shape, generator=g, device=dev).to(dtype)
    route = attn_ops.BWD_ROUTES[dtype][0]
    assert route == ("bf16_wgmma" if dtype == torch.bfloat16 else "f32_cuda_cores")
    n0, r0 = attn_ops.bwd_launches, attn_ops.bwd_launches_by_route[route]
    got = attn_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = attn_ops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    assert attn_ops.bwd_launches == n0 + 2
    assert attn_ops.bwd_launches_by_route[route] == r0 + 2
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for a, b, c, x in zip(got, again, want, (q, k, v)):
        assert a.shape == x.shape and a.dtype == dtype
        assert torch.equal(a, b)
        assert torch.isfinite(a.float()).all()
        _close_bf16_or_f32(a, c)


@pytest.mark.parametrize("B,S,KV,G,hd,causal,window,softcap", [
    (2, 300, 2, 2, 128, True, 64, 30.0),
    (2, 2048, 1, 8, 256, True, 0, 0.0),    # the Gemma 2B trainer's
    (1, 300, 2, 2, 64, False, 0, 20.0),
    (1, 257, 4, 1, 112, True, 32, 0.0),
])
def test_flash_attention_lse_matches_the_plain_version(dev, B, S, KV, G, hd, causal, window,
                                                       softcap):
    """The forward's row log-sum-exp against the plain version's, for each
    head-dim instantiation of both routes; the output is the same with and
    without the log-sum-exp store."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    g = torch.Generator(device=dev).manual_seed(12)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(B, S, KV, G, hd, generator=g, device=dev).to(dtype)
        k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
        v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
        out, lse = attn_ops._forward(q, k, v, causal, window, softcap, want_lse=True)
        plain = attn_ops._forward(q, k, v, causal, window, softcap, want_lse=False)[0]
        _, want = flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                                      return_lse=True)
        assert torch.equal(out, plain)  # the LSE store leaves the output alone
        torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,dtype,wdtype,variant", [
    ((4096, 2048), torch.bfloat16, torch.bfloat16, "warp_per_row"),  # the Gemma 2B trainer's
    ((3000, 1024), torch.float32, torch.bfloat16, "warp_per_row"),   # the longest f32 row
    ((5, 64), torch.bfloat16, torch.float32, "warp_per_row"),        # few rows, short ones
    ((3, 7, 3584), torch.float32, torch.float32, "block_per_row"),   # past the registers
    ((300, 1001), torch.bfloat16, torch.float32, "block_per_row"),   # ragged d
    ((2, 16384), torch.float32, torch.bfloat16, "block_per_row"),    # past 48 KB of smem
])
def test_rmsnorm_bwd_kernel(dev, shape, dtype, wdtype, variant):
    """Both row-pass variants of K3-bwd against the plain backward; two runs
    equal bit for bit."""
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.rmsnorm.ref import rms_norm_bwd_ref

    g = torch.Generator(device=dev).manual_seed(13)
    x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
    w = (torch.randn(shape[-1], generator=g, device=dev) * 0.1).to(wdtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    assert norm_ops.bwd_variant(x, w, dy) == variant
    n0 = norm_ops.bwd_launches
    dx, dw = norm_ops.rms_norm_bwd(x, w, dy)
    dx2, dw2 = norm_ops.rms_norm_bwd(x, w, dy)
    assert norm_ops.bwd_launches == n0 + 2
    want_dx, want_dw = rms_norm_bwd_ref(x, w, dy)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert dx.dtype == dtype and dw.dtype == wdtype
    _close_bf16_or_f32(dx, want_dx)
    _close_bf16_or_f32(dw, want_dw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_outputs_carry_a_grad_fn_and_gradients_reach_every_input(dev, dtype):
    """K3 and K4 on CUDA tensors that require grad: the outputs have a
    ``grad_fn``, backward launches the backward kernels (their counters),
    and every input gets its gradient from them."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops

    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn(2, 64, 256, generator=g, device=dev).to(dtype).requires_grad_()
    w = (0.1 * torch.randn(256, generator=g, device=dev)).to(dtype).requires_grad_()
    wq = (torch.randn(256, 2, 2, 64, generator=g, device=dev) / 16).to(dtype).requires_grad_()
    wk = (torch.randn(256, 2, 64, generator=g, device=dev) / 16).to(dtype).requires_grad_()
    wv = (torch.randn(256, 2, 64, generator=g, device=dev) / 16).to(dtype).requires_grad_()
    n = (norm_ops.launches, norm_ops.bwd_launches, attn_ops.launches, attn_ops.bwd_launches)
    h = norm_ops.rms_norm(x, w)
    o = attn_ops.flash_attention(torch.einsum("bsd,dkgh->bskgh", h, wq),
                                 torch.einsum("bsd,dkh->bskh", h, wk),
                                 torch.einsum("bsd,dkh->bskh", h, wv), softcap=50.0)
    assert h.grad_fn is not None and o.grad_fn is not None
    o.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (norm_ops.launches, norm_ops.bwd_launches, attn_ops.launches,
            attn_ops.bwd_launches) == (n[0] + 1, n[1] + 1, n[2] + 1, n[3] + 1)
    for t in (x, w, wq, wk, wv):
        assert t.grad is not None and torch.isfinite(t.grad.float()).all()
        assert bool((t.grad != 0).any())


def test_kernel_backward_refuses_what_it_does_not_take(dev):
    """No CUDA route falls back: a float16 input that requires grad raises in
    the forward, before any graph is built."""
    from repro_torch.kernels.flash_attention import ops as attn_ops

    q = torch.randn(1, 16, 1, 1, 64, device=dev, dtype=torch.float16, requires_grad=True)
    k = torch.randn(1, 16, 1, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        attn_ops.flash_attention(q, k, k)


def test_smoke_llm_gradients_on_the_card_match_the_cpu(dev):
    """Gemma 2B's smoke config (MQA, G = 4, hd 32 widened to 64 for the
    kernels) with ``remat``: the loss and every leaf's gradient on the card
    (K3, K4 and their backward kernels, float32 routes) against the CPU
    (their plain versions), within 1e-4 in relative norm; K3/K4 launch
    counts with the recomputation. The attention projections are drawn at
    fan-in d_model: at the init's fan-in (G for ``wq``, KV for ``wk`` and
    ``wv``) the softmax is nearly a hard max, and the embedding's gradient
    parted by 2.0e-4 in relative norm between the two devices' float32
    sums (the first card run of this test)."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.models.registry import build

    cfg = get_smoke("gemma-2b", head_dim=64, remat=True)
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    attn = params["groups"]["b0"]["attn"]
    g = cfg.num_heads // cfg.num_kv_heads
    attn["wq"].mul_((g / cfg.d_model) ** 0.5)
    for key in ("wk", "wv"):
        attn[key].mul_((cfg.num_kv_heads / cfg.d_model) ** 0.5)
    gen = np.random.default_rng(0)
    toks = gen.integers(0, cfg.vocab_size, (2, 33))
    grads = {}
    for d in ("cpu", dev):
        p = tree.tree_map(lambda l: l.detach().to(d).requires_grad_(), params)
        batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(d),
                 "labels": torch.from_numpy(toks[:, 1:]).to(d)}
        attn_ops.reset_launches()
        n0, nb0 = norm_ops.launches, norm_ops.bwd_launches
        loss, _ = build(cfg).loss(p, batch)
        loss.backward()
        grads[str(d)] = (float(loss.detach()), [l.grad.cpu() for l in tree.leaves(p)])
        if d != "cpu":
            L = cfg.num_layers
            assert (norm_ops.launches - n0, norm_ops.bwd_launches - nb0) == (4 * L + 1,
                                                                             2 * L + 1)
            assert (attn_ops.launches, attn_ops.bwd_launches) == (2 * L, L)
    (lc, gc), (lg, gg) = grads["cpu"], grads[str(dev)]
    assert abs(lc - lg) <= 1e-5 * abs(lc)
    rel = [float((a - b).norm()) / (float(a.norm()) + 1e-30) for a, b in zip(gc, gg)]
    assert max(rel) <= 1e-4, rel


def test_flat_adam_in_place_equals_the_tree_step_on_the_card(dev):
    """`FlatMaskedAdam.step` (K1 writing p, m, v and u in place) against
    `masked_adam_update` on the same gradients: bit for bit, bf16 params."""
    from repro_torch.core.masked_adam import FlatMaskedAdam

    g = torch.Generator(device=dev).manual_seed(15)
    params = {"a": torch.randn(300, 7, generator=g, device=dev).to(torch.bfloat16),
              "b": {"c": torch.randn(1001, generator=g, device=dev).to(torch.bfloat16)}}
    mask = tree.tree_map(lambda l: torch.rand(l.shape, generator=g, device=dev) < 0.3,
                         params)
    ref_p, ref_s = tree.tree_map(torch.clone, params), masked_adam.init_state(params)
    st = FlatMaskedAdam(params)
    st.set_mask(mask)
    for _ in range(3):
        grads = tree.tree_map(lambda l: torch.randn(l.shape, generator=g, device=dev)
                              .to(l.dtype), params)
        with torch.no_grad():
            for dst, src in zip(tree.leaves(st.grads), tree.leaves(grads)):
                dst.copy_(src)
        st.step(lr=1e-2)
        ref_p, ref_s, u = masked_adam.masked_adam_update(ref_p, grads, ref_s, mask, lr=1e-2)
        for a, b in zip(tree.leaves(st.params) + tree.leaves(st.u_tree),
                        tree.leaves(ref_p) + tree.leaves(u)):
            assert torch.equal(a.detach(), b)


def test_flat_adam_with_clip_equals_the_clipped_tree_step_on_the_card(dev):
    """`FlatMaskedAdam` with the clip (the norm kernel, then K1 clipping in
    place) against `clip_ref` on each gradient leaf with the same norm and
    `masked_adam_update`: bit for bit, bf16 and float32 groups; ``grads``
    holds the clipped gradients afterwards; one norm launch and one K1
    launch per dtype group a step; a norm without a positive clip, or a
    clip without a norm, raises before any launch."""
    from repro_torch.core.masked_adam import FlatMaskedAdam

    g = torch.Generator(device=dev).manual_seed(24)
    params = {"a": torch.randn(300, 7, generator=g, device=dev).to(torch.bfloat16),
              "b": {"c": torch.randn(1001, generator=g, device=dev)}}
    mask = tree.tree_map(lambda l: torch.rand(l.shape, generator=g, device=dev) < 0.3,
                         params)
    ref_p, ref_s = tree.tree_map(torch.clone, params), masked_adam.init_state(params)
    st = FlatMaskedAdam(params)
    st.set_mask(mask)
    for scale in (30.0, 1e-3, 30.0):  # over the clip, under it, over it
        grads = tree.tree_map(lambda l: (torch.randn(l.shape, generator=g, device=dev)
                                         * scale).to(l.dtype), params)
        with torch.no_grad():
            for dst, src in zip(tree.leaves(st.grads), tree.leaves(grads)):
                dst.copy_(src)
        gn = st.grad_norm()
        n0 = gnorm_ops.launches, adam_ops.launches
        st.step(lr=1e-2, clip=1.0, gn=gn)
        assert (gnorm_ops.launches, adam_ops.launches) == (n0[0], n0[1] + 2)
        clipped = tree.tree_map(lambda l: clip_ref(l, gn, 1.0), grads)
        ref_p, ref_s, u = masked_adam.masked_adam_update(ref_p, clipped, ref_s, mask, lr=1e-2)
        for a, b in zip(tree.leaves(st.params) + tree.leaves(st.u_tree) + tree.leaves(st.grads),
                        tree.leaves(ref_p) + tree.leaves(u) + tree.leaves(clipped)):
            assert torch.equal(a.detach(), b)
    n0 = adam_ops.launches
    for kw in (dict(clip=1.0), dict(gn=gn), dict(gn=gn, clip=0.0)):  # one without the other
        with pytest.raises(ValueError, match="go together"):
            st.step(lr=1e-2, **kw)
    assert adam_ops.launches == n0


# ---------------------------------------------------------------------------
# The wrappers' meta branches (the dry run) against the CUDA routes
# ---------------------------------------------------------------------------


def _meta_like(t):
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")


def _alloc_delta(fn, *args):
    """(outputs, the most bytes the call allocated above what it began
    with) on the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _same_outputs_and_workspace(fn, *args):
    """The meta call's outputs have the CUDA call's shapes, strides and
    dtypes, and its traced peak above its arguments is what the CUDA call
    allocated, within 2 MiB an allocation (the caching allocator may keep
    the tail of a large segment in the block it hands out)."""
    from repro_torch.roofline.analysis import trace_facts

    out, cuda_bytes = _alloc_delta(fn, *args)
    facts = trace_facts(fn, *(_meta_like(a) if isinstance(a, torch.Tensor) else a
                              for a in args))
    outs = out if isinstance(out, tuple) else (out,)
    metas = facts["out"] if isinstance(facts["out"], tuple) else (facts["out"],)
    assert [(tuple(t.shape), t.stride(), t.dtype) for t in metas] == [
        (tuple(t.shape), t.stride(), t.dtype) for t in outs]
    meta_bytes = facts["peak_bytes"] - facts["arg_bytes"]
    assert abs(meta_bytes - cuda_bytes) <= (2 << 20) * (len(outs) + 3), (meta_bytes, cuda_bytes)


@pytest.mark.parametrize("shape", [(2, 8000, 3584), (2, 1, 3584), (2, 2048, 2048)])
def test_rmsnorm_meta_branch_matches_the_kernel(dev, shape):
    from repro_torch.kernels.rmsnorm import ops as norm_ops

    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(shape[-1], generator=g, device=dev).to(torch.bfloat16)
    _same_outputs_and_workspace(lambda x, w: norm_ops._forward(x, w, 1e-6), x, w)
    _same_outputs_and_workspace(norm_ops.rms_norm_bwd, x, w, torch.randn_like(x))
    assert norm_ops._meta_bwd_blocks(x) == norm_ops._bwd_plan(
        "rms_norm_bwd_blocks", x, x, torch.empty_like(x))


@pytest.mark.parametrize("B,S,KV,G,hd,causal,window", [
    (2, 2048, 1, 8, 256, True, 0), (2, 1000, 8, 2, 256, True, 512),
    (1, 700, 4, 8, 112, True, 0)])
def test_flash_attention_meta_branch_matches_the_kernel(dev, B, S, KV, G, hd, causal,
                                                        window):
    from repro_torch.kernels.flash_attention import ops as attn_ops

    g = torch.Generator(device=dev).manual_seed(17)
    q = torch.randn((B, S, KV, G, hd), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, S, KV, hd), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    _same_outputs_and_workspace(
        lambda q, k, v: attn_ops._forward(q, k, v, causal, window, 0.0, want_lse=True),
        q, k, v)
    o, lse = attn_ops._forward(q, k, v, causal, window, 0.0, want_lse=True)
    _same_outputs_and_workspace(
        lambda q, k, v, o, lse, do: attn_ops.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal, window=window), q, k, v, o, lse,
        torch.randn_like(o))


def test_masked_adam_meta_branch_matches_the_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(18)
    p, gr = (torch.randn((1, 4096, 128), generator=g, device=dev).to(torch.bfloat16)
             for _ in range(2))
    m, v = torch.zeros_like(p), torch.zeros(p.shape, device=dev)
    mask = torch.rand(p.shape, generator=g, device=dev) < 0.1
    bc = torch.full((1,), 1e-3, device=dev)
    _same_outputs_and_workspace(
        lambda *a: adam_ops.masked_adam_3d(*a, b1=0.9, b2=0.999, eps=1e-8), p, gr, m, v,
        mask, bc)


def test_grad_norm_and_clipped_adam_meta_branches_match_the_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(19)
    a = torch.randn((1, 4096, 128), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((1, 300, 128), generator=g, device=dev)
    _same_outputs_and_workspace(lambda a, b: gnorm_ops.grad_norm([a, b]), a, b)
    m, v = torch.zeros_like(a), torch.zeros(a.shape, device=dev)
    mask = torch.rand(a.shape, generator=g, device=dev) < 0.1
    bc, gn = torch.full((1,), 1e-3, device=dev), gnorm_ops.grad_norm([a])
    _same_outputs_and_workspace(
        lambda *t: adam_ops.masked_adam_3d(*t[:6], b1=0.9, b2=0.999, eps=1e-8, gn=t[6],
                                           clip=1.0), a.clone(), a, m, v, mask, bc, gn)
