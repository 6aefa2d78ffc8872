"""Sharded execution (`core/batched.train_phases_sharded`) on the card, and
the kernel launchers' handling of the caller's CUDA device. These tests
need an NVIDIA GPU and skip without one; some need two and skip on a
host with one. On the GPU host run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sharded_cuda.py

* Four groups of two width-1.0 students, all on ``cuda:0``, over two
  phases (a random mask, then gradient-guided selection): sharded over
  ``[cuda:0] * 4`` and over ``[None] * 4`` equal per-group
  ``train_phases_fused(force_stack=True)`` bit for bit, in the loop and
  the graph shape. With two or more cards, the same with the groups
  spread over the cards.
* With two or more cards: under ``torch.cuda.device(c)``, one launch of
  each kernel (K1, K2, K3, K3-bwd, K4 on both routes, K4-bwd, the
  gradient norm) on the other card's tensors leaves ``c`` the current
  device, and a later ``torch.empty(1, device="cuda")`` lands on ``c``.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.core import batched

pytestmark = pytest.mark.cuda

GROUPS, GB, HW, K = 4, 2, 32, 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    return torch.cuda.device_count()


def _fleet(dev, n=GROUPS * GB, seed0=700):
    from repro_torch.core.server import AMSConfig, AMSSession, Task
    from repro_torch.data.video import VideoConfig
    from repro_torch.models.seg.student import SegConfig, make_student
    from repro_torch.sim.seg_world import SegWorld, phi_pixel_loss

    seg = SegConfig(n_classes=5)
    ams = AMSConfig(t_update=8.0, t_horizon=30.0, k_iters=K, batch_size=4, gamma=0.05,
                    lr=2e-3, phi_target=0.15)
    pre = make_student(seg, seed=0, device=dev)
    worlds = [SegWorld.make(VideoConfig(seed=seed0 + i, height=HW, width=HW, fps=2.0,
                                        duration=20.0), seg) for i in range(n)]
    sessions = [AMSSession(Task(loss_and_grad=w.loss_and_grad, teacher=None,
                                phi_loss=phi_pixel_loss), ams,
                           tree.tree_map(torch.clone, pre), seed=i)
                for i, w in enumerate(worlds)]
    return sessions, worlds


def _feed(fleet, worlds, phase):
    for s, w in zip(fleet, worlds):
        idx = range(6 * phase, 6 * phase + 6)
        s.receive_labeled(np.stack([w.video.frame(j)[0] for j in idx]),
                          np.stack([w.teacher.label(j) for j in idx]), 8.0 * phase + 5.0)


def _groups(fleet):
    return [fleet[g * GB:(g + 1) * GB] for g in range(GROUPS)]


def _three_fleets(dev, devices, mode):
    """Per-group fused, sharded over no device and sharded over
    ``devices``, two phases each; returns the three flat delta lists and
    the fleets."""
    batched.cache_clear()
    batched.set_exec_mode(mode)
    try:
        (ref, worlds), (none, _), (placed, _) = (_fleet(dev) for _ in range(3))
        out = ([], [], [])
        for phase in range(2):
            for f in (ref, none, placed):
                _feed(f, worlds, phase)
            t = 8.0 * phase + 6.0
            out[0].extend(d for g in _groups(ref)
                          for d in batched.train_phases_fused(g, t, force_stack=True))
            out[1].extend(d for g in batched.train_phases_sharded(
                _groups(none), t, devices=[None] * GROUPS) for d in g)
            out[2].extend(d for g in batched.train_phases_sharded(
                _groups(placed), t, devices=devices) for d in g)
        return out, (ref, none, placed)
    finally:
        batched.set_exec_mode("auto")
        batched.cache_clear()


def _assert_bitwise(out, fleets):
    for a, b, c in zip(*out):
        assert a.packed_mask == b.packed_mask == c.packed_mask
        assert a.values.tobytes() == b.values.tobytes() == c.values.tobytes()
    ref, *others = fleets
    for f in others:
        for x, y in zip(ref, f):
            assert x.device == y.device
            for p, q in zip(tree.leaves((x.params, x.opt_state, x.u_prev)),
                            tree.leaves((y.params, y.opt_state, y.u_prev))):
                assert torch.equal(p.cpu(), q.cpu())


@pytest.mark.parametrize("mode", ["loop", "graph"])
def test_sharded_on_one_card_is_fused_bitwise(dev, mode):
    batched.sharded_reset()
    out, fleets = _three_fleets(dev, [dev] * GROUPS, mode)
    _assert_bitwise(out, fleets)
    info = batched.sharded_info()
    assert info["dispatch_launches"] == 2 * 2 * GROUPS and info["distinct_devices"] == 1


def test_sharded_across_cards_is_fused_bitwise(dev):
    n = _two_cards()
    devices = [torch.device("cuda", g % n) for g in range(GROUPS)]
    batched.sharded_reset()
    out, fleets = _three_fleets(dev, devices, "graph")
    _assert_bitwise(out, fleets)
    assert batched.sharded_info()["distinct_devices"] == min(GROUPS, n)
    assert torch.cuda.current_device() == 0


def _launch_each_kernel(target):
    """One launch of every kernel on ``target``'s tensors; yields each
    kernel's name after its launch."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.grad_norm import ops as gnorm_ops
    from repro_torch.kernels.masked_adam import ops as adam_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.topk_mask import ops as topk_ops

    g = torch.Generator(device=target).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=target).to(dtype)

    p, gr, m, v = (randn(2, 3, 128) for _ in range(4))
    mask = torch.rand((2, 3, 128), generator=g, device=target) < 0.3
    _, bc = adam_ops.bias_correction(torch.tensor([1, 5], dtype=torch.int32, device=target),
                                     lr=1e-3, b1=0.9, b2=0.999)
    adam_ops.masked_adam_3d(p, gr, m, v.abs(), mask, bc, b1=0.9, b2=0.999, eps=1e-8)
    yield "masked_adam_3d"
    gnorm_ops.grad_norm([gr.reshape(-1)])
    yield "grad_norm"
    topk_ops.topk_threshold_bits(topk_ops.abs_bits_buffer({"u": p})[0], 10)
    yield "topk_threshold_bits"
    x, w, dy = randn(16, 256, dtype=torch.bfloat16), randn(256), randn(16, 256,
                                                                      dtype=torch.bfloat16)
    norm_ops.rms_norm(x, w)
    yield "rms_norm"
    norm_ops.rms_norm_bwd(x, w, dy)
    yield "rms_norm_bwd"
    for dtype in (torch.bfloat16, torch.float32):
        q, do = (randn(1, 128, 1, 2, 64, dtype=dtype) for _ in range(2))
        k, vv = (randn(1, 128, 1, 64, dtype=dtype) for _ in range(2))
        o, lse = attn_ops._forward(q, k, vv, True, 0, 0.0, True)
        yield f"flash_attention {dtype}"
        attn_ops.flash_attention_bwd(q, k, vv, o, lse, do)
        yield f"flash_attention_bwd {dtype}"


def test_launchers_restore_the_callers_device(dev):
    _two_cards()
    for cur, target in ((0, 1), (1, 0)):
        with torch.cuda.device(cur):
            for name in _launch_each_kernel(torch.device("cuda", target)):
                assert torch.cuda.current_device() == cur, name
                assert torch.empty(1, device="cuda").device.index == cur, name
            torch.cuda.synchronize(target)
    assert torch.cuda.current_device() == 0
