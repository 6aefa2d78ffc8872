"""The RWKV-6 wkv kernel (``csrc/wkv6.cu``, wrapper `kernels/wkv6/ops.py`)
on the card, against its plain version (the chunk loop,
`kernels/wkv6/ref.wkv6_ref`) run on the same card and against the
per-step recurrence in float64. These tests need an NVIDIA GPU with
``nvcc`` and skip on a host without one; on the GPU host run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_wkv6_cuda.py

Tolerance, in relative L2 norm over a whole output (y, and the final
state): `TOL_LOOP` = 5e-5 against the loop and `TOL_F64` = 3e-5 against
float64. Both versions are float32 and round in different places. The
loop forms cumulative sums of log w over a chunk and takes differences of
them: with every log w near -20 a chunk's sums reach -1,280, whose
float32 spacing puts ~6e-5 of error into a decay factor, and its y is
2.5e-5 off float64 in norm at 8,000 tokens. The kernel applies one
step's decay at a time, which keeps every factor exact, but rounds the
state once a step: with w near 1 nothing decays, and after 8,000 steps
its state is 1.3e-5 off float64 (both measured on the CPU with the same
arithmetic and these draws, one head). Kernel and loop can so
differ by about the sum of the two; a real fault (a lost bonus term, a
decay off by one step, a token dropped at a stage's edge) is 1e-2 and
up.

Also: the launch count of one RWKV6-3B prefill through
`launch.serve.serve` (one a layer, 32) with the chunk loop unreachable,
the wrapper's refusals (inputs that record autograd, a non-contiguous
input, float64), and that the launcher restores the caller's device
(two cards or more).
"""
import math

import pytest
import torch

from repro_torch.kernels.wkv6 import ops
from repro_torch.kernels.wkv6.ref import wkv6_ref

pytestmark = pytest.mark.cuda

TOL_LOOP = 5e-5
TOL_F64 = 3e-5
REGIMES = ("span", "near_-20", "near_-1e-6")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def inputs(shape, regime, dev, seed=0):
    """r, k, v ~ N(0, 1), u ~ N(0, 0.25), and log w in [-20, -1e-6]:
    log-uniform in magnitude over the whole range ("span"), or drawn near
    one end of it."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, S, H, P = shape
    r, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    x = torch.rand(shape, generator=g, device=dev)
    if regime == "span":
        logw = -torch.exp(math.log(1e-6) + x * (math.log(20.0) - math.log(1e-6)))
    elif regime == "near_-20":
        logw = -(19.0 + x)
    else:
        logw = -(1e-6 + 9e-6 * x)
    u = 0.5 * torch.randn((H, P), generator=g, device=dev)
    return r, k, v, logw.clamp(-20.0, -1e-6), u


def steps_f64(r, k, v, logw, u):
    """The recurrence one token at a time, in float64."""
    r, k, v, w, u = (t.double() for t in (r, k, v, logw.exp(), u))
    B, S, H, P = r.shape
    st = torch.zeros((B, H, P, P), dtype=torch.float64, device=r.device)
    y = torch.empty_like(r)
    for t in range(S):
        bonus = (r[:, t] * u * k[:, t]).sum(-1)
        y[:, t] = torch.einsum("bhp,bhpq->bhq", r[:, t], st) + bonus[..., None] * v[:, t]
        st = st * w[:, t][..., None] + torch.einsum("bhp,bhq->bhpq", k[:, t], v[:, t])
    return y, st


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def held(shape, regime, dev):
    x = inputs(shape, regime, dev)
    n0 = ops.launches
    y, st = ops.wkv6(*x)
    torch.cuda.synchronize()
    assert ops.launches == n0 + 1
    assert y.shape == shape and st.shape == (shape[0], shape[2], shape[3], shape[3])
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_loop, st_loop = wkv6_ref(*x, 64)
    y64, st64 = steps_f64(*x)
    errs = dict(y_loop=rel(y, y_loop), state_loop=rel(st, st_loop), y_f64=rel(y, y64),
                state_f64=rel(st, st64))
    assert errs["y_loop"] < TOL_LOOP and errs["state_loop"] < TOL_LOOP, errs
    assert errs["y_f64"] < TOL_F64 and errs["state_f64"] < TOL_F64, errs
    return errs


def test_kernel_at_the_path_shape(dev):
    """RWKV6-3B's prefill: (2, 8000, 40, 64), log w over its whole range."""
    held((2, 8000, 40, 64), "span", dev)


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("S", [1, 17, 50, 200])
@pytest.mark.parametrize("B,H", [(2, 40), (1, 5)])
def test_kernel_at_ragged_lengths(dev, B, H, S, regime):
    """Lengths with no divisor of a stage (16 tokens at P = 64) and S = 1."""
    held((B, S, H, 64), regime, dev)


@pytest.mark.parametrize("P", ops.HEAD_SIZES)
def test_kernel_at_each_head_size(dev, P):
    """Every instantiation (head sizes 16, 32 and 64: the benchmark's and
    the model's smoke configs, RWKV6-3B), over a last stage that is
    partly filled."""
    held((2, 3 * 16 + 5, 3, P), "span", dev)


def test_one_prefill_launches_the_kernel_once_a_layer(dev, monkeypatch):
    """One RWKV6-3B prefill (2 x 8,000 tokens, its full config) through
    `launch.serve.serve`: 32 launches, one a layer, and the chunk loop
    never runs on the card."""
    from repro_torch.kernels.wkv6 import ref
    from repro_torch.launch.serve import recurrent_path_inputs, serve

    def loop(*a, **k):
        raise AssertionError("a CUDA tensor reached the chunk loop")

    monkeypatch.setattr(ref, "wkv6_ref", loop)
    monkeypatch.setattr(ops, "wkv6_ref", loop)
    cfg, params, prompt, memory = recurrent_path_inputs(dev)
    layers = sum(k == "rwkv" for k in cfg.pattern) * cfg.num_groups
    assert layers == 32
    n0 = ops.launches
    r = serve(cfg, params, prompt, 0, dev, memory=memory)
    assert r["finite"]
    assert ops.launches - n0 == layers


def test_refusals(dev):
    r, k, v, logw, u = inputs((1, 20, 2, 64), "span", dev)
    with pytest.raises(RuntimeError, match="autograd"):
        ops.wkv6(r.requires_grad_(), k, v, logw, u)
    r = r.detach()
    with torch.no_grad():  # grad mode off: nothing records, the call runs
        ops.wkv6(r, k, v, logw, u.requires_grad_())
    u = u.detach()
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv6(r, k.transpose(1, 2).contiguous().transpose(1, 2), v, logw, u)
    with pytest.raises(TypeError, match="float32"):
        ops.wkv6(r, k, v.double(), logw, u)


def test_launcher_restores_the_callers_device(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    for cur, target in ((0, 1), (1, 0)):
        with torch.cuda.device(cur):
            x = inputs((1, 20, 2, 64), "span", torch.device("cuda", target))
            ops.wkv6(*x)
            assert torch.cuda.current_device() == cur
            assert torch.empty(1, device="cuda").device.index == cur
            torch.cuda.synchronize(target)
