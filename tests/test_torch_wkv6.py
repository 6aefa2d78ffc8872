"""RWKV-6's wkv scan on the CPU: the plain version (the chunk loop,
`kernels/wkv6/ref.py`), which CPU tensors take and which the card's
kernel is held against (`tests/test_torch_wkv6_cuda.py`), and the
wrapper's routing and refusals (`kernels/wkv6/ops.py`).

The plain path is held against the per-step oracles (`rwkv6_time_mix_ref`
for the block, `rwkv6._wkv_step` stepped for y and the final state) at
chunk 64 over lengths with no divisor of 64 and S = 1, with log w at
either end of its clamp: near -20, where a chunk's cumulative log decays
reach -1,280 and its masked decay products overflow before the mask,
and near -1e-6, where nothing decays. Tolerances as `tests/test_torch_ssm.py` holds the chunked
scans to their oracles (rtol = atol = 2e-4).
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import build
from repro_torch.kernels.wkv6 import ops
from repro_torch.models.common import init_params
from repro_torch.models.ssm import rwkv6

ROOT = Path(__file__).resolve().parents[1]
RTOL = ATOL = 2e-4
W0 = {"near_-20": 5.0, "near_-1e-6": -20.0}  # decay_w0: log w = -exp(w0 + ...)


def block(decay: str, S: int, seed: int = 0):
    """The RWKV6-3B smoke config's time-mix params, with ``decay_w0``
    set so that every log w sits at one end of [-20, -1e-6], and an
    input (2, S, d_model)."""
    cfg = get_smoke("rwkv6-3b")
    p = init_params(rwkv6.rwkv6_metas(cfg)["tm"], torch.Generator().manual_seed(seed),
                    torch.float32, torch.device("cpu"))
    p["decay_w0"].fill_(W0[decay])
    x = 0.3 * torch.randn((2, S, cfg.d_model), generator=torch.Generator().manual_seed(seed + 1))
    return cfg, p, x


def stepped(r, k, v, logw, u):
    """y and the final state from `rwkv6._wkv_step`, one token at a time."""
    B, S, H, P = r.shape
    st = torch.zeros((B, H, P, P), dtype=torch.float32)
    ys = []
    for t in range(S):
        y_t, st = rwkv6._wkv_step(r[:, t], k[:, t], v[:, t], logw[:, t], u, st)
        ys.append(y_t)
    return torch.stack(ys, dim=1), st


@pytest.mark.parametrize("decay", sorted(W0))
@pytest.mark.parametrize("S", [1, 17, 50, 200])
def test_plain_scan_matches_the_step_oracle(decay, S):
    cfg, p, x = block(decay, S)
    r, k, v, g, w, u = rwkv6._time_mix_inputs(cfg, p, x)
    end = -20.0 if decay == "near_-20" else -1e-6
    assert float((w - end).abs().max()) < 1e-3 * abs(end) + 1e-9
    r, k, v = (a.to(torch.float32) for a in (r, k, v))
    n0 = ops.launches
    y, st = rwkv6._wkv_chunked(r, k, v, w, u, 64)
    y_want, st_want = stepped(r, k, v, w, u)
    torch.testing.assert_close(y, y_want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(st, st_want, rtol=RTOL, atol=ATOL)
    out, st_block = rwkv6.rwkv6_time_mix(cfg, p, x, chunk=64, want_state=True)
    torch.testing.assert_close(out, rwkv6.rwkv6_time_mix_ref(cfg, p, x), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(st_block, st_want, rtol=RTOL, atol=ATOL)
    assert torch.isfinite(y).all() and ops.launches == n0


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def no_build(name):
        raise AssertionError(f"a CPU tensor asked for the {name} kernel")

    monkeypatch.setattr(build, "load", no_build)
    cfg, p, x = block("near_-1e-6", 20)
    n0 = ops.launches
    rwkv6.rwkv6_time_mix(cfg, p, x)
    assert ops.launches == n0 == 0


def test_ops_imports_on_a_host_without_nvcc():
    """The wrapper and the model import, and the CPU path runs, with no
    ``nvcc`` on the path and no CUDA toolkit: nothing is built at import."""
    code = ("import torch\n"
            "from repro_torch.kernels import build\n"
            "from repro_torch.kernels.wkv6 import ops\n"
            "from repro_torch.models.ssm import rwkv6\n"
            "x = [torch.rand(1, 9, 2, 16) for _ in range(3)] + [-torch.rand(1, 9, 2, 16)]\n"
            "rwkv6._wkv_chunked(*x, torch.zeros(2, 16), 64)\n"
            "try:\n"
            "    build._nvcc()\n"
            "    raise SystemExit('nvcc found')\n"
            "except RuntimeError:\n"
            "    pass\n"
            "print(ops.launches, sorted(build._LIBS))\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable), CUDA_HOME="/nonexistent",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "0 []"


def _inputs(shape=(1, 5, 2, 64)):
    r, k, v = (torch.randn(shape) for _ in range(3))
    return r, k, v, -torch.rand(shape), torch.randn(shape[2:])


@pytest.mark.parametrize("fault,exc,match", [
    ("float64", TypeError, "float32"),
    ("strided", ValueError, "contiguous"),
    ("shape", ValueError, "shape"),
    ("head_size", ValueError, "head size"),
    ("u", ValueError, "u must be"),
    ("autograd", RuntimeError, "autograd"),
])
def test_check_inputs_refuses(fault, exc, match):
    """What the CUDA route refuses, checked on CPU tensors (the check is
    the same function)."""
    r, k, v, logw, u = _inputs((1, 5, 2, 48) if fault == "head_size" else (1, 5, 2, 64))
    if fault == "float64":
        v = v.double()
    elif fault == "strided":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "shape":
        logw = logw[:, :4]
    elif fault == "u":
        u = u.t().contiguous()
    elif fault == "autograd":
        r.requires_grad_()
    with pytest.raises(exc, match=match):
        ops.check_inputs(r, k, v, logw, u)


def test_check_inputs_takes_the_served_shapes():
    for P in ops.HEAD_SIZES:
        ops.check_inputs(*_inputs((2, 3, 4, P)))
    r, k, v, logw, u = _inputs()
    with torch.no_grad():  # nothing records with grad mode off
        ops.check_inputs(r.requires_grad_(), k, v, logw, u)
