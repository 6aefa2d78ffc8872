"""The port's recurrent blocks (`models/ssm/mamba2.py`, `models/ssm/rwkv6.py`)
against the JAX package's, on the Zamba2-7B smoke config (d_model 128, 8
heads of 32, d_state 16, chunk 8) and RWKV6-3B's (4 wkv heads of 32): the
same parameters (the JAX package's init, carried over with
`params_from_numpy`) and the same inputs, drawn with numpy from a seed.

Held, against the JAX package: `mamba2_apply` with its decode-ready state
(SSM state and conv inputs), `mamba2_decode` steps, `rwkv6_time_mix` with
its final wkv state, `rwkv6_channel_mix` and `rwkv6_decode` steps.
Elementwise in float64 (x64 mode in JAX), at the contract's rtol 1e-4,
atol 1e-6: both packages keep the reference's float32 islands (dt, A, the
SSD and wkv products, the decay LoRA) inside the float64 model, so they
round alike up to the order of float32 sums. In float32, in relative L2
norm (1e-5).

Held, within the port, as the JAX package's own tests hold its blocks
(`tests/test_moe_ssm.py`, rtol/atol 2e-4): the chunked scans against the
step-by-step oracles, decode steps against the full sequence, chunk
invariance, and an S that is not a multiple of the chunk (the chunk
shrinks to a divisor of S). A saturated decay, whose masked upper
triangle overflows to inf in float32, stays finite in both packages, and
they agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as get_smoke_jax
from repro.models.common import init_params as init_params_jax
from repro.models.ssm import mamba2 as mamba2_jax
from repro.models.ssm import rwkv6 as rwkv6_jax
from repro_torch import tree
from repro_torch.configs import get_smoke
from repro_torch.models.common import params_from_numpy
from repro_torch.models.ssm import mamba2, rwkv6

RTOL64, ATOL64 = 1e-4, 1e-6     # float64, elementwise
NORM32 = 1e-5                   # float32, relative L2 norm
RTOL_ORACLE = ATOL_ORACLE = 2e-4  # chunked vs the step-by-step oracle
JDT = {"float32": jnp.float32, "float64": jnp.float64}
TDT = {"float32": torch.float32, "float64": torch.float64}


def _setup(arch, metas_jax, dtype, shape, seed=1, scale=0.3, edit=None):
    """(cfg_j, cfg_t, params_j, params_t, x_j, x_t) in ``dtype``; call
    under ``jax.enable_x64`` for float64. ``edit(params)`` changes a
    numpy copy of the JAX params before both packages get them."""
    cfg_j, cfg_t = get_smoke_jax(arch), get_smoke(arch)
    params = jax.tree.map(np.asarray, init_params_jax(metas_jax(cfg_j), jax.random.PRNGKey(seed),
                                                      JDT[dtype]))
    if dtype == "float64" and "dt_bias" in params:
        # the JAX package's chunk scan carries its SSM state in float32, and
        # dt = softplus(f32(x @ w_dt) + dt_bias) would be float64 with a
        # float64 dt_bias, which `lax.scan` refuses: dt_bias stays float32
        # in both packages
        params["dt_bias"] = params["dt_bias"].astype(np.float32)
    if edit is not None:
        edit(params)
    params_j = jax.tree.map(jnp.asarray, params)
    params_t = params_from_numpy(params, device="cpu")
    x = (scale * np.random.default_rng(seed).normal(size=shape + (cfg_t.d_model,))).astype(dtype)
    return cfg_j, cfg_t, params_j, params_t, jnp.asarray(x), torch.from_numpy(x)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all() and np.isfinite(want).all()
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=RTOL64, atol=ATOL64)
    else:
        got, want = got.astype(np.float64), want.astype(np.float64)
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel < NORM32, rel


def _oracle_close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL_ORACLE, atol=ATOL_ORACLE)


def _x64(dtype):
    return jax.enable_x64(dtype == "float64")


# ---------------- Mamba2 ----------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("S", [24, 20])  # 20: chunks of 5, not of the config's 8
def test_mamba2_apply_and_state_match_jax(dtype, S):
    with _x64(dtype):
        cfg_j, cfg_t, pj, pt, xj, xt = _setup("zamba2-7b", mamba2_jax.mamba2_metas, dtype, (2, S))
        want, st_j = mamba2_jax.mamba2_apply(cfg_j, pj, xj, want_state=True)
        got, st_t = mamba2.mamba2_apply(cfg_t, pt, xt, want_state=True)
        _close(got, want, dtype)
        assert got.dtype == TDT[dtype]
        assert sorted(st_t) == sorted(st_j) == ["conv_bc", "conv_x", "ssm"]
        assert st_t["ssm"].dtype == torch.float32 and st_t["conv_x"].dtype == TDT[dtype]
        for k in st_j:
            _close(st_t[k], st_j[k], dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mamba2_decode_and_conv_state_match_jax(dtype):
    """Prefill's hand-off, then decode steps: the SSM state and the conv
    state (the last k-1 inputs before the SiLU) carry over."""
    with _x64(dtype):
        cfg_j, cfg_t, pj, pt, xj, xt = _setup("zamba2-7b", mamba2_jax.mamba2_metas, dtype, (2, 13))
        _, cj = mamba2_jax.mamba2_apply(cfg_j, pj, xj[:, :8], want_state=True)
        _, ct = mamba2.mamba2_apply(cfg_t, pt, xt[:, :8], want_state=True)
        for t in range(8, 13):
            oj, cj = mamba2_jax.mamba2_decode(cfg_j, pj, xj[:, t:t + 1], cj)
            ot, ct = mamba2.mamba2_decode(cfg_t, pt, xt[:, t:t + 1], ct)
            _close(ot, oj, dtype)
        for k in cj:
            _close(ct[k], cj[k], dtype)


def test_mamba2_chunked_matches_recurrence():
    cfg = get_smoke("zamba2-7b")
    _, _, _, p, _, x = _setup("zamba2-7b", mamba2_jax.mamba2_metas, "float32", (2, 24))
    _oracle_close(mamba2.mamba2_apply(cfg, p, x, chunk=8), mamba2.mamba2_scan_ref(cfg, p, x))


@pytest.mark.parametrize("chunks", [(4, 12), (8, 24), (5, 7)])
def test_mamba2_chunk_invariance(chunks):
    """(5, 7) on S = 24: chunks of 4 and of 6, the shrink rule's."""
    cfg = get_smoke("zamba2-7b")
    _, _, _, p, _, x = _setup("zamba2-7b", mamba2_jax.mamba2_metas, "float32", (1, 24))
    a, b = (mamba2.mamba2_apply(cfg, p, x, chunk=c) for c in chunks)
    _oracle_close(a, b)


def test_mamba2_ragged_sequence_matches_recurrence():
    """S = 23 is prime, so the chunk shrinks to 1; S = 21 runs chunks of 7."""
    cfg = get_smoke("zamba2-7b")
    assert (mamba2.chunk_len(23, 8), mamba2.chunk_len(21, 8), mamba2.chunk_len(8000, 128)) == (
        1, 7, 125)
    for S in (23, 21):
        _, _, _, p, _, x = _setup("zamba2-7b", mamba2_jax.mamba2_metas, "float32", (2, S))
        _oracle_close(mamba2.mamba2_apply(cfg, p, x), mamba2.mamba2_scan_ref(cfg, p, x))


def test_mamba2_decode_matches_full():
    cfg = get_smoke("zamba2-7b")
    _, _, _, p, _, x = _setup("zamba2-7b", mamba2_jax.mamba2_metas, "float32", (2, 12))
    full = mamba2.mamba2_apply(cfg, p, x, chunk=4)
    cache = mamba2.mamba2_init_cache(cfg, batch=2)
    outs = []
    for t in range(12):
        o, cache = mamba2.mamba2_decode(cfg, p, x[:, t:t + 1], cache)
        outs.append(o)
    _oracle_close(torch.cat(outs, dim=1), full)


def _saturate_mamba(params):
    params["a_log"] = np.full_like(params["a_log"], 4.5)      # A = -90.0
    params["dt_bias"] = np.full_like(params["dt_bias"], 2.0)  # dt ~ 2.1: -190 a step


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mamba2_saturated_decay_stays_finite(dtype):
    """Decays of ~e^-190 a step: above the diagonal a chunk's seg reaches
    ~+1,300, whose exp is inf in float32 (and float64). Both packages mask
    it away and stay finite, agree with each other, and the port agrees
    with its oracle."""
    with _x64(dtype):
        cfg_j, cfg_t, pj, pt, xj, xt = _setup("zamba2-7b", mamba2_jax.mamba2_metas, dtype,
                                              (2, 16), edit=_saturate_mamba)
        dt = torch.nn.functional.softplus(
            (xt @ pt["w_dt"]).float() + pt["dt_bias"].float()) * -torch.exp(pt["a_log"].float())
        assert float(-dt[:, :7].sum(1).max()) > 710  # exp overflows on the upper triangle
        want = mamba2_jax.mamba2_apply(cfg_j, pj, xj)
        got = mamba2.mamba2_apply(cfg_t, pt, xt)
        _close(got, want, dtype)
        _oracle_close(got.float(), mamba2.mamba2_scan_ref(cfg_t, pt, xt).float())


# ---------------- RWKV6 ----------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("S,chunk", [(24, 8), (20, 64)])  # default chunk 64: one chunk of 20
def test_rwkv6_time_mix_and_state_match_jax(dtype, S, chunk):
    with _x64(dtype):
        cfg_j, cfg_t, pj, pt, xj, xt = _setup("rwkv6-3b", rwkv6_jax.rwkv6_metas, dtype, (2, S),
                                              seed=2)
        want, sj = rwkv6_jax.rwkv6_time_mix(cfg_j, pj["tm"], xj, chunk=chunk, want_state=True)
        got, st = rwkv6.rwkv6_time_mix(cfg_t, pt["tm"], xt, chunk=chunk, want_state=True)
        _close(got, want, dtype)
        assert got.dtype == TDT[dtype] and st.dtype == torch.float32
        _close(st, sj, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rwkv6_channel_mix_matches_jax(dtype):
    with _x64(dtype):
        cfg_j, cfg_t, pj, pt, xj, xt = _setup("rwkv6-3b", rwkv6_jax.rwkv6_metas, dtype, (2, 12),
                                              seed=2)
        _close(rwkv6.rwkv6_channel_mix(cfg_t, pt["cm"], xt),
               rwkv6_jax.rwkv6_channel_mix(cfg_j, pj["cm"], xj), dtype)
        last = xt[:, 0] * 0.5
        _close(rwkv6.rwkv6_channel_mix(cfg_t, pt["cm"], xt[:, 1:2], last=last),
               rwkv6_jax.rwkv6_channel_mix(cfg_j, pj["cm"], xj[:, 1:2],
                                           last=jnp.asarray(last.numpy())), dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rwkv6_decode_matches_jax(dtype):
    """The prefill's final wkv state and last input hand over, then decode
    steps; the caches agree leaf by leaf."""
    with _x64(dtype):
        cfg_j, cfg_t, pj, pt, xj, xt = _setup("rwkv6-3b", rwkv6_jax.rwkv6_metas, dtype, (2, 13),
                                              seed=2)
        _, sj = rwkv6_jax.rwkv6_time_mix(cfg_j, pj["tm"], xj[:, :8], want_state=True)
        _, st = rwkv6.rwkv6_time_mix(cfg_t, pt["tm"], xt[:, :8], want_state=True)
        cj = dict(rwkv6_jax.rwkv6_init_cache(cfg_j, 2, JDT[dtype]), wkv=sj, tm_last=xj[:, 7])
        ct = dict(rwkv6.rwkv6_init_cache(cfg_t, 2, TDT[dtype]), wkv=st, tm_last=xt[:, 7])
        for t in range(8, 13):
            oj, cj = rwkv6_jax.rwkv6_decode(cfg_j, pj, xj[:, t:t + 1], cj)
            ot, ct = rwkv6.rwkv6_decode(cfg_t, pt, xt[:, t:t + 1], ct)
            _close(ot, oj, dtype)
        assert sorted(ct) == sorted(cj)
        for k in cj:
            _close(ct[k], cj[k], dtype)


def test_rwkv6_chunked_matches_recurrence():
    cfg = get_smoke("rwkv6-3b")
    _, _, _, p, _, x = _setup("rwkv6-3b", rwkv6_jax.rwkv6_metas, "float32", (2, 24), seed=2)
    _oracle_close(rwkv6.rwkv6_time_mix(cfg, p["tm"], x, chunk=8),
                  rwkv6.rwkv6_time_mix_ref(cfg, p["tm"], x))


@pytest.mark.parametrize("chunks", [(4, 12), (8, 64), (5, 7)])
def test_rwkv6_chunk_invariance(chunks):
    cfg = get_smoke("rwkv6-3b")
    _, _, _, p, _, x = _setup("rwkv6-3b", rwkv6_jax.rwkv6_metas, "float32", (1, 24), seed=2)
    a, b = (rwkv6.rwkv6_time_mix(cfg, p["tm"], x, chunk=c) for c in chunks)
    _oracle_close(a, b)


def test_rwkv6_ragged_sequence_matches_recurrence():
    cfg = get_smoke("rwkv6-3b")
    for S, chunk in ((23, 8), (21, 8), (10, 4)):
        _, _, _, p, _, x = _setup("rwkv6-3b", rwkv6_jax.rwkv6_metas, "float32", (2, S), seed=2)
        _oracle_close(rwkv6.rwkv6_time_mix(cfg, p["tm"], x, chunk=chunk),
                      rwkv6.rwkv6_time_mix_ref(cfg, p["tm"], x))


def test_rwkv6_decode_matches_full():
    cfg = get_smoke("rwkv6-3b")
    _, _, _, p, _, x = _setup("rwkv6-3b", rwkv6_jax.rwkv6_metas, "float32", (1, 10), seed=2)
    full = rwkv6.rwkv6_time_mix(cfg, p["tm"], x, chunk=4)
    cache = rwkv6.rwkv6_init_cache(cfg, batch=1)
    outs = []
    for t in range(10):
        o, cache = rwkv6.rwkv6_decode(cfg, p, x[:, t:t + 1], cache)
        outs.append(o)
    _oracle_close(torch.cat(outs, dim=1), full)


def _saturate_rwkv(params):
    params["tm"]["decay_w0"] = np.full_like(params["tm"]["decay_w0"], 5.0)  # logw at -20


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rwkv6_saturated_decay_stays_finite(dtype):
    """Log-decays clipped at -20: above the diagonal a chunk of 8 reaches
    seg ~ +140, whose exp is inf in float32 (the wkv runs in float32 in
    both packages, also in x64 mode). Both packages stay finite and agree;
    the port agrees with its oracle."""
    with _x64(dtype):
        cfg_j, cfg_t, pj, pt, xj, xt = _setup("rwkv6-3b", rwkv6_jax.rwkv6_metas, dtype, (2, 16),
                                              seed=2, edit=_saturate_rwkv)
        *_, w, _ = rwkv6._time_mix_inputs(cfg_t, pt["tm"], xt)
        assert float(w.min()) == -20.0 and float(-w[:, :7].sum(1).max()) > 89
        want, sj = rwkv6_jax.rwkv6_time_mix(cfg_j, pj["tm"], xj, chunk=8, want_state=True)
        got, st = rwkv6.rwkv6_time_mix(cfg_t, pt["tm"], xt, chunk=8, want_state=True)
        _close(got, want, dtype)
        _close(st, sj, dtype)
        _oracle_close(got.float(), rwkv6.rwkv6_time_mix_ref(cfg_t, pt["tm"], xt).float())


def test_metas_match_jax():
    """Leaf names, shapes and initialisers of both blocks equal the JAX
    package's."""
    for arch, mj, mt in (("zamba2-7b", mamba2_jax.mamba2_metas, mamba2.mamba2_metas),
                         ("rwkv6-3b", rwkv6_jax.rwkv6_metas, rwkv6.rwkv6_metas)):
        want = mj(get_smoke_jax(arch))
        got = mt(get_smoke(arch))
        lw = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda v: hasattr(v, "init"))[0]
        lg, _ = tree.flatten(got)
        assert [(m.shape, m.init, m.init_scale) for m in lg] == [
            (m.shape, m.init, m.init_scale) for _, m in lw]
