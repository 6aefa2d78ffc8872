"""The port's dense LLM serving path against the JAX package, on the smoke
configs of Gemma-2 9B (local + global attention, softcaps, post-norms;
window 16) and Gemma 2B (MQA): the same parameters (the JAX package's
init, carried over with `params_from_numpy`) and the same prompts.

Held: `forward` logits; `prefill` logits and every cache leaf; 4
`decode_step`s, whose logits agree and whose greedy tokens are
identical; the serving entry point end to end. Tolerances on float32:
rtol 1e-4, atol 1e-5 (the port's attention takes a two-pass softmax and
the JAX model an online one over 512-row chunks; matmul sums run in
another order), and atol adds 1e-4 of the largest |value| of each
compared tensor: random init makes the smoke models ill-conditioned.
Measured against the port run in float64 on the CPU, both packages'
float32 logits sit up to 3e-5 of the largest logit from it (Gemma 2B:
2.1e-3 and 2.3e-3 at a largest logit of 78; Gemma-2: 2.3e-5 and 2.6e-5
at 30), so neither meets atol 1e-5 alone. One bfloat16 variant is
held in relative L2 norm (bf16 rounds at other places in the two
frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.configs import get_smoke as get_smoke_jax
from repro.models.registry import build as build_jax
from repro_torch import tree
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch.serve import serve
from repro_torch.models.registry import build, params_from_numpy

RTOL, ATOL, SCALE_ATOL = 1e-4, 1e-5, 1e-4  # SCALE_ATOL: times max |want|
ARCHS = ["gemma2-9b", "gemma-2b"]
B, S, N_DECODE = 2, 40, 4


def _setup(arch, **overrides):
    cfg_j = get_smoke_jax(arch, **overrides)
    cfg_t = get_smoke(arch, **overrides)
    params_j = build_jax(cfg_j).init(jax.random.PRNGKey(0))
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    return cfg_j, cfg_t, params_j, params_t, tokens


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want):
    got, want = _np(got), _np(want)
    atol = ATOL + SCALE_ATOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def test_configs_and_param_trees_match():
    for arch in ARCHS:
        for get_j, get_t in ((get_smoke_jax, get_smoke), (get_config_jax, get_config)):
            cfg_j, cfg_t = get_j(arch), get_t(arch)
            assert cfg_t.name == cfg_j.name and cfg_t.pattern == cfg_j.pattern
            assert build(cfg_t).num_params() == build_jax(cfg_j).num_params()
    metas_t = build(get_smoke("gemma2-9b")).metas()
    params_j = build_jax(get_smoke_jax("gemma2-9b")).init(jax.random.PRNGKey(0))
    leaves_t, def_t = tree.flatten(metas_t)
    leaves_j, _ = jax.tree.flatten(params_j)
    assert [m.shape for m in leaves_t] == [a.shape for a in leaves_j]
    assert build(get_config("gemma2-9b")).num_params() == 9_241_705_984


def test_unported_kinds_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("mixtral-8x22b")
    cfg = get_smoke("gemma-2b").replace(pattern=("moe",))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(cfg).metas()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    cfg_j, cfg_t, params_j, params_t, tokens = _setup(arch)
    want, _ = build_jax(cfg_j).forward(params_j, jnp.asarray(tokens))
    got = build(cfg_t).forward(params_t, torch.from_numpy(tokens))
    assert got.shape == (B, S, cfg_t.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("arch,ring", [("gemma2-9b", False), ("gemma-2b", False),
                                       ("gemma2-9b", True)])
def test_prefill_and_decode_match_jax(arch, ring):
    """Prefill's logits and caches, then 4 decode steps. ``ring`` turns on
    the ring cache: the local layers keep min(seq, window) = 16 slots."""
    cfg_j, cfg_t, params_j, params_t, tokens = _setup(arch, decode_window_slicing=ring)
    mj, mt = build_jax(cfg_j), build(cfg_t)
    cache_len = S + N_DECODE
    logits_j, caches_j = mj.prefill(params_j, jnp.asarray(tokens), cache_len)
    logits_t, caches_t = mt.prefill(params_t, torch.from_numpy(tokens), cache_len)
    _close(logits_t, logits_j)
    leaves_j, _ = jax.tree.flatten(caches_j)
    leaves_t, _ = tree.flatten(caches_t)
    assert [a.shape for a in leaves_j] == [tuple(t.shape) for t in leaves_t]
    if ring:
        assert caches_t["b0"]["k"].shape[2] == cfg_t.window_size
    for a, t in zip(leaves_j, leaves_t):
        _close(t, a)

    decode_j = jax.jit(mj.decode_step)
    tok_j = jnp.argmax(logits_j[:, -1:], axis=-1).astype(jnp.int32)
    tok_t = torch.argmax(logits_t[:, -1:], dim=-1).to(torch.int32)
    for i in range(N_DECODE):
        assert np.array_equal(np.asarray(tok_j), tok_t.numpy())
        logits_j, caches_j = decode_j(params_j, caches_j, tok_j, jnp.int32(S + i))
        logits_t, caches_t = mt.decode_step(params_t, caches_t, tok_t, S + i)
        _close(logits_t, logits_j)
        tok_j = jnp.argmax(logits_j[:, -1:], axis=-1).astype(jnp.int32)
        tok_t = torch.argmax(logits_t[:, -1:], dim=-1).to(torch.int32)
    assert np.array_equal(np.asarray(tok_j), tok_t.numpy())
    for a, t in zip(jax.tree.leaves(caches_j), tree.leaves(caches_t)):
        _close(t, a)


def test_bf16_forward_matches_jax_in_norm():
    """Gemma-2 smoke in bfloat16 params and compute. bf16 rounds at other
    places in the two frameworks (each matmul's output, the GeGLU product),
    so the logits are held in relative L2 norm, at 2e-2; the embedding
    scale is rounded to bf16 first in both."""
    cfg_j, cfg_t, params_j, params_t, tokens = _setup(
        "gemma2-9b", param_dtype="bfloat16", compute_dtype="bfloat16")
    assert params_t["embed"]["tok"].dtype == torch.bfloat16
    want, _ = build_jax(cfg_j).forward(params_j, jnp.asarray(tokens))
    got = build(cfg_t).forward(params_t, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    got, want = _np(got), _np(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel


@pytest.mark.parametrize("field,value", [("pos", "learned"), ("pos", "sinusoidal"),
                                         ("mlp_act", "swiglu"), ("mlp_act", "gelu")])
def test_unported_layer_options_raise(field, value):
    """Positions and MLPs that no ported config uses wait for item 7."""
    cfg = get_smoke("gemma-2b").replace(**{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(cfg).metas()


@pytest.mark.parametrize("n_tokens", [1, 5])
def test_serve_cli_tokens_as_in_jax(n_tokens, capsys):
    """``--tokens N`` prints N tokens of row 0 in both packages' CLIs: the
    prefill's token and N - 1 decode steps."""
    from repro.launch import serve as serve_jax
    from repro_torch.launch import serve as serve_torch

    argv = ["--arch", "gemma-2b", "--batch", "2", "--prompt-len", "8",
            "--tokens", str(n_tokens)]
    counts = []
    for run in (lambda: serve_jax.main(argv), lambda: serve_torch.main(argv + ["--device", "cpu"])):
        run()
        sample = [l for l in capsys.readouterr().out.splitlines() if l.startswith("sample:")]
        counts.append(len(eval(sample[0].split(":", 1)[1])))
    assert counts == [n_tokens, n_tokens]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_cpu(arch):
    """The serving entry point on the CPU: greedy tokens equal a decode
    loop driven through the JAX package on the same weights."""
    cfg_j, cfg_t, params_j, params_t, tokens = _setup(arch)
    n = 3
    r = serve(cfg_t, params_t, torch.from_numpy(tokens), n, device="cpu")
    assert r["tokens"].shape == (B, n + 1) and r["finite"]
    assert r["launches"] == {"prefill": {"rms_norm": 0, "flash_attention": 0},
                             "decode": {"rms_norm": 0, "flash_attention": 0}}
    mj = build_jax(cfg_j)
    logits, caches = mj.prefill(params_j, jnp.asarray(tokens), S + n)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(n):
        logits, caches = mj.decode_step(params_j, caches, tok, jnp.int32(S + i))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(tok)
    assert np.array_equal(np.concatenate(out, axis=1), r["tokens"].numpy())


@pytest.mark.parametrize("ring", [False, True])
def test_init_cache_matches_jax(ring):
    cfg_j = get_smoke_jax("gemma2-9b", decode_window_slicing=ring)
    cfg_t = get_smoke("gemma2-9b", decode_window_slicing=ring)
    want = build_jax(cfg_j).init_cache(B, S)
    got = build(cfg_t).init_cache(B, S, device="cpu")
    leaves_j, leaves_t = jax.tree.leaves(want), tree.leaves(got)
    assert [a.shape for a in leaves_j] == [tuple(t.shape) for t in leaves_t]
    assert all(t.dtype == torch.float32 and not t.any() for t in leaves_t)
