"""Cross-attention, the encoder and the layer options they bring, in the
port against the JAX package, on the smoke configs of Llama-3.2-Vision
(4 self-attention blocks and one gated cross-attention block, ``xattn``)
and Whisper large-v3 (an encoder of non-causal blocks, decoder blocks of
self- and cross-attention, ``attn_xattn``; LayerNorm, sinusoidal
positions, the plain tanh-GELU MLP): the same parameters (the JAX
package's init, carried over with `params_from_numpy`), memory and
tokens from numpy seeds.

Held: the sinusoidal encoding, learned positions and the plain-gelu MLP;
`cross_attention` with Sq != Skv and a ragged Skv (40 queries over 37
memory positions), `precompute_cross_cache` and
`decode_cross_attention`; `block_apply` of both cross-attention kinds
(the ``xattn`` gate set non-zero) with their caches; `encode`;
`forward`; prefill with every cache leaf, then 4 decode steps (logits,
greedy tokens, the caches after them); `init_cache` with ``mem_len``.
Tolerances as in `tests/test_torch_llm.py`, on float32: rtol 1e-4, atol
1e-5 plus 1e-4 of the largest |value| of each compared tensor (the two
packages' attention softmaxes and matmul sums run in other orders). The
layer-level cases take the JAX package's raw init; the model-level ones
(`encode`, `forward`, prefill and decode) its attention projections at
fan-in d_model (`test_torch_llm.conditioned`), without which float32
itself is 1.6% of the largest logit from float64 on the Whisper smoke
config.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as get_smoke_jax
from repro.models import attention as attn_jax
from repro.models import layers as layers_jax
from repro.models import transformer as tfm_jax
from repro.models.common import init_params as init_params_jax
from repro.models.registry import build as build_jax
from repro_torch import tree
from repro_torch.configs import get_smoke
from repro_torch.models import attention as attn_t
from repro_torch.models import layers as layers_t
from repro_torch.models import transformer as tfm_t
from repro_torch.models.registry import build, params_from_numpy
from test_torch_llm import B, N_DECODE, S, _np, conditioned, memory_for

ARCHS = ["llama-3.2-vision-90b", "whisper-large-v3"]
MEM = 37  # memory positions in the layer-level cases: ragged, != S


def _close(got, want):
    """`tests/test_torch_llm.py`'s tolerance (rtol 1e-4, atol 1e-5 + 1e-4
    max |want|), after a shape check."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = 1e-5 + 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


def _carry(params_j):
    return params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


def _model(arch, open_gates=False, **overrides):
    """Both configs, the JAX package's init with its attention projections
    at fan-in d_model (`test_torch_llm.conditioned`: at the raw init the
    whole model is chaotic in float32) carried over, tokens and a memory
    of N(0, 1) stub embeddings. ``open_gates`` sets every ``xattn`` gate
    to 0.5: at the init's 0 the cross-attention adds nothing."""
    cfg_j, cfg_t = get_smoke_jax(arch, **overrides), get_smoke(arch, **overrides)
    params_j = conditioned(cfg_j, build_jax(cfg_j).init(jax.random.PRNGKey(0)))
    if open_gates:
        for i, kind in enumerate(cfg_j.pattern):
            if kind == "xattn":
                gate = params_j["groups"][f"b{i}"]["gate"]
                params_j["groups"][f"b{i}"]["gate"] = jnp.full(gate.shape, 0.5, gate.dtype)
    params_t = _carry(params_j)
    tokens = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    return cfg_j, cfg_t, params_j, params_t, tokens, memory_for(cfg_t)


def _block_params(arch, kind, gate=0.0):
    cfg_j, cfg_t = get_smoke_jax(arch), get_smoke(arch)
    params_j = init_params_jax(tfm_jax.block_metas(cfg_j, kind), jax.random.PRNGKey(3),
                               jnp.float32)
    if "gate" in params_j:
        params_j["gate"] = jnp.full((1,), gate, jnp.float32)
    return cfg_j, cfg_t, params_j, _carry(params_j)


@pytest.mark.parametrize("d_model,max_pos", [(128, 40), (33, 40), (2, 5), (1280, 448)])
def test_sinusoidal_pos_matches_jax(d_model, max_pos):
    """[sin, cos] over d_model // 2 frequencies with denominator
    max(half - 1, 1), up to Whisper's decoder context of 448: in float32
    at the file's tolerance (the two libraries' exp differs by an ulp in
    some frequencies, which a position multiplies), and cast to bf16
    within one bf16 ulp of 1 (2^-8: such a difference can round to the
    neighbouring value)."""
    pos = np.random.default_rng(4).integers(0, max_pos, (B, 16)).astype(np.int32)
    pj, pt = _both(pos)
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = layers_jax.sinusoidal_pos(pj, d_model, dt_j)
        got = layers_t.sinusoidal_pos(pt, d_model, dt_t)
        assert got.dtype == dt_t and tuple(got.shape) == want.shape == (B, 16, 2 * (d_model // 2))
        if dt_t == torch.float32:
            _close(got, want)
        else:
            np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2 ** -8)


@pytest.mark.parametrize("pos", ["learned", "sinusoidal"])
def test_embed_positions_match_jax(pos):
    """Learned positions (a (max_position, d) table, kept small here) and
    sinusoidal ones added to the token embedding."""
    cfg_j = get_smoke_jax("gemma-2b", pos=pos, max_position=64)
    cfg_t = get_smoke("gemma-2b", pos=pos, max_position=64)
    metas_t = layers_t.embed_metas(cfg_t)
    assert sorted(metas_t) == (["pos", "tok"] if pos == "learned" else ["tok"])
    params_j = init_params_jax(layers_jax.embed_metas(cfg_j), jax.random.PRNGKey(5),
                               jnp.float32)
    assert {k: v.shape for k, v in params_j.items()} == {k: m.shape for k, m in metas_t.items()}
    tokens = np.random.default_rng(6).integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    positions = np.random.default_rng(7).integers(0, 64, (B, S)).astype(np.int32)
    want = layers_jax.embed_apply(cfg_j, params_j, *map(jnp.asarray, (tokens, positions)))
    got = layers_t.embed_apply(cfg_t, _carry(params_j), *map(torch.from_numpy,
                                                                (tokens, positions)))
    _close(got, want)


def test_plain_gelu_mlp_matches_jax():
    """gelu(x @ wu) @ wd with the tanh approximation, as the JAX package's
    ``jax.nn.gelu(approximate=True)``; no ``wg``."""
    cfg_j, cfg_t = get_smoke_jax("whisper-large-v3"), get_smoke("whisper-large-v3")
    assert sorted(layers_t.mlp_metas(cfg_t)) == ["wd", "wu"]
    params_j = init_params_jax(layers_jax.mlp_metas(cfg_j), jax.random.PRNGKey(8), jnp.float32)
    x = _randn(9, B, S, cfg_t.d_model) * 3
    xj, xt = _both(x)
    want = layers_jax.mlp_apply(cfg_j, params_j, xj)
    got = layers_t.mlp_apply(cfg_t, _carry(params_j), xt)
    _close(got, want)
    erf = torch.nn.functional.gelu(xt @ _carry(params_j)["wu"]) @ _carry(params_j)["wd"]
    assert float((erf - got).abs().max()) > 1e-5  # the erf form is not the same function


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_matches_jax(arch):
    """40 queries over a ragged memory of 37 positions (GQA with G = 2 for
    Llama-3.2-Vision, G = 1 for Whisper): the full-sequence path through
    the flash-attention wrapper, the memory's K/V, and one decode step's
    attention onto them."""
    cfg_j, cfg_t = get_smoke_jax(arch), get_smoke(arch)
    params_j = init_params_jax(attn_jax.attn_metas(cfg_j), jax.random.PRNGKey(10),
                               jnp.float32)
    params_t = _carry(params_j)
    x, mem = _randn(11, B, S, cfg_t.d_model), _randn(12, B, MEM, cfg_t.d_model)
    (xj, xt), (mj, mt) = _both(x), _both(mem)
    _close(attn_t.cross_attention(cfg_t, params_t, xt, mt),
           attn_jax.cross_attention(cfg_j, params_j, xj, mj))
    cache_j = attn_jax.precompute_cross_cache(cfg_j, params_j, mj)
    cache_t = attn_t.precompute_cross_cache(cfg_t, params_t, mt)
    assert sorted(cache_t) == ["k", "v"]
    assert tuple(cache_t["k"].shape) == (B, MEM, cfg_t.num_kv_heads, cfg_t.resolved_head_dim)
    for k in ("k", "v"):
        _close(cache_t[k], cache_j[k])
    _close(attn_t.decode_cross_attention(cfg_t, params_t, xt[:, -1:], cache_t),
           attn_jax.decode_cross_attention(cfg_j, params_j, xj[:, -1:], cache_j))


@pytest.mark.parametrize("arch,kind", [("llama-3.2-vision-90b", "xattn"),
                                       ("whisper-large-v3", "attn_xattn")])
@pytest.mark.parametrize("want_cache", [False, True])
def test_cross_blocks_match_jax(arch, kind, want_cache):
    """`block_apply` of both cross-attention kinds over a ragged memory,
    with the ``xattn`` gate at 0.7 (0 at init would hide the
    cross-attention); the prefill cache (``xk``, ``xv``, and ``k``, ``v``
    for ``attn_xattn``) too."""
    cfg_j, cfg_t, params_j, params_t = _block_params(arch, kind, gate=0.7)
    assert [k for k in tfm_t.block_metas(cfg_t, kind)] == list(
        tfm_jax.block_metas(cfg_j, kind))
    x, mem = _randn(13, B, S, cfg_t.d_model), _randn(14, B, MEM, cfg_t.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    (xj, xt), (mj, mt), (pj, pt) = _both(x), _both(mem), _both(pos)
    yj, _, cj = tfm_jax.block_apply(cfg_j, kind, params_j, xj, positions=pj, memory=mj,
                                    want_cache=want_cache)
    yt, aux, ct = tfm_t.block_apply(cfg_t, kind, params_t, xt, positions=pt, memory=mt,
                                    want_cache=want_cache)
    _close(yt, yj)
    assert float(aux) == 0.0
    if not want_cache:
        assert ct is None
        return
    assert sorted(ct) == sorted(cj) == (["k", "v", "xk", "xv"] if kind == "attn_xattn"
                                        else ["xk", "xv"])
    for k in ct:
        _close(ct[k], cj[k])


def test_xattn_gate_scales_the_cross_attention():
    """At the init's gate of 0 an ``xattn`` block is its MLP alone: the
    memory changes nothing."""
    cfg_j, cfg_t, _, params_t = _block_params("llama-3.2-vision-90b", "xattn", gate=0.0)
    x = torch.from_numpy(_randn(15, B, S, cfg_t.d_model))
    pos = torch.arange(S).expand(B, S)
    outs = [tfm_t.block_apply(cfg_t, "xattn", params_t, x, positions=pos,
                              memory=torch.from_numpy(_randn(seed, B, MEM, cfg_t.d_model)))[0]
            for seed in (16, 17)]
    assert torch.equal(outs[0], outs[1])


def test_encode_matches_jax():
    """Whisper's encoder over stub frames: its ``attn_nc`` blocks (no
    positions added: the blocks apply rope only for ``pos == "rope"``),
    then its final LayerNorm."""
    cfg_j, cfg_t, params_j, params_t, _, memory = _model("whisper-large-v3")
    assert sorted(params_t["encoder"]) == ["final_norm", "groups"]
    assert params_t["encoder"]["groups"]["b0"]["attn"]["wq"].shape[0] == cfg_t.encoder_layers
    mj, mt = _both(memory)
    want = tfm_jax.encode(cfg_j, params_j, mj)
    got = tfm_t.encode(cfg_t, params_t, mt)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_memory_matches_jax(arch):
    """`forward` over the memory (encoded for Whisper, cast for
    Llama-3.2-Vision), with the ``xattn`` gates set non-zero."""
    cfg_j, cfg_t, params_j, params_t, tokens, memory = _model(arch, open_gates=True)
    (tj, tt), (mj, mt) = _both(tokens), _both(memory)
    want, _ = build_jax(cfg_j).forward(params_j, tj, mj)
    got, aux = build(cfg_t).forward(params_t, tt, mt)
    assert got.shape == (B, S, cfg_t.vocab_size) and float(aux) == 0.0
    _close(got, want)
    without, _ = build(cfg_t).forward(params_t, tt, mt * 0.0)
    assert not torch.allclose(without, got)  # the memory reaches the logits


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_with_memory_match_jax(arch):
    """Prefill over the memory (every cache leaf: self K/V padded to the
    cache length, cross K/V at the memory's length), then 4 decode steps
    reading the cross caches: logits, greedy tokens and the caches after
    them."""
    cfg_j, cfg_t, params_j, params_t, tokens, memory = _model(arch, open_gates=True)
    mj_, mt_ = build_jax(cfg_j), build(cfg_t)
    (tj, tt), (mj, mt) = _both(tokens), _both(memory)
    cache_len = S + N_DECODE
    logits_j, caches_j = mj_.prefill(params_j, tj, cache_len, mj)
    logits_t, caches_t = mt_.prefill(params_t, tt, cache_len, mt)
    _close(logits_t, logits_j)
    paths_j = [tuple(p.key for p in path)
               for path, _ in jax.tree_util.tree_flatten_with_path(caches_j)[0]]
    leaves_t, _ = tree.flatten(caches_t)
    assert [p[-1] for p in paths_j] == [p for _, c in sorted(caches_t.items())
                                        for p in sorted(c)]
    assert any(p[-1] == "xk" for p in paths_j)
    for a, t in zip(jax.tree.leaves(caches_j), leaves_t):
        assert a.shape == tuple(t.shape) and a.dtype.name == str(t.dtype)[6:]
        _close(t, a)
    xk = caches_t["b0" if arch == "whisper-large-v3" else "b4"]["xk"]
    assert xk.shape[2] == cfg_t.num_xattn_tokens
    before = xk.clone()

    decode_j = jax.jit(mj_.decode_step)
    tok_j = jnp.argmax(logits_j[:, -1:], axis=-1).astype(jnp.int32)
    tok_t = torch.argmax(logits_t[:, -1:], dim=-1).to(torch.int32)
    for i in range(N_DECODE):
        assert np.array_equal(np.asarray(tok_j), tok_t.numpy())
        logits_j, caches_j = decode_j(params_j, caches_j, tok_j, jnp.int32(S + i))
        logits_t, caches_t = mt_.decode_step(params_t, caches_t, tok_t, S + i)
        _close(logits_t, logits_j)
        tok_j = jnp.argmax(logits_j[:, -1:], axis=-1).astype(jnp.int32)
        tok_t = torch.argmax(logits_t[:, -1:], dim=-1).to(torch.int32)
    assert np.array_equal(np.asarray(tok_j), tok_t.numpy())
    for a, t in zip(jax.tree.leaves(caches_j), tree.leaves(caches_t)):
        _close(t, a)
    assert torch.equal(xk, before)  # decode only reads the cross cache


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_with_mem_len_matches_jax(arch):
    """`init_cache` with ``mem_len``: the cross caches (G, B, mem_len, KV,
    hd), beside self K/V of the cache length; names, shapes and dtypes as
    in the JAX package, all zero."""
    over = dict(compute_dtype="bfloat16")
    want = build_jax(get_smoke_jax(arch, **over)).init_cache(B, S, mem_len=MEM)
    got = build(get_smoke(arch, **over)).init_cache(B, S, mem_len=MEM, device="cpu")
    paths_j = [tuple(p.key for p in path)
               for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    flat_t = [(k, kk, v) for k, c in sorted(got.items()) for kk, v in sorted(c.items())]
    assert [p for p in paths_j] == [(k, kk) for k, kk, _ in flat_t]
    assert [(a.shape, a.dtype.name) for a in jax.tree.leaves(want)] == [
        (tuple(t.shape), str(t.dtype)[6:]) for _, _, t in flat_t]
    assert all(not t.any() for _, _, t in flat_t)
    assert all(t.shape[2] == (MEM if kk in ("xk", "xv") else S) for _, kk, t in flat_t)
    metas = build(get_smoke(arch)).cache_metas(B, S, MEM)
    assert {k: sorted(c) for k, c in metas.items()} == {k: sorted(c) for k, c in got.items()}


def test_unknown_block_kind_raises_value_error():
    """As in the JAX package: a kind outside the block table is a
    ``ValueError`` everywhere, never a missing port."""
    cfg_t = get_smoke("gemma-2b").replace(pattern=("attn_mystery",))
    with pytest.raises(ValueError, match="unknown block kind"):
        build(cfg_t).metas()
    with pytest.raises(ValueError):
        tfm_t.block_apply(cfg_t, "attn_mystery", {}, torch.zeros(1, 2, 4),
                          positions=torch.zeros(1, 2, dtype=torch.int64))
    with pytest.raises(ValueError):
        tfm_t.block_decode(cfg_t, "attn_mystery", {}, torch.zeros(1, 1, 4), {}, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_takes_the_cross_attention_smoke_configs(arch, capsys):
    """``--arch llama-3.2-vision-90b`` and ``--arch whisper-large-v3`` with
    ``--device cpu`` feed the JAX CLI's stub memory (0.1 everywhere) and
    serve the smoke configs: finite logits, no kernel launches,
    ``--tokens`` tokens."""
    from repro_torch.launch import serve as serve_torch

    serve_torch.main(["--arch", arch, "--batch", "2", "--prompt-len", "8",
                      "--tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={arch} device=cpu" in out and "finite=True" in out
    assert "'rms_norm': 0, 'flash_attention': 0" in out
    sample = [l for l in out.splitlines() if l.startswith("sample:")]
    assert len(eval(sample[0].split(":", 1)[1])) == 4


@pytest.mark.parametrize("arch", ["gemma2-9b", "moonshot-v1-16b-a3b", "zamba2-7b", "rwkv6-3b",
                                  "llama-3.2-vision-90b", "whisper-large-v3"])
def test_chip_smoke_expected_launches_count_the_calls(arch, monkeypatch):
    """`chip_smoke.expected_launches`, which the card's run holds K3's and
    K4's launch counts to, against the calls the model makes to the two
    wrappers on the CPU (counted by wrapping them), over one prefill (the
    encoder included) and 2 decode steps of each family's smoke config."""
    import importlib.util
    from pathlib import Path

    from repro_torch.launch.serve import serve

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    calls = {"rms_norm": 0, "flash_attention": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    # every RMSNorm, the recurrent blocks' inner norms too, goes through
    # `layers.rms_norm` and the wrapper it names
    monkeypatch.setattr(layers_t, "_rms_norm_kernel",
                        counted("rms_norm", layers_t._rms_norm_kernel))
    monkeypatch.setattr(attn_t, "flash_attention",
                        counted("flash_attention", attn_t.flash_attention))
    cfg = get_smoke(arch)
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    prompt = torch.randint(0, cfg.vocab_size, (B, 12), generator=torch.Generator().manual_seed(1))
    mem = memory_for(cfg)
    n_decode = 2
    serve(cfg, params, prompt, 0, device="cpu",
          memory=None if mem is None else torch.from_numpy(mem))
    prefill = dict(calls)
    serve(cfg, params, prompt, n_decode, device="cpu",
          memory=None if mem is None else torch.from_numpy(mem))
    k3_prefill, k3_decode, k4 = chip_smoke.expected_launches(cfg)
    assert prefill == {"rms_norm": k3_prefill, "flash_attention": k4}
    assert calls == {"rms_norm": 2 * k3_prefill + n_decode * k3_decode,
                     "flash_attention": 2 * k4}
