"""The port's LLM serving path against the JAX package, on the smoke
configs of Gemma-2 9B (local + global attention, softcaps, post-norms;
window 16), Gemma 2B (MQA), Moonlight-16B-A3B (MoE: 4 experts top-2 and
a shared expert, SwiGLU), Mixtral 8x22B (windowed MoE, no shared
expert), Llama-4 Maverick (dense and MoE blocks alternating, top-1),
Llama 3 405B (dense SwiGLU), Zamba2-7B (Mamba2 blocks and a shared
attention block), RWKV6-3B (LayerNorm, no positions), Llama-3.2-Vision
(gated cross-attention) and Whisper large-v3 (an encoder; sinusoidal
positions, the plain-gelu MLP): the same parameters (the JAX package's
init, carried over with `params_from_numpy`), the same prompts and, for
the last two, the same N(0, 1) stub memory (`tests/test_torch_xattn.py`
holds their layers and caches).

Held: `forward` logits and the MoE aux loss; `prefill` logits and every
cache leaf (K/V, and the recurrent states the prefill hands to decode);
4 `decode_step`s (8 for the recurrent configs), whose logits agree and
whose greedy tokens are identical (a decode step of the MoE configs has
cap = 1, so a token is dropped whenever both rows pick the same expert,
as in the JAX package); the serving entry point end to end. Tolerances on float32:
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
ARCHS = ["gemma2-9b", "gemma-2b", "moonshot-v1-16b-a3b", "mixtral-8x22b",
         "llama4-maverick-400b-a17b", "llama3-405b", "zamba2-7b", "rwkv6-3b",
         "llama-3.2-vision-90b", "whisper-large-v3"]
MOE_ARCHS = ["moonshot-v1-16b-a3b", "mixtral-8x22b", "llama4-maverick-400b-a17b"]
RECURRENT_ARCHS = ["zamba2-7b", "rwkv6-3b"]
B, S, N_DECODE = 2, 40, 4
N_DECODE_RECURRENT = 8


def conditioned(cfg, params_j):
    """The JAX init draws ``wq`` (d, KV, G, hd) with fan-in G and ``wk``,
    ``wv`` (d, KV, hd) with fan-in KV, their second-to-last axes: scores of
    a few hundred and a near-hard-max softmax. On the Whisper smoke config
    with its memory, float32 itself, in either package, then sits 1.6% of
    the largest logit from the same model in float64, and the two packages
    1.1e-3 from each other: no tolerance tells a wrong function from
    roundoff there. With the three projections rescaled to fan-in d_model,
    as a projection from d_model is meant to be drawn (in the JAX params,
    before they are carried over, so both packages get the same weights),
    both float32 runs sit within 6e-7 of float64 (measured on both
    cross-attention smoke configs). Applied to the configs with
    cross-attention; the others pass at the raw init."""
    g = cfg.num_heads // cfg.num_kv_heads
    scale = {"wq": np.float32((g / cfg.d_model) ** 0.5),
             "wk": np.float32((cfg.num_kv_heads / cfg.d_model) ** 0.5),
             "wv": np.float32((cfg.num_kv_heads / cfg.d_model) ** 0.5)}

    def walk(d):
        return {k: walk(v) if isinstance(v, dict) else v * scale[k] if k in scale else v
                for k, v in d.items()}

    return walk(params_j)


def memory_for(cfg):
    """(B, num_xattn_tokens, d_model) N(0, 1) stub embeddings for a config
    with cross-attention, else None."""
    if not cfg.num_xattn_tokens:
        return None
    return np.random.default_rng(2).standard_normal(
        (B, cfg.num_xattn_tokens, cfg.d_model)).astype(np.float32)


def _setup(arch, **overrides):
    cfg_j = get_smoke_jax(arch, **overrides)
    cfg_t = get_smoke(arch, **overrides)
    params_j = build_jax(cfg_j).init(jax.random.PRNGKey(0))
    if cfg_j.num_xattn_tokens:
        params_j = conditioned(cfg_j, params_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    return cfg_j, cfg_t, params_j, params_t, tokens


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want):
    got, want = _np(got), _np(want)
    atol = ATOL + SCALE_ATOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def _paths(d, prefix=()):
    """Key paths of a nest of dicts, in sorted-key (flatten) order."""
    if not isinstance(d, dict):
        return [prefix]
    return [p for k in sorted(d) for p in _paths(d[k], prefix + (k,))]


def test_configs_and_param_trees_match():
    for arch in ARCHS:
        for get_j, get_t in ((get_smoke_jax, get_smoke), (get_config_jax, get_config)):
            cfg_j, cfg_t = get_j(arch), get_t(arch)
            assert cfg_t == cfg_t.replace(**{f: getattr(cfg_j, f)
                                             for f in cfg_j.__dataclass_fields__})
            assert build(cfg_t).num_params() == build_jax(cfg_j).num_params()
        metas_t = build(get_smoke(arch)).metas()
        params_j = build_jax(get_smoke_jax(arch)).init(jax.random.PRNGKey(0))
        leaves_t, _ = tree.flatten(metas_t)
        leaves_j = jax.tree_util.tree_flatten_with_path(params_j)[0]
        assert [m.shape for m in leaves_t] == [a.shape for _, a in leaves_j]
        assert _paths(metas_t) == [tuple(p.key for p in path) for path, _ in leaves_j]
    assert build(get_config("gemma2-9b")).num_params() == 9_241_705_984
    assert build(get_config("moonshot-v1-16b-a3b")).num_params() == 28_552_923_136
    assert build(get_config("zamba2-7b")).num_params() == 6_635_851_856
    assert build(get_config("rwkv6-3b")).num_params() == 2_690_501_120
    # counted from the metas, nothing drawn
    assert build(get_config("whisper-large-v3")).num_params() == 1_534_602_240
    assert build(get_config("llama-3.2-vision-90b")).num_params() == 86_616_121_364


def test_unported_kinds_raise():
    """Every block kind of the JAX package is ported: an unknown kind
    raises ``ValueError`` in both packages, as the JAX package's does, and
    both cross-attention configs build."""
    for arch in ("llama-3.2-vision-90b", "whisper-large-v3"):
        assert build(get_config(arch)).num_params() == build_jax(get_config_jax(arch)).num_params()
    cfg = get_smoke("gemma-2b").replace(pattern=("attn_mystery",))
    with pytest.raises(ValueError, match="unknown block kind"):
        build(cfg).metas()
    with pytest.raises(ValueError, match="unknown block kind"):
        build_jax(get_smoke_jax("gemma-2b").replace(pattern=("attn_mystery",))).metas()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    cfg_j, cfg_t, params_j, params_t, tokens = _setup(arch)
    mem = memory_for(cfg_t)
    want, aux_j = build_jax(cfg_j).forward(params_j, jnp.asarray(tokens),
                                           None if mem is None else jnp.asarray(mem))
    got, aux_t = build(cfg_t).forward(params_t, torch.from_numpy(tokens),
                                      None if mem is None else torch.from_numpy(mem))
    assert got.shape == (B, S, cfg_t.vocab_size)
    _close(got, want)
    assert aux_t.dtype == torch.float32 and aux_t.shape == ()
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=RTOL, atol=ATOL)
    assert (float(aux_t) > 0.5) == (arch in MOE_ARCHS)  # ~1 for near-uniform routing


@pytest.mark.parametrize("arch,ring", [("gemma2-9b", False), ("gemma-2b", False),
                                       ("gemma2-9b", True),
                                       ("moonshot-v1-16b-a3b", False),
                                       ("mixtral-8x22b", False), ("mixtral-8x22b", True),
                                       ("llama4-maverick-400b-a17b", False),
                                       ("llama3-405b", False),
                                       ("zamba2-7b", False), ("zamba2-7b", True),
                                       ("rwkv6-3b", False)])
def test_prefill_and_decode_match_jax(arch, ring):
    """Prefill's logits and caches, then 4 decode steps (8 for the
    recurrent configs). ``ring`` turns on the ring cache: the local layers
    keep min(seq, window) = 16 slots; Zamba2, which has no window, takes
    ``attn_window_override=8`` (as the JAX package's ring-cache test
    does), so its shared block keeps 8."""
    over = dict(attn_window_override=8) if ring and arch == "zamba2-7b" else {}
    cfg_j, cfg_t, params_j, params_t, tokens = _setup(arch, decode_window_slicing=ring, **over)
    mj, mt = build_jax(cfg_j), build(cfg_t)
    n_decode = N_DECODE_RECURRENT if arch in RECURRENT_ARCHS else N_DECODE
    cache_len = S + n_decode
    logits_j, caches_j = mj.prefill(params_j, jnp.asarray(tokens), cache_len)
    logits_t, caches_t = mt.prefill(params_t, torch.from_numpy(tokens), cache_len)
    _close(logits_t, logits_j)
    leaves_j, _ = jax.tree.flatten(caches_j)
    leaves_t, _ = tree.flatten(caches_t)
    assert [a.shape for a in leaves_j] == [tuple(t.shape) for t in leaves_t]
    assert [a.dtype.name for a in leaves_j] == [str(t.dtype)[6:] for t in leaves_t]
    if ring:
        ringed = caches_t["shared"] if over else caches_t["b0"]
        assert ringed["k"].shape[2] == (8 if over else cfg_t.window_size)
    for a, t in zip(leaves_j, leaves_t):
        _close(t, a)

    decode_j = jax.jit(mj.decode_step)
    tok_j = jnp.argmax(logits_j[:, -1:], axis=-1).astype(jnp.int32)
    tok_t = torch.argmax(logits_t[:, -1:], dim=-1).to(torch.int32)
    for i in range(n_decode):
        assert np.array_equal(np.asarray(tok_j), tok_t.numpy())
        logits_j, caches_j = decode_j(params_j, caches_j, tok_j, jnp.int32(S + i))
        logits_t, caches_t = mt.decode_step(params_t, caches_t, tok_t, S + i)
        _close(logits_t, logits_j)
        tok_j = jnp.argmax(logits_j[:, -1:], axis=-1).astype(jnp.int32)
        tok_t = torch.argmax(logits_t[:, -1:], dim=-1).to(torch.int32)
    assert np.array_equal(np.asarray(tok_j), tok_t.numpy())
    for a, t in zip(jax.tree.leaves(caches_j), tree.leaves(caches_t)):
        _close(t, a)


@pytest.mark.parametrize("ring", [False, True])
def test_zamba2_groups_keep_their_own_caches(ring):
    """Zamba2's smoke config has one group; at 9 layers (3 groups) each
    group's shared-attention K/V and Mamba2 states are its own slices:
    prefill's caches and 8 decode steps agree with the JAX package's."""
    over = dict(num_layers=9, decode_window_slicing=ring, attn_window_override=8 if ring else 0)
    cfg_j, cfg_t, params_j, params_t, tokens = _setup("zamba2-7b", **over)
    assert cfg_t.num_groups == 3
    mj, mt = build_jax(cfg_j), build(cfg_t)
    logits_j, caches_j = mj.prefill(params_j, jnp.asarray(tokens), S + N_DECODE_RECURRENT)
    logits_t, caches_t = mt.prefill(params_t, torch.from_numpy(tokens), S + N_DECODE_RECURRENT)
    _close(logits_t, logits_j)
    for a, t in zip(jax.tree.leaves(caches_j), tree.leaves(caches_t)):
        _close(t, a)
    tok_j = jnp.argmax(logits_j[:, -1:], axis=-1).astype(jnp.int32)
    tok_t = torch.argmax(logits_t[:, -1:], dim=-1).to(torch.int32)
    decode_j = jax.jit(mj.decode_step)
    for i in range(N_DECODE_RECURRENT):
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
    got, _ = build(cfg_t).forward(params_t, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    got, want = _np(got), _np(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel


@pytest.mark.parametrize("field,value", [("pos", "learned"), ("pos", "sinusoidal"),
                                         ("mlp_act", "gelu")])
def test_unported_layer_options_raise(field, value):
    """The layer options that only the cross-attention configs use, now
    ported: learned positions (a table of ``max_position`` = 64 rows:
    the default 2^20 would draw 0.5 GB), sinusoidal positions and the
    plain tanh-GELU MLP, each on the Gemma 2B smoke config, build the JAX
    package's parameter tree and match its `forward`."""
    over = {field: value, "max_position": 64}
    cfg_j, cfg_t, params_j, params_t, tokens = _setup("gemma-2b", **over)
    leaves_j = jax.tree_util.tree_flatten_with_path(params_j)[0]
    assert _paths(build(cfg_t).metas()) == [tuple(p.key for p in path) for path, _ in leaves_j]
    assert ("pos" in params_t["embed"]) == (value == "learned")
    assert ("wg" in params_t["groups"]["b0"]["mlp"]) == (value != "gelu")
    want, _ = build_jax(cfg_j).forward(params_j, jnp.asarray(tokens))
    got, _ = build(cfg_t).forward(params_t, torch.from_numpy(tokens))
    _close(got, want)


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


def test_serve_cli_takes_the_moe_smoke_config(capsys):
    """``--arch moonshot-v1-16b-a3b --device cpu`` serves the MoE smoke
    config: finite logits, no kernel launches, ``--tokens`` tokens."""
    from repro_torch.launch import serve as serve_torch

    serve_torch.main(["--arch", "moonshot-v1-16b-a3b", "--batch", "2", "--prompt-len", "8",
                      "--tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=moonshot-v1-16b-a3b device=cpu" in out and "finite=True" in out
    sample = [l for l in out.splitlines() if l.startswith("sample:")]
    assert len(eval(sample[0].split(":", 1)[1])) == 3


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_serve_cli_takes_the_recurrent_smoke_configs(arch, capsys):
    """``--arch zamba2-7b`` and ``--arch rwkv6-3b`` with ``--device cpu``
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_cpu(arch):
    """The serving entry point on the CPU: greedy tokens equal a decode
    loop driven through the JAX package on the same weights."""
    cfg_j, cfg_t, params_j, params_t, tokens = _setup(arch)
    mem = memory_for(cfg_t)
    n = 3
    r = serve(cfg_t, params_t, torch.from_numpy(tokens), n, device="cpu",
              memory=None if mem is None else torch.from_numpy(mem))
    assert r["tokens"].shape == (B, n + 1) and r["finite"]
    assert r["launches"] == {"prefill": {"rms_norm": 0, "flash_attention": 0},
                             "decode": {"rms_norm": 0, "flash_attention": 0}}
    mj = build_jax(cfg_j)
    logits, caches = mj.prefill(params_j, jnp.asarray(tokens), S + n,
                                None if mem is None else jnp.asarray(mem))
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


@pytest.mark.parametrize("arch,ring", [("zamba2-7b", False), ("zamba2-7b", True),
                                       ("rwkv6-3b", False)])
def test_recurrent_init_cache_matches_jax(arch, ring):
    """The recurrent caches in a bfloat16 model: the SSM and wkv states in
    float32, the conv inputs, K/V and token-shift carries in bfloat16
    (`cache_dtype`), shapes and leaf names as in the JAX package (the
    shared block's K/V under ``shared``, ring-sized under the override)."""
    over = dict(compute_dtype="bfloat16", decode_window_slicing=ring,
                attn_window_override=8 if ring else 0)
    want = build_jax(get_smoke_jax(arch, **over)).init_cache(B, S)
    got = build(get_smoke(arch, **over)).init_cache(B, S, device="cpu")
    paths_j = [tuple(p.key for p in path)
               for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert _paths(got) == paths_j
    leaves_j, leaves_t = jax.tree.leaves(want), tree.leaves(got)
    assert [(a.shape, a.dtype.name) for a in leaves_j] == [
        (tuple(t.shape), str(t.dtype)[6:]) for t in leaves_t]
    assert all(not t.any() for t in leaves_t)
    dtypes = {p[-1]: str(t.dtype)[6:] for p, t in zip(paths_j, leaves_t)}
    assert all(dt == ("float32" if k in ("ssm", "wkv") else "bfloat16")
               for k, dt in dtypes.items())
    if ring:
        assert got["shared"]["k"].shape[2] == 8


def test_large_leaves_draw_slice_by_slice(monkeypatch):
    """A leaf whose float32 draw exceeds `WHOLE_DRAW_BYTES` is drawn one
    stacked slice at a time into its final tensor: the right shape, dtype
    and scale, the same weights from the same seed, and each slice the
    next draw of the generator (what drawing the slices in turn gives)."""
    from repro_torch.models import common

    meta = common.ParamMeta((6, 64, 96), ("layers", "embed", "ff"))  # fan-in 64
    monkeypatch.setattr(common, "WHOLE_DRAW_BYTES", 4 * 64 * 96)  # one slice
    draw = lambda: common._leaf_init(meta, torch.Generator().manual_seed(7),
                                     torch.bfloat16, torch.device("cpu"))
    a, b = draw(), draw()
    assert a.shape == meta.shape and a.dtype == torch.bfloat16
    assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(7)
    want = torch.stack([torch.randn((64, 96), generator=gen) / 8.0 for _ in range(6)])
    assert torch.equal(a, want.to(torch.bfloat16))
    assert abs(float(a.float().std()) - 1 / 8) < 0.01
    monkeypatch.undo()
    whole = draw()  # under the default size: one draw of the whole leaf
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(whole, (torch.randn(meta.shape, generator=gen) / 8.0).to(torch.bfloat16))


@pytest.mark.parametrize("get", [get_smoke, get_config])
def test_gemma2_leaves_draw_whole(get):
    """Every leaf of Gemma-2 9B stays under `WHOLE_DRAW_BYTES` in float32,
    so its weights from a seed are what they were before sliced draws;
    Moonlight's stacked expert leaves are above it."""
    from repro_torch.models.common import WHOLE_DRAW_BYTES

    sizes = [4 * int(np.prod(m.shape)) for m in tree.leaves(build(get("gemma2-9b")).metas())]
    assert max(sizes) <= WHOLE_DRAW_BYTES
    moe = build(get_config("moonshot-v1-16b-a3b")).metas()["groups"]["b0"]["moe"]
    assert all(4 * int(np.prod(moe[k].shape)) > WHOLE_DRAW_BYTES for k in ("wg", "wu", "wd"))


def test_group_params_free_the_weights_without_the_cycle_collector():
    """Views taken by `group_params` (a `tree_map`) hold no reference once
    dropped: with the cyclic collector off, deleting the params frees the
    stacked leaves at once (a recursive closure in `tree.flatten` kept them
    alive until a collection, 16.7 GB of Gemma-2 9B's on the card)."""
    import gc
    import weakref

    from repro_torch.models import transformer as tfm

    cfg = get_smoke("gemma2-9b")
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    leaf = weakref.ref(params["groups"]["b0"]["mlp"]["wg"])
    gc.collect()
    gc.disable()
    try:
        gp = tfm.group_params(params, 0)
        w = tree.tree_map(lambda a: a + 0, gp)  # unflatten too
        assert tree.unflatten(tree.flatten(w)[1], tree.leaves(w)).keys() == w.keys()
        del gp, w, params
        assert leaf() is None
    finally:
        gc.enable()
