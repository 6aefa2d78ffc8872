"""The port's LLM distillation trainer against the JAX package's, on the
CPU: the plain backward versions of the two kernels with a backward
(`flash_attention_bwd_ref`, `rms_norm_bwd_ref`), `Model.loss` and its
gradients, and the training loop (`launch/train.train` and its CLI).

Precision. Both packages compute attention scores and softmax, RMSNorm
and the cross-entropy in float32 even when the model runs in float64
(the JAX package casts with ``astype(jnp.float32)`` and
``preferred_element_type=jnp.float32``, and the JAX trainer's clip casts
the gradients to float32), so "float64" here means float64 weights and
matmuls around float32 cores, and two correct implementations agree only
as closely as float32 sums taken in other orders allow:

* the plain backward versions against autograd through the plain forward
  and against ``jax.vjp`` of the JAX package's references
  (`kernels/flash_attention/ref.py`, `kernels/rmsnorm/ref.py`), on
  float64 inputs: within 1e-5 relative plus 2e-6 of the largest |value|
  (measured: up to 3e-7 of it);
* `Model.loss` and every leaf's gradient, float64 weights in both
  packages: within 1e-4 relative plus 1e-5 of the leaf's largest |value|,
  elementwise (measured: up to 1.2e-6); in float32, within 1e-5 in
  relative L2 norm (F5; measured up to 1e-6). The attention projections
  are drawn at fan-in d_model (`test_torch_llm.conditioned`): at the JAX
  init (fan-in G and KV) the smoke models' softmax is nearly a hard max
  and float32 roundoff in either package moves Gemma 2B's gradients by
  1.2e-4 of their largest value (MoE: 3e-4), where no tolerance tells a
  wrong gradient from roundoff;
* the trainer, 2 phases of K = 3 on Gemma 2B's smoke config, batch 2,
  seq 16, the JAX init, the token stream and the first mask injected from
  the JAX side: in float64 the phase-2 masks are identical and the
  deltas' bytes are identical, the losses within 1e-6 relative; in
  float32 the losses within 1e-5 relative.

The JAX reference loop is the JAX CLI's own step (`src/repro/launch/
train.py`: ``value_and_grad`` of ``model.loss``, the global-norm clip
and the non-finite guard, ``masked_adam_update``), its
``gradient_guided_mask`` and ``encode_delta``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as get_smoke_jax
from repro.core import selection as selection_jax
from repro.core.delta import encode_delta as encode_delta_jax
from repro.core.masked_adam import init_state as init_state_jax
from repro.core.masked_adam import masked_adam_update as masked_adam_update_jax
from repro.data.tokens import StreamConfig as StreamConfigJax
from repro.data.tokens import TokenStream as TokenStreamJax
from repro.kernels.flash_attention.ref import flash_attention_ref as attention_ref_jax
from repro.models.layers import rms_norm as rms_norm_jax
from repro.models.registry import build as build_jax
from repro_torch import tree
from repro_torch.configs import get_smoke
from repro_torch.data.tokens import StreamConfig, TokenStream
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.rmsnorm.ref import rms_norm_bwd_ref, rms_norm_ref
from repro_torch.launch import train as train_mod
from repro_torch.models.registry import Model, build, params_from_numpy
from test_torch_llm import ARCHS, conditioned, memory_for

LR, GAMMA, CLIP = 1e-3, 0.05, 1.0


def _close(got, want, rtol, scale_atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale_atol * float(np.abs(want).max()) + 1e-30)


# ---------------------------------------------------------------------------
# The plain backward versions
# ---------------------------------------------------------------------------

ATT_CASES = [  # B, Sq, Skv, KV, G, hd, causal, window, softcap
    (2, 12, 12, 1, 4, 16, True, 0, 0.0),     # MQA, causal
    (1, 12, 12, 2, 2, 16, True, 0, 50.0),    # softcap (F14)
    (1, 12, 12, 2, 2, 16, True, 4, 50.0),    # softcap and window (F14)
    (2, 7, 11, 2, 1, 8, False, 0, 0.0),      # non-causal, Sq != Skv, G = 1
    (1, 11, 7, 1, 8, 8, True, 0, 30.0),      # causal Sq > Skv, G = 8
    (1, 10, 10, 2, 2, 8, False, 3, 20.0),    # window without causal
]


def _jax_layout(q, k, v):
    b, sq, kv, g, hd = q.shape
    return (q.transpose(0, 2, 3, 1, 4).reshape(b, kv * g, sq, hd),
            k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("B,Sq,Skv,KV,G,hd,causal,window,softcap", ATT_CASES)
def test_attention_bwd_ref_matches_autograd_and_jax(B, Sq, Skv, KV, G, hd, causal, window,
                                                    softcap):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, Sq, KV, G, hd)) * 2
    k = rng.normal(size=(B, Skv, KV, hd)) * 2
    v = rng.normal(size=(B, Skv, KV, hd))
    do = rng.normal(size=(B, Sq, KV, G, hd))
    kw = dict(causal=causal, window=window, softcap=softcap)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_ref(qt, kt, vt, **kw)  # records: softcap out of place
    auto = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    with torch.no_grad():
        o, lse = flash_attention_ref(qt, kt, vt, return_lse=True, **kw)
    assert torch.equal(o, out)
    got = flash_attention_bwd_ref(qt.detach(), kt.detach(), vt.detach(), o, lse,
                                  torch.from_numpy(do), **kw)
    with jax.enable_x64(True):
        qj, kj, vj = _jax_layout(q, k, v)
        doj = do.transpose(0, 2, 3, 1, 4).reshape(B, KV * G, Sq, hd)
        vjp = jax.jit(lambda a, b, c, d: jax.vjp(
            lambda x, y, z: attention_ref_jax(x, y, z, **kw), a, b, c)[1](d))
        dqj, dkj, dvj = (np.asarray(x) for x in vjp(qj, kj, vj, jnp.asarray(doj)))
    jax_grads = (dqj.reshape(B, KV, G, Sq, hd).transpose(0, 3, 1, 2, 4),
                 dkj.transpose(0, 2, 1, 3), dvj.transpose(0, 2, 1, 3))
    for mine, a, j in zip(got, auto, jax_grads):
        assert mine.dtype == torch.float64 and bool(torch.isfinite(mine).all())
        _close(mine.numpy(), a.numpy(), 1e-5, 2e-6)
        _close(mine.numpy(), j, 1e-5, 2e-6)


def _attention_before_f14(q, k, v, *, causal, window, softcap):
    """The plain attention as it was before F14's repair (softcap and mask
    in place), kept here to hold the repaired one to it bit for bit."""
    Sq, hd, Skv = q.shape[1], q.shape[-1], k.shape[1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32), k.to(torch.float32))
    s.mul_(hd**-0.5)
    if softcap:
        s.div_(softcap).tanh_().mul_(softcap)
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    s.masked_fill_(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32)).to(q.dtype)


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softcapped_attention_backpropagates_with_its_output_unchanged(window, dtype):
    """F14: with a softcap, autograd through the plain attention runs (it
    raised on an in-place tanh), and its output, with grad recording or
    without, is the pre-repair output bit for bit."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 12, 2, 2, 16, generator=g).to(dtype)
    k = torch.randn(2, 12, 2, 16, generator=g).to(dtype)
    v = torch.randn(2, 12, 2, 16, generator=g).to(dtype)
    kw = dict(causal=True, window=window, softcap=50.0)
    before = _attention_before_f14(q, k, v, **kw)
    assert torch.equal(flash_attention_ref(q, k, v, **kw), before)
    qg = q.clone().requires_grad_()
    out = flash_attention_ref(qg, k, v, **kw)
    assert torch.equal(out.detach(), before)
    out.float().sum().backward()
    assert bool(torch.isfinite(qg.grad.float()).all()) and bool((qg.grad != 0).any())


@pytest.mark.parametrize("shape", [(3, 5, 64), (4, 33), (2, 128)])
@pytest.mark.parametrize("w_dtype", ["float64", "float32"])
def test_rms_norm_bwd_ref_matches_autograd_and_jax(shape, w_dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape) * 3
    w = (rng.normal(size=shape[-1]) * 0.1).astype(w_dtype)
    dy = rng.normal(size=shape)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    auto = torch.autograd.grad(rms_norm_ref(xt, wt), (xt, wt), torch.from_numpy(dy))
    got = rms_norm_bwd_ref(xt.detach(), wt.detach(), torch.from_numpy(dy))
    with jax.enable_x64(True):
        vjp = jax.jit(lambda a, b, d: jax.vjp(rms_norm_jax, a, b)[1](d))
        jax_grads = [np.asarray(a) for a in vjp(jnp.asarray(x), jnp.asarray(w),
                                                jnp.asarray(dy))]
    for mine, a, j, ref in zip(got, auto, jax_grads, (xt, wt)):
        assert mine.dtype == ref.dtype and mine.shape == ref.shape
        _close(mine.numpy(), a.numpy(), 1e-5, 2e-6)
        _close(mine.numpy(), j, 1e-5, 2e-6)


# ---------------------------------------------------------------------------
# Model.loss and its gradients
# ---------------------------------------------------------------------------

B, S = 2, 16


def _setup(arch, dtype):
    """The JAX init (attention projections conditioned), as numpy in
    ``dtype``, and a batch of tokens and labels."""
    cfg_j = get_smoke_jax(arch)
    p = conditioned(cfg_j, build_jax(cfg_j).init(jax.random.PRNGKey(0)))
    pn = jax.tree.map(lambda a: np.asarray(a).astype(dtype), p)
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (B, S + 1)).astype(np.int32)
    return pn, toks


def _jax_loss_and_grads(arch, dtype, pn, toks):
    cfg = get_smoke_jax(arch, param_dtype=dtype, compute_dtype=dtype)
    batch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    f = jax.jit(jax.value_and_grad(build_jax(cfg).loss, has_aux=True))
    (loss, _), grads = f(jax.tree.map(jnp.asarray, pn), batch)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _port_loss_and_grads(arch, dtype, pn, toks):
    cfg = get_smoke(arch, param_dtype=dtype, compute_dtype=dtype)
    params = tree.tree_map(lambda l: l.requires_grad_(), params_from_numpy(pn, device="cpu"))
    loss, _ = build(cfg).loss(params, {"tokens": torch.from_numpy(toks[:, :-1]),
                                       "labels": torch.from_numpy(toks[:, 1:])})
    loss.backward()
    return float(loss.detach()), [l.grad.numpy() for l in tree.leaves(params)]


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma2-9b", "moonshot-v1-16b-a3b"])
def test_loss_and_gradients_match_jax_in_float64(arch):
    """Gemma 2B (MQA), Gemma-2 9B (softcaps, window, post-norms) and
    Moonlight (the router aux in the loss): loss and every gradient leaf
    elementwise."""
    pn, toks = _setup(arch, "float64")
    with jax.enable_x64(True):
        want_loss, want = _jax_loss_and_grads(arch, "float64", pn, toks)
    got_loss, got = _port_loss_and_grads(arch, "float64", pn, toks)
    assert abs(got_loss - want_loss) <= 1e-6 * abs(want_loss)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == np.float64
        _close(a, b, 1e-4, 1e-5)


def test_loss_and_gradients_match_jax_in_float32_in_norm():
    pn, toks = _setup("gemma-2b", "float32")
    want_loss, want = _jax_loss_and_grads("gemma-2b", "float32", pn, toks)
    got_loss, got = _port_loss_and_grads("gemma-2b", "float32", pn, toks)
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    for a, b in zip(got, want):
        assert float(np.linalg.norm(a - b)) <= 1e-5 * float(np.linalg.norm(b)) + 1e-12


@pytest.mark.parametrize("arch", ARCHS)
def test_every_smoke_config_backpropagates_to_every_leaf(arch):
    """The port's loss backward on the CPU for all ten smoke configs, with
    ``remat`` on: a finite gradient on every leaf, not zero on most (a
    gated cross-attention block's attention starts with zero gradient:
    its gate is 0 at init)."""
    cfg = get_smoke(arch, remat=True)
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    for leaf in tree.leaves(params):
        leaf.requires_grad_()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    mem = memory_for(cfg)
    if mem is not None:
        batch["memory"] = torch.from_numpy(mem)
    loss, _ = build(cfg).loss(params, batch)
    loss.backward()
    leaves = tree.leaves(params)
    assert all(l.grad is not None and bool(torch.isfinite(l.grad).all()) for l in leaves)
    assert sum(bool((l.grad != 0).any()) for l in leaves) >= 0.75 * len(leaves)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

K, PHASES, T_SEQ = 3, 2, 16


def _jax_train(dtype, pn, first_mask):
    """The JAX CLI's loop (src/repro/launch/train.py) with its step."""
    cfg = get_smoke_jax("gemma-2b", param_dtype=dtype, compute_dtype=dtype)
    model = build_jax(cfg)
    params = jax.tree.map(jnp.asarray, pn)
    opt = init_state_jax(params)
    stream = TokenStreamJax(StreamConfigJax(vocab_size=cfg.vocab_size, seed=1))
    nprng = np.random.default_rng(0)

    @jax.jit
    def step(params, opt, mask, tokens, labels):
        (loss, _), grads = jax.value_and_grad(model.loss, has_aux=True)(
            params, {"tokens": tokens, "labels": labels})
        gn = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                          for g in jax.tree.leaves(grads)))
        scale = jnp.minimum(1.0, CLIP / jnp.maximum(gn, 1e-9))
        ok = jnp.isfinite(gn)
        grads = jax.tree.map(lambda g: jnp.where(ok & jnp.isfinite(g),
                                                 g.astype(jnp.float32) * scale,
                                                 0.0).astype(g.dtype), grads)
        params, opt, u = masked_adam_update_jax(params, grads, opt, mask, lr=LR)
        return params, opt, u, loss

    losses, masks, deltas, u_prev = [], [], [], None
    for it in range(K * PHASES):
        if it % K == 0:
            mask = first_mask if u_prev is None else selection_jax.gradient_guided_mask(
                u_prev, GAMMA)
            masks.append(mask)
        data = stream.sample(nprng, B, T_SEQ, it * 2.0)
        params, opt, u_prev, loss = step(params, opt, mask, jnp.asarray(data[:, :-1]),
                                         jnp.asarray(data[:, 1:]))
        losses.append(float(loss))
        if (it + 1) % K == 0:
            deltas.append(encode_delta_jax(params, mask))
    return losses, masks, deltas


def _trainer_runs(dtype):
    pn, _ = _setup("gemma-2b", dtype)
    mask_j = selection_jax.random_mask(jax.random.PRNGKey(3),
                                       jax.tree.map(jnp.asarray, pn), GAMMA)
    with jax.enable_x64(dtype == "float64"):
        want = _jax_train(dtype, pn, mask_j)
    cfg = get_smoke("gemma-2b", param_dtype=dtype, compute_dtype=dtype)
    first = params_from_numpy(jax.tree.map(np.asarray, mask_j), device="cpu")
    got = train_mod.train(cfg, params_from_numpy(pn, device="cpu"),
                          TokenStream(StreamConfig(vocab_size=cfg.vocab_size, seed=1)),
                          steps=K * PHASES, phase_len=K, batch=B, seq=T_SEQ, gamma=GAMMA,
                          lr=LR, clip=CLIP, nprng=np.random.default_rng(0), first_mask=first)
    return got, want


def test_trainer_matches_jax_in_float64():
    got, (losses, masks, deltas) = _trainer_runs("float64")
    np.testing.assert_allclose(got.losses, losses, rtol=1e-6)
    for m_t, m_j in zip(tree.leaves(got.masks[1]), jax.tree.leaves(masks[1])):
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert 0 < sum(int(m.sum()) for m in tree.leaves(got.masks[1]))
    for d_t, d_j in zip(got.deltas, deltas):
        assert d_t.packed_mask == d_j.packed_mask
        assert d_t.values.dtype == d_j.values.dtype
        assert d_t.values.tobytes() == d_j.values.tobytes()
        assert d_t.n_total == d_j.n_total


def test_trainer_matches_jax_in_float32():
    got, (losses, _, deltas) = _trainer_runs("float32")
    np.testing.assert_allclose(got.losses, losses, rtol=1e-5)
    assert all(np.isfinite(got.losses))
    assert [d.n_total for d in got.deltas] == [d.n_total for d in deltas]


def test_trainer_cli_prints_the_jax_lines(monkeypatch, capsys):
    """``--device cpu``: the JAX CLI's lines, step for step; with the JAX
    init injected, the step-0 loss equal at its printed precision (the
    first masks differ: the packages draw them from different
    generators)."""
    from repro.launch import train as train_jax

    argv = ["--arch", "gemma-2b", "--steps", "4", "--phase-len", "2", "--batch", "2",
            "--seq", "8", "--log-every", "1"]
    cfg_j = get_smoke_jax("gemma-2b")
    pn = jax.tree.map(np.asarray, build_jax(cfg_j).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(Model, "init",
                        lambda self, gen, device="cuda": params_from_numpy(pn, device))
    outs = []
    for run in (lambda: train_jax.main(argv),
                lambda: train_mod.main(argv + ["--device", "cpu"])):
        run()
        outs.append(capsys.readouterr().out.strip().splitlines())
    step = re.compile(r"step +(\d+) loss (\S+) downlink (\S+) KB  \(\S+s\)$")
    done = re.compile(r"done: final loss \S+, total downlink \S+ KB, 4 steps in \S+s$")
    for lines in outs:
        assert len(lines) == 5 and done.match(lines[-1])
        assert [int(step.match(l).group(1)) for l in lines[:-1]] == [0, 1, 2, 3]
    assert step.match(outs[0][0]).group(2) == step.match(outs[1][0]).group(2)
    assert step.match(outs[1][0]).group(3) == "0.0"
