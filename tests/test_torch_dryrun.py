"""The port's dry run on the meta device (`launch/dryrun.py`,
`roofline/analysis.trace_facts`, the kernel wrappers' meta branches)
against the JAX package's step functions and against counts made by hand.

* Step shapes: for every architecture's smoke config (head dim 64, one
  the flash-attention kernel takes; remat on, as the full configs have
  it), the meta-traced train, prefill and decode steps' outputs have the
  shapes and dtypes of ``jax.eval_shape`` of the JAX package's steps.
* `trace_facts` on hand-counted functions: a chain of products with known
  lifetimes, views sharing their storage, logsumexp's hidden buffer, a
  flash-attention call whose FLOPs equal the live-pair count, and the
  per-signature cache changing nothing.
* The wrappers' meta branches give the CUDA route's output shapes and
  dtypes; a device other than cpu, cuda or meta still raises.
* The CLI: one pair by name, and Llama 3 405B's train_4k on 16 x 16,
  whose per-device argument bytes equal the JAX partition specs' shard
  bytes computed here; on one card they are the params, the flat
  optimizer's state, the mask and the batch. The collective term: zero on
  one card, a positive count priced into the roofline on 256 (Gemma 2B),
  absent (not 0) under ``--proof-only``; the fake process group the
  sharded trace opens refuses a live group and leaves none behind.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.configs import get_smoke as get_smoke_jax
from repro.core.masked_adam import MaskedAdamState
from repro.launch import steps as steps_jax
from repro.launch.shardings import rules_for as rules_for_jax
from repro.models.registry import build as build_jax
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.masked_adam import FlatMaskedAdam
from repro_torch.kernels import stacking
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.masked_adam import ops as adam_ops
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.launch import dryrun
from repro_torch.launch import input_specs as ispec
from repro_torch.launch.mesh import (NVLINK_BW, MeshShape, fake_mesh, make_local_mesh,
                                     make_production_mesh)
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import moe
from repro_torch.models.registry import build
from repro_torch.roofline import analysis

META = torch.device("meta")
B, S = 2, 32


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _sds(t) -> tuple:
    """(shape, dtype name) of a tensor or a ShapeDtypeStruct."""
    if isinstance(t, torch.Tensor):
        return tuple(t.shape), stacking.dtype_name(t.dtype)
    return tuple(t.shape), str(t.dtype)


def _tree_sds(t):
    if isinstance(t, dict):
        return {k: _tree_sds(v) for k, v in t.items()}
    return _sds(t)


def _smoke(arch):
    over = dict(head_dim=64, remat=True)
    return get_smoke(arch, **over), get_smoke_jax(arch, **over)


# ---------------------------------------------------------------------------
# Step shapes against jax.eval_shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_traced_steps_match_jax_eval_shape(arch):
    cfg, cfg_jax = _smoke(arch)
    model, model_jax = build(cfg), build_jax(cfg_jax)
    pj = model_jax.abstract()
    mem = cfg.num_xattn_tokens
    bj = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
          "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if mem:
        bj["memory"] = jax.ShapeDtypeStruct((B, mem, cfg.d_model), cfg_jax.cdtype)

    # train: the updates u and the loss (and the params the step leaves)
    opt = MaskedAdamState(m=pj, v=jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), pj),
        count=jax.ShapeDtypeStruct((), jnp.int32))
    mask = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bool_), pj)
    p_new, _, u_j, loss_j = jax.eval_shape(steps_jax.make_train_step(model_jax), pj, opt,
                                           mask, bj)
    state = FlatMaskedAdam(model.abstract())
    f = analysis.trace_facts(make_train_step(model), state, ispec.train_inputs(cfg, B, S))
    u, loss = f["out"]
    assert _tree_sds(u) == _tree_sds(u_j)
    assert _sds(loss) == _sds(loss_j)
    assert _tree_sds(state.params) == _tree_sds(p_new)
    assert f["peak_bytes"] > f["arg_bytes"] > 0 and f["traced_flops"] > 0

    # prefill: last-position logits and the caches
    batch = ispec.train_inputs(cfg, B, S)
    batch.pop("labels")
    bj.pop("labels")
    logits_j, caches_j = jax.eval_shape(steps_jax.make_prefill_step(model_jax, S + 8), pj, bj)
    f = analysis.trace_facts(make_prefill_step(model, S + 8), model.abstract(), batch)
    logits, caches = f["out"]
    assert _sds(logits) == _sds(logits_j)
    assert _tree_sds(caches) == _tree_sds(caches_j)

    # decode: the next token and the caches it writes
    cj = model_jax.abstract_cache(B, S + 8, mem_len=mem)
    tok_j, caches_j = jax.eval_shape(
        steps_jax.make_serve_step(model_jax), pj, cj,
        {"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32),
         "pos": jax.ShapeDtypeStruct((), jnp.int32)})
    f = analysis.trace_facts(make_serve_step(model), model.abstract(),
                             model.abstract_cache(B, S + 8, mem_len=mem),
                             ispec.decode_inputs(cfg, B, S))
    tok, caches, _ = f["out"]
    assert _sds(tok) == _sds(tok_j)
    assert _tree_sds(caches) == _tree_sds(caches_j)


# ---------------------------------------------------------------------------
# trace_facts on hand-counted functions
# ---------------------------------------------------------------------------


def test_trace_facts_counts_a_chain_of_products():
    """x (64, 128) @ w (128, 128) three times, each product 32 KiB of
    float32: a is dropped before c is made, so at most two products (b and
    c) are live beside the arguments, and the sum's scalar adds one
    512-byte block."""
    x, w = _meta(64, 128), _meta(128, 128)

    def f(x, w):
        a = x @ w
        b = a @ w
        del a
        c = b @ w
        return c.sum()

    got = analysis.trace_facts(f, x, w)
    n = 64 * 128 * 4
    assert got["arg_bytes"] == n + 2 * n
    assert got["peak_bytes"] == 3 * n + 2 * n + 512
    assert got["traced_flops"] == 3 * 2 * 64 * 128 * 128
    assert got["out"].shape == () and got["out"].device.type == "meta"


def test_trace_facts_counts_a_shared_storage_once():
    """Views (a slice, a reshape, a transpose) add nothing; a contiguous
    copy of the transpose adds its bytes; an argument's views count
    once."""
    x = _meta(128, 32)

    def f(x, y):
        v = x[:, :10]
        r = x.view(32, 128)
        t = x.t()
        c = t.contiguous()
        return v, r, t, c

    got = analysis.trace_facts(f, x, x[2:])
    assert got["arg_bytes"] == 128 * 32 * 4
    assert got["peak_bytes"] == 2 * 128 * 32 * 4
    assert got["traced_flops"] == 0


def test_trace_facts_rounds_to_the_allocator_block_and_frees():
    x = _meta(3)  # 12 bytes: one 512-byte block

    def f(x):
        for _ in range(5):
            y = x * 2  # each product replaces the last
        return y

    got = analysis.trace_facts(f, x)
    assert got["arg_bytes"] == 512
    assert got["peak_bytes"] == 3 * 512


def test_trace_facts_counts_logsumexp_buffer():
    """ATen's logsumexp holds the max and an x-sized exp(x - max) buffer
    beside its output for the call's span."""
    x = _meta(64, 1000)
    got = analysis.trace_facts(lambda x: torch.logsumexp(x, dim=-1), x)
    n = 64 * 1000 * 4
    # x, the buffer, and the max and the output (64 floats each: a block)
    assert got["peak_bytes"] == n + n + 512 + 512


@pytest.mark.parametrize("causal,window,sq,skv", [
    (True, 0, 200, 200), (True, 37, 200, 200), (False, 0, 100, 333), (True, 0, 64, 100)])
def test_flash_attention_flops_are_the_live_pairs(causal, window, sq, skv):
    qp, kp = np.arange(sq)[:, None], np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    assert attn_ops.live_pairs(sq, skv, causal, window) == int(mask.sum())
    b, kv, g, hd = 2, 2, 3, 64
    q = _meta(b, sq, kv, g, hd, dtype=torch.bfloat16)
    k = _meta(b, skv, kv, hd, dtype=torch.bfloat16)
    got = analysis.trace_facts(
        lambda q, k, v: attn_ops.flash_attention(q, k, v, causal=causal, window=window), q, k, k)
    assert got["traced_flops"] == 4 * hd * b * kv * g * int(mask.sum())
    assert got["peak_bytes"] == got["arg_bytes"] + math.ceil(q.nbytes / 512) * 512


def test_the_signature_cache_changes_nothing(monkeypatch):
    """A smoke model's train and prefill traces with every operation run
    (the cache off) and through the cache: the same facts."""
    cfg, _ = _smoke("zamba2_7b")
    model = build(cfg)

    def facts():
        tr = analysis.trace_facts(make_train_step(model), FlatMaskedAdam(model.abstract()),
                                  ispec.train_inputs(cfg, B, S))
        pf = analysis.trace_facts(make_prefill_step(model, S), model.abstract(),
                                  {"tokens": ispec.train_inputs(cfg, B, S)["tokens"]})
        return [{k: v for k, v in f.items() if k != "out"} for f in (tr, pf)]

    cached = facts()
    monkeypatch.setattr(analysis, "_functional", lambda func: False)
    assert facts() == cached


def test_trace_facts_refuses_tensors_off_the_meta_device():
    with pytest.raises(ValueError, match="meta"):
        analysis.trace_facts(lambda x: x * 2, torch.zeros(3))


# ---------------------------------------------------------------------------
# The wrappers' meta branches
# ---------------------------------------------------------------------------


class _OtherDevice(torch.Tensor):
    """A tensor that claims a device the wrappers do not run on."""

    @staticmethod
    def __new__(cls, shape, dtype=torch.bfloat16):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype, device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError("no data on this device")


def test_meta_branches_give_the_cuda_routes_outputs():
    x, w = _meta(2, 7, 256, dtype=torch.bfloat16), _meta(256, dtype=torch.bfloat16)
    n0 = norm_ops.launches, norm_ops.bwd_launches
    out = norm_ops.rms_norm(x, w)
    assert _sds(out) == _sds(x) and out.device.type == "meta"
    dx, dw = norm_ops.rms_norm_bwd(x, w, _meta(2, 7, 256, dtype=torch.bfloat16))
    assert _sds(dx) == _sds(x) and _sds(dw) == _sds(w)
    assert (norm_ops.launches, norm_ops.bwd_launches) == n0

    q = _meta(2, 50, 2, 4, 128, dtype=torch.bfloat16)
    k = _meta(2, 70, 2, 128, dtype=torch.bfloat16)
    n0 = attn_ops.launches, attn_ops.bwd_launches
    o, lse = attn_ops._forward(q, k, k, False, 0, 0.0, want_lse=True)
    assert _sds(o) == _sds(q) and _sds(lse) == ((2, 2, 4, 50), "float32")
    dq, dk, dv = attn_ops.flash_attention_bwd(q, k, k, o, lse, o, causal=False)
    assert _sds(dq) == _sds(q) and _sds(dk) == _sds(k) and _sds(dv) == _sds(k)
    assert (attn_ops.launches, attn_ops.bwd_launches) == n0

    p = _meta(1, 10, 128, dtype=torch.bfloat16)
    m, v = _meta(1, 10, 128), _meta(1, 10, 128)
    mask, bc = _meta(1, 10, 128, dtype=torch.bool), _meta(1)
    n0 = adam_ops.launches
    outs = adam_ops.masked_adam_3d(p, p, m, v, mask, bc, b1=0.9, b2=0.999, eps=1e-8)
    assert [_sds(t) for t in outs] == [_sds(p), _sds(m), _sds(v), _sds(m)]
    u = _meta(1, 10, 128)
    assert adam_ops.masked_adam_3d(p, p, m, v, mask, bc, b1=0.9, b2=0.999, eps=1e-8,
                                   out=(p, m, v, u))[3] is u
    assert adam_ops.launches == n0


def test_meta_branches_keep_the_cuda_routes_checks():
    with pytest.raises(ValueError, match="head_dim"):
        attn_ops.flash_attention(_meta(1, 8, 1, 1, 32), _meta(1, 8, 1, 32), _meta(1, 8, 1, 32))
    with pytest.raises(ValueError, match="contiguous"):
        norm_ops.rms_norm(_meta(8, 64).t(), _meta(8))
    with pytest.raises(ValueError):
        adam_ops.masked_adam_3d(_meta(1, 10, 64), _meta(1, 10, 64), _meta(1, 10, 64),
                                _meta(1, 10, 64), _meta(1, 10, 64, dtype=torch.bool),
                                _meta(1), b1=0.9, b2=0.999, eps=1e-8)


def test_other_devices_still_raise():
    x = _OtherDevice((4, 64))
    with pytest.raises(ValueError, match="not xpu"):
        norm_ops.rms_norm(x, _OtherDevice((64,)))
    with pytest.raises(ValueError, match="not xpu"):
        norm_ops.rms_norm_bwd(x, _OtherDevice((64,)), x)
    q, k = _OtherDevice((1, 8, 1, 1, 64)), _OtherDevice((1, 8, 1, 64))
    with pytest.raises(ValueError, match="not xpu"):
        attn_ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="not xpu"):
        attn_ops.flash_attention_bwd(q, k, k, q, _OtherDevice((1, 1, 1, 8)), q)
    p = _OtherDevice((1, 2, 128))
    with pytest.raises(ValueError, match="not xpu"):
        adam_ops.masked_adam_3d(p, p, p, p, p, _OtherDevice((1,)), b1=0.9, b2=0.999, eps=1e-8)


def test_moe_dispatch_on_meta_keeps_every_slot():
    """On meta the dispatch takes the bound (all T*k slots kept): the
    output and aux shapes are those of the CPU run."""
    cfg = get_smoke("moonshot_v1_16b_a3b")
    params = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    p = params["groups"]["b0"]["moe"]
    p = tree.tree_map(lambda l: l[0], p)
    x = torch.randn(2, 16, cfg.d_model)
    out, aux = moe.moe_apply(cfg, p, x)
    pm = tree.tree_map(lambda l: torch.empty_like(l, device=META), p)
    got = analysis.trace_facts(lambda p, x: moe.moe_apply(cfg, p, x), pm, x.to(META))
    out_m, aux_m = got["out"]
    assert _sds(out_m) == _sds(out) and _sds(aux_m) == _sds(aux)


# ---------------------------------------------------------------------------
# The dry run: config resolution and the CLI
# ---------------------------------------------------------------------------


def test_resolve_cfg_windows_dense_archs_at_long_500k():
    mesh = make_production_mesh()
    for arch in ARCH_IDS:
        cfg, variant = dryrun.resolve_cfg(arch, "long_500k", mesh)
        dense = get_config(arch).window_size == 0 and not any(
            k in ("mamba", "rwkv") for k in get_config(arch).pattern)
        assert (variant == "swa_500k") == dense
        assert cfg.attn_window_override == (8192 if dense else 0)
        cfg, variant = dryrun.resolve_cfg(arch, "train_4k", mesh)
        assert variant == "native" and cfg.act_sharding == ("data",)


def test_cli_runs_one_pair(capsys):
    assert dryrun.main(["--arch", "gemma_2b", "--shape", "decode_32k"]) == 0
    out = capsys.readouterr().out
    assert "dry-run: 1 ok, 0 failed" in out and "gemma_2b" in out


def _shard_bytes_jax(abstract, specs, sizes, itemsize=None) -> int:
    """Per-device bytes of a JAX abstract tree under its PartitionSpecs:
    each dimension over the product of its mesh axes, rounded up."""
    total = 0
    leaves = jax.tree.leaves(abstract)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    for a, spec in zip(leaves, spec_leaves):
        n = 1
        for i, dim in enumerate(a.shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            n *= -(-dim // math.prod(sizes[x] for x in axes))
        total += n * (itemsize or a.dtype.itemsize)
    return total


class _JaxMesh:
    def __init__(self, m):
        self.axis_names = m.axis_names
        self.devices = type("devices", (), {"shape": m.shape})


def _terms_hold(facts, mesh):
    """The roofline's three terms are `roofline_terms`' own for the pair's
    FLOPs, bytes and collective bytes, these priced by mesh axis at the
    links of rank 0's group on that axis (the mesh's ranks in row-major
    order), and the bottleneck is the largest."""
    link_s = 0.0
    for ax, nbytes in (facts["collective_axes"] or {}).items():
        i = mesh.axis_names.index(ax)
        stride = math.prod(mesh.shape[i + 1:])
        link_s += analysis.collective_seconds(nbytes, range(0, stride * mesh.shape[i], stride))
    assert sum((facts["collective_axes"] or {}).values()) == facts["collective_bytes"]
    want = analysis.roofline_terms(facts["flops"], facts["bytes"],
                                   facts["collective_bytes"], facts["chips"],
                                   collective_s=link_s)
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "step_time_lb_s"):
        assert facts[k] == want[k], k
    terms = {"compute": facts["t_compute_s"], "memory": facts["t_memory_s"],
             "collective": facts["t_collective_s"]}
    assert facts["bottleneck"] == max(terms, key=terms.get)


def test_full_size_pair_no_card_holds():
    """Llama 3 405B's train_4k on 16 x 16: the per-device argument bytes
    are the JAX partition specs' shard bytes of the params, the flat
    optimizer's g (bf16), m, v and u (float32) and mask (bool), the step
    count and the batch; on one card the same sum unsharded, and no
    collective. Its sharded trace takes a minute, so the 256-card pair is
    traced for memory only (``proof_only``): no collective term, never
    one priced at 0. Gemma 2B's train_4k on 16 x 16 is traced for its
    collectives: a positive count, priced into the roofline."""
    mesh = make_production_mesh()
    facts = dryrun.lower_pair("llama3_405b", "train_4k", mesh, verbose=False,
                              proof_only=True)
    cfg = get_config_jax("llama3_405b")
    model = build_jax(cfg)
    rules = rules_for_jax(cfg, _JaxMesh(mesh), shape_kind="train")
    specs, ab = model.pspecs(rules), model.abstract()
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    want = _shard_bytes_jax(ab, specs, sizes)
    want += sum(_shard_bytes_jax(ab, specs, sizes, n) for n in (2, 4, 4, 4, 1)) + 4
    want += 2 * (256 // 16) * 4096 * 4  # tokens and labels over "data"
    assert facts["device_arg_bytes"] == want
    assert facts["local_batch"] == 16 and facts["chips"] == 256
    assert not facts["fits_h100"] and facts["device_temp_bytes"] > 0
    assert facts["collective_bytes"] is None and facts["t_collective_s"] is None
    assert facts["collective_counts"] is None and facts["bottleneck"] == "compute"
    assert facts["step_time_lb_s"] == max(facts["t_compute_s"], facts["t_memory_s"])

    one = dryrun.lower_pair("llama3_405b", "train_4k", make_local_mesh(), verbose=False)
    n = 403_752_042_496
    assert one["device_arg_bytes"] == n * (2 + 2 + 4 + 4 + 4 + 1) + 4 + 2 * 256 * 4096 * 4
    assert one["device_arg_parts"]["params"] == n * 2 == model.num_params() * 2
    assert one["collective_bytes"] == 0 and set(one["collective_counts"].values()) == {0}
    assert one["t_collective_s"] == 0.0
    _terms_hold(one, make_local_mesh())

    small = dryrun.lower_pair("gemma_2b", "train_4k", mesh, verbose=False)
    assert small["collective_bytes"] > 0 and small["t_collective_s"] > 0
    assert small["collective_bytes"] == sum(small["collective_totals"].values())
    assert small["collective_counts"]["all-gather"] > 0
    assert small["collective_counts"]["reduce-scatter"] > 0
    assert set(small["collective_axes"]) <= {"data", "model"}
    # one device's bytes, never divided by the 256 cards
    assert small["t_collective_s"] >= small["collective_bytes"] / NVLINK_BW
    _terms_hold(small, mesh)


def test_proof_only_leaves_the_sharded_trace_out(monkeypatch, capsys):
    def refuse(*a, **k):
        raise AssertionError("the sharded trace ran")

    monkeypatch.setattr(dryrun, "_trace_collectives", refuse)
    assert dryrun.main(["--arch", "gemma_2b", "--shape", "decode_32k", "--proof-only"]) == 0
    out = capsys.readouterr().out
    assert "coll=not traced" in out and "dry-run: 1 ok, 0 failed" in out


def test_fake_mesh_refuses_a_live_group_and_leaves_none():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    mesh = MeshShape(("data", "model"), (2, 2))
    with fake_mesh(mesh) as dmesh:
        assert dist.is_initialized() and dist.get_world_size() == 4
        assert dmesh.mesh_dim_names == ("data", "model") and dmesh.device_type == "cuda"
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with fake_mesh(mesh):
            1 / 0
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            with fake_mesh(mesh):
                pass
        assert dist.get_world_size() == 2
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
