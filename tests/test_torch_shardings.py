"""The port's sharding rules, partition specs and abstract trees
(`launch/shardings.py`, `launch/mesh.py`, `models/common.py`,
`Model.abstract`, `pspecs`, `abstract_cache`, `cache_pspecs`) against the
JAX package's, at every architecture's full published config.

The JAX package's `rules_for` reads only ``mesh.axis_names`` and
``mesh.devices.shape``, so a stand-in object drives it on the CPU, for
both production meshes, without forcing 512 host devices. The port's
partition specs are tuples; the JAX package's ``PartitionSpec``s are
compared as ``tuple(spec)``. Everything must be equal exactly.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as get_config_jax
from repro.launch.shardings import rules_for as rules_for_jax
from repro.models import common as common_jax
from repro.models.registry import build as build_jax
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import stacking
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.shardings import rules_for
from repro_torch.models import common
from repro_torch.models.registry import build

KINDS = ("train", "prefill", "decode", "decode_long")
LEVERS = ({}, {"attn_dp": True}, {"moe_shard": True}, {"decode_ep": True})


class _JaxMesh:
    """What the JAX package's `rules_for` reads of a mesh."""

    def __init__(self, m: mesh_mod.MeshShape):
        self.axis_names = m.axis_names
        self.devices = type("devices", (), {"shape": m.shape})


MESHES = (mesh_mod.make_production_mesh(), mesh_mod.make_production_mesh(multi_pod=True))


def _spec_tree(specs):
    """A tree of JAX ``PartitionSpec``s as nested dicts of tuples."""
    return jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(x, P))


def test_meshes_are_the_production_ones():
    assert MESHES[0] == (("data", "model"), (16, 16)) and MESHES[0].size == 256
    assert MESHES[1] == (("pod", "data", "model"), (2, 16, 16)) and MESHES[1].size == 512
    assert mesh_mod.make_local_mesh().size == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_equal_jax(arch):
    for mesh in MESHES:
        for kind in KINDS:
            for lever in LEVERS:
                for ring in (False, True):
                    cfg = get_config(arch, decode_window_slicing=ring,
                                     attn_window_override=8192 * ring)
                    cfg_jax = get_config_jax(arch, decode_window_slicing=ring,
                                             attn_window_override=8192 * ring)
                    want = rules_for_jax(cfg_jax, _JaxMesh(mesh), shape_kind=kind, **lever)
                    got = rules_for(cfg, mesh, shape_kind=kind, **lever)
                    assert got == want, (mesh, kind, lever, ring)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pspecs_equal_jax(arch):
    """Every leaf of `Model.pspecs` under every rule set, and of
    `cache_pspecs` at decode_32k and long_500k (with and without the ring
    cache)."""
    for mesh in MESHES:
        for kind in KINDS:
            for lever in LEVERS:
                cfg, cfg_jax = get_config(arch), get_config_jax(arch)
                rules = rules_for(cfg, mesh, shape_kind=kind, **lever)
                assert build(cfg).pspecs(rules) == _spec_tree(build_jax(cfg_jax).pspecs(rules))
    for kind, seq, batch in (("decode", 32768, 128), ("decode_long", 524288, 1)):
        for ring in (False, True):
            over = dict(decode_window_slicing=ring)
            if kind == "decode_long":
                over["attn_window_override"] = 8192
            cfg, cfg_jax = get_config(arch, **over), get_config_jax(arch, **over)
            for mesh in MESHES:
                rules = rules_for(cfg, mesh, shape_kind=kind)
                mem = cfg.num_xattn_tokens
                got = build(cfg).cache_pspecs(batch, seq, rules, mem_len=mem)
                want = build_jax(cfg_jax).cache_pspecs(batch, seq, rules, mem_len=mem)
                assert got == _spec_tree(want), (kind, ring, mesh)


def _shapes(t) -> dict:
    """(shape, dtype name) of every leaf, by path, of a nest of dicts."""
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    dtype = stacking.dtype_name(t.dtype) if isinstance(t, torch.Tensor) else str(t.dtype)
    return (tuple(t.shape), dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_equal_jax(arch):
    """`Model.abstract` and `abstract_cache` (decode_32k and long_500k,
    ring or not) leaf for leaf in shape and dtype, on the meta device;
    `param_bytes` and the logical axes of every leaf equal."""
    cfg, cfg_jax = get_config(arch), get_config_jax(arch)
    model, model_jax = build(cfg), build_jax(cfg_jax)
    got = model.abstract()
    assert all(l.device.type == "meta" for l in tree.leaves(got))
    assert _shapes(got) == _shapes(model_jax.abstract())
    assert (common.param_bytes(model.metas(), cfg.pdtype)
            == common_jax.param_bytes(model_jax.metas(), cfg_jax.pdtype))
    axes = jax.tree.map(lambda m: m.axes, model_jax.metas(), is_leaf=common_jax.is_meta)
    assert common.tree_map_meta(lambda m: m.axes, model.metas()) == axes
    for seq, batch, ring in ((32768, 128, False), (524288, 1, False), (524288, 1, True)):
        over = dict(decode_window_slicing=ring, attn_window_override=8192 * ring)
        m, mj = build(get_config(arch, **over)), build_jax(get_config_jax(arch, **over))
        mem = cfg.num_xattn_tokens
        got = m.abstract_cache(batch, seq, mem_len=mem)
        assert all(l.device.type == "meta" for l in tree.leaves(got))
        assert _shapes(got) == _shapes(mj.abstract_cache(batch, seq, mem_len=mem))
        for dtype in (None, jnp.float32):
            want = mj.abstract_cache(2, 64, mem_len=mem, dtype=dtype)
            tdt = None if dtype is None else torch.float32
            assert _shapes(m.abstract_cache(2, 64, mem_len=mem, dtype=tdt)) == _shapes(want)


def test_param_meta_checks_its_axes():
    with pytest.raises(ValueError):
        common.ParamMeta((2, 3), ("embed",))
    m = common.ParamMeta((4, 6), ("embed", "ff"))
    assert common.meta_pspec(m, {"embed": ("data", "model"), "ff": "model"}) == (
        ("data", "model"), None)
    assert common.meta_pspec(m, common.sharding_rules(fsdp=True)) == ("data", "model")
    assert common.meta_pspec(m, common.sharding_rules(fsdp=False)) == (None, "model")
