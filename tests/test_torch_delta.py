"""Port parity for the wire delta (`core/delta.py`): for the same params
and mask, the port's `values` and `packed_mask` bytes are identical to the
JAX package's, solo and stacked; `apply_delta` round-trips; the leaf order
on the wire is jax.tree's (sorted keys), whatever the dict's insertion
order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta as jdelta
from repro_torch import tree
from repro_torch.core import delta as tdelta
from repro_torch.core.batched import stack_trees


def _np_tree(rng, b=None):
    lead = () if b is None else (b,)
    # insertion order deliberately not sorted
    return {"z": rng.normal(size=lead + (3, 4)).astype(np.float32),
            "a": {"w": rng.normal(size=lead + (130,)).astype(np.float32),
                  "b": (rng.normal(size=lead + (5,)) * 1e3).astype(np.float32)},
            "m": rng.normal(size=lead + (2, 2, 3)).astype(np.float32)}


def _mask_like(rng, t, frac):
    return {k: _mask_like(rng, v, frac) if isinstance(v, dict)
            else rng.uniform(size=v.shape) < frac for k, v in t.items()}


def _jax(t):
    return jax.tree.map(jnp.asarray, t)


def _torch(t):
    return tree.tree_map(torch.from_numpy, t)


def _same(dj, dt):
    assert dt.n_total == dj.n_total
    assert dt.value_dtype == dj.value_dtype
    assert dt.values.dtype == dj.values.dtype
    assert dt.values.tobytes() == dj.values.tobytes()
    assert dt.packed_mask == dj.packed_mask
    assert dt.total_bytes == dj.total_bytes


@pytest.mark.parametrize("frac", [0.0, 0.05, 0.5, 1.0])
def test_encode_delta_bytes_identical(frac):
    rng = np.random.default_rng(1)
    p = _np_tree(rng)
    m = _mask_like(rng, p, frac)
    _same(jdelta.encode_delta(_jax(p), _jax(m)), tdelta.encode_delta(_torch(p), _torch(m)))


def test_encode_delta_stack_bytes_identical():
    rng = np.random.default_rng(2)
    b = 3
    p = _np_tree(rng, b)
    m = _mask_like(rng, p, 0.1)
    dj = jdelta.encode_delta_stack(_jax(p), _jax(m), b)
    dt = tdelta.encode_delta_stack(_torch(p), _torch(m), b)
    for i in range(b):
        _same(dj[i], dt[i])
        solo = tdelta.encode_delta(tree.tree_map(lambda l: l[i], _torch(p)),
                                   tree.tree_map(lambda l: l[i], _torch(m)))
        _same(solo, dt[i])


def test_apply_delta_round_trip():
    rng = np.random.default_rng(3)
    old, new = _np_tree(rng), _np_tree(rng)
    m = _mask_like(rng, new, 0.2)
    d = tdelta.encode_delta(_torch(new), _torch(m))
    before = _torch(old)
    got = tdelta.apply_delta(before, d)
    ref = jdelta.apply_delta(_jax(old), jdelta.encode_delta(_jax(new), _jax(m)))
    for g, r, o, n_, mk, b in zip(tree.leaves(got), jax.tree.leaves(ref),
                                  tree.leaves(old), tree.leaves(new),
                                  tree.leaves(m), tree.leaves(before)):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(r))
        want = np.where(mk, n_.astype(np.float16).astype(np.float32), o)
        assert np.array_equal(g.numpy(), want)
        assert np.array_equal(b.numpy(), o)  # the input tree is untouched


def test_wire_order_is_sorted_keys():
    rng = np.random.default_rng(4)
    p = _np_tree(rng)
    ones = _mask_like(rng, p, 2.0)  # every coordinate
    d = tdelta.encode_delta(_torch(p), _torch(ones))
    flat = np.concatenate([p["a"]["b"], p["a"]["w"], p["m"].ravel(),
                           p["z"].ravel()]).astype(np.float16)
    assert d.values.tobytes() == flat.tobytes()


def test_full_model_bytes():
    rng = np.random.default_rng(5)
    p = _np_tree(rng)
    assert tdelta.full_model_bytes(_torch(p)) == jdelta.full_model_bytes(_jax(p))
    assert tdelta.full_model_bytes(_torch(p), "float32") == \
        jdelta.full_model_bytes(_jax(p), "float32")


def test_stacked_encode_matches_on_stack_trees_input():
    """`encode_delta_stack` over `stack_trees` output of per-session trees."""
    rng = np.random.default_rng(6)
    ps = [_torch(_np_tree(rng)) for _ in range(2)]
    ms = [_torch(_mask_like(rng, _np_tree(rng), 0.3)) for _ in range(2)]
    ds = tdelta.encode_delta_stack(stack_trees(ps), stack_trees(ms), 2)
    for p, m, d in zip(ps, ms, ds):
        _same(tdelta.encode_delta(p, m), d)
