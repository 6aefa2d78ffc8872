"""Port parity for gradient-guided selection and the top-k kernel's plain
version (`repro_torch.kernels.topk_mask`), against the JAX package's
Pallas `stacked_topk_masks` and `topk_threshold_bits_3d` (interpret
mode), its XLA counting search `_bitwise_topk_body`, and its solo sort
path. Threshold bits and masks must be identical, byte for byte, on the
JAX package's own edge cases (mixed signs, all negative, ties, subnormals,
all zeros) plus NaN and infinities.

Subnormals: XLA:CPU flushes subnormal floats to zero in a float compare,
so the JAX package's ``|u| >= thr`` masks are all True there (its bit
search, an integer search, still finds the exact threshold). The port's
masks are compared under the same float mode, `torch.set_flush_denormal`;
the threshold bits are compared without it."""
import contextlib
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro.kernels import stacking as jstacking
from repro.kernels.topk_mask import stacked_topk_masks as j_stacked_topk
from repro.kernels.topk_mask.topk_mask import topk_threshold_bits_3d
from repro_torch import tree
from repro_torch.core import batched
from repro_torch.core import selection as tsel
from repro_torch.kernels.topk_mask import ops as kops
from repro_torch.kernels.topk_mask.ref import (topk_threshold_bits_ref,
                                               topk_threshold_sort_ref)

CASES = ["mixed", "negatives", "ties", "denormals", "zeros", "nan", "inf"]
FRAC = 0.07


def _u_case(case: str, rng, b=3):
    shapes = ((57, 7), (301,))

    def leaf(shape):
        n = int(np.prod(shape))
        if case == "mixed":
            x = rng.normal(size=n)
        elif case == "negatives":
            x = -np.abs(rng.normal(size=n)) - 0.1
        elif case == "ties":
            x = rng.choice([0.5, -0.5, 2.0, -2.0, 0.0], size=n)
        elif case == "denormals":
            x = rng.normal(size=n) * 1e-41  # subnormal f32 magnitudes
        elif case == "zeros":
            x = np.zeros(n)
        elif case == "nan":
            x = rng.normal(size=n)
            x[rng.integers(0, n, size=5)] = np.nan
        elif case == "inf":
            x = rng.normal(size=n)
            x[rng.integers(0, n, size=3)] = np.inf
            x[rng.integers(0, n, size=3)] = -np.inf
        else:
            raise ValueError(case)
        return x.reshape(shape).astype(np.float32)

    return [{"a": leaf(shapes[0]), "b": leaf(shapes[1])} for _ in range(b)]


@contextlib.contextmanager
def _float_mode_of_xla_cpu(case):
    flush = case == "denormals"
    if flush:
        assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        if flush:
            torch.set_flush_denormal(False)


def _equal(jax_tree, torch_tree):
    return all(np.array_equal(np.asarray(x), y.numpy())
               for x, y in zip(jax.tree.leaves(jax_tree), tree.leaves(torch_tree)))


@pytest.mark.parametrize("case", CASES)
def test_stacked_masks_byte_identical(case):
    trees = _u_case(case, np.random.default_rng(5))
    jstack = jax.tree.map(lambda *ls: jnp.stack(ls),
                          *[jax.tree.map(jnp.asarray, t) for t in trees])
    tstack = tree.tree_map(lambda *ls: torch.from_numpy(np.stack(ls)), *trees)
    m_pallas = j_stacked_topk(jstack, frac=FRAC)
    m_xla = jax.jit(jax.vmap(functools.partial(
        jsel._bitwise_topk_body, frac=FRAC)))(jstack)
    n0 = kops.launches
    with _float_mode_of_xla_cpu(case):
        m_port = tsel.stacked_gradient_guided_masks(tstack, FRAC)
    assert kops.launches == n0  # CPU tensors take the plain version
    assert _equal(m_pallas, m_port), case
    assert _equal(m_xla, m_port), case
    for i, t in enumerate(trees):
        solo_j = jsel.gradient_guided_mask(jax.tree.map(jnp.asarray, t), FRAC)
        with _float_mode_of_xla_cpu(case):
            solo_t = tsel.gradient_guided_mask(
                tree.tree_map(torch.from_numpy, t), FRAC)
        assert _equal(solo_j, solo_t), (case, i)
        assert all(torch.equal(a, b[i]) for a, b in
                   zip(tree.leaves(solo_t), tree.leaves(m_port)))


@pytest.mark.parametrize("case", CASES)
def test_threshold_bits_exact(case):
    """The plain counting search against the Pallas kernel on the same
    zero-padded (B, rows, 128) bit buffer."""
    trees = _u_case(case, np.random.default_rng(6))
    tstack = tree.tree_map(lambda *ls: torch.from_numpy(np.stack(ls)), *trees)
    bits, n = kops.abs_bits_buffer(tstack)
    k = kops.selection_count(n, FRAC)
    thr_t = topk_threshold_bits_ref(bits, k)
    jbits = jnp.asarray(bits.numpy().view(np.uint32))
    thr_j = np.asarray(topk_threshold_bits_3d(jbits, k, interpret=True))
    assert thr_t.dtype == torch.int32 and thr_t.shape == (3,)
    assert np.array_equal(thr_j.reshape(-1), thr_t.numpy().view(np.uint32))
    # and the layout is the JAX package's: same bits, same padding
    jplan = jstacking.stack_plan(jax.tree.map(
        lambda *ls: jnp.stack(ls), *[jax.tree.map(jnp.asarray, t) for t in trees]))
    assert bits.shape == (3, jplan.groups[0].rows, 128)
    if case not in ("nan",):
        for i, t in enumerate(trees):
            thr = float(thr_t[i:i + 1].view(torch.float32))
            leaves = [torch.from_numpy(t[key]) for key in sorted(t)]
            assert thr == topk_threshold_sort_ref(leaves, k)


def test_bisection_threshold_matches_jax():
    """The large-tree path (above 20M coordinates) as a function: the same
    bisection gives the same threshold bits."""
    rng = np.random.default_rng(7)
    t = {"w": rng.normal(size=(40, 50)).astype(np.float32),
         "b": (rng.normal(size=(77,)) * 3).astype(np.float32)}
    for frac in (0.05, 0.3):
        thr_j = np.asarray(jsel.global_threshold(jax.tree.map(jnp.asarray, t), frac))
        thr_t = tsel.global_threshold(tree.tree_map(torch.from_numpy, t), frac)
        assert thr_j.tobytes() == thr_t.numpy().tobytes()


def test_wrapper_rules():
    bits = torch.zeros(2, 3, 128, dtype=torch.int32)
    with pytest.raises(ValueError):
        kops.topk_threshold_bits(bits, 0)
    with pytest.raises(ValueError):
        kops.topk_threshold_bits(bits.to("meta"), 1)
    n0 = kops.launches
    bits[1, 0, :7] = torch.arange(1, 8, dtype=torch.int32)
    assert kops.topk_threshold_bits(bits, 2).tolist() == [0, 6]
    assert kops.launches == n0  # a CPU buffer takes the plain version
    assert kops.selection_count(10, 0.05) == 1
    assert kops.selection_count(334_405, 0.05) == 16_720


def test_random_mask_seeded_fraction():
    params = {"w": torch.zeros(200, 50), "b": torch.zeros(1000)}
    a = tsel.random_mask(torch.Generator().manual_seed(3), params, 0.05)
    b = tsel.random_mask(torch.Generator().manual_seed(3), params, 0.05)
    assert all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))
    assert all(x.dtype == torch.bool for x in tree.leaves(a))
    assert 0.04 < tsel.mask_fraction(a) < 0.06


def test_group_masks_mix_deferred_and_given():
    """A fused group whose sessions are at different phases: a session
    with a given mask (its first phase) keeps it, and the deferred
    gradient-guided ones get their own selection, from one stacked call."""
    rng = np.random.default_rng(8)
    cfg = SimpleNamespace(gamma=FRAC)
    trees = [{k: torch.from_numpy(v[i]) for k, v in
              {"a": rng.normal(size=(3, 57, 7)), "b": rng.normal(size=(3, 301))}.items()}
             for i in range(3)]
    given = tree.tree_map(lambda l: l > 1.0, trees[1])
    members = [(0, SimpleNamespace(cfg=cfg, u_prev=trees[0]), None, None, None),
               (1, SimpleNamespace(cfg=cfg, u_prev=None), given, None, None),
               (2, SimpleNamespace(cfg=cfg, u_prev=trees[2]), None, None, None)]
    out = batched._stacked_masks(members)
    want = [tsel.gradient_guided_mask(trees[0], FRAC), given,
            tsel.gradient_guided_mask(trees[2], FRAC)]
    for i, w in enumerate(want):
        assert all(torch.equal(o[i], x) for o, x in zip(tree.leaves(out), tree.leaves(w)))
