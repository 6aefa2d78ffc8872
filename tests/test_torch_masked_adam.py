"""Port parity for masked Adam: the kernel's plain version
(`repro_torch.kernels.masked_adam`), the per-session update and the
stacked update against the JAX package's `masked_adam_update` and its
Pallas `masked_adam_stacked` (interpret mode), plus the stacking layout.

Tolerance 2e-6 for float32 results, as the JAX package's own kernel test
holds its Pallas kernel against XLA (XLA:CPU may contract a multiply and
an add into one rounding; the port never does); 1e-2 for bfloat16
parameters, one bfloat16 step either way of that wobble. Coordinates
outside the mask must not move, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masked_adam as jma
from repro.kernels.masked_adam.ops import masked_adam_stacked as j_stacked
from repro_torch import tree
from repro_torch.core import masked_adam as tma
from repro_torch.core.batched import stack_trees
from repro_torch.kernels import stacking
from repro_torch.kernels.masked_adam import ops as kops

# nothing a multiple of the 128-lane row; one leaf smaller than a row
_SHAPES = ((37, 5), (130,), (511,), (3,))
HP = dict(lr=2e-3, b1=0.9, b2=0.999, eps=1e-8)


def _np_sessions(b, dtypes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        p, g, m = {}, {}, {}
        for j, (shape, dt) in enumerate(zip(_SHAPES, dtypes)):
            p[f"l{j}"] = (rng.normal(size=shape), dt)
            g[f"l{j}"] = rng.normal(size=shape).astype(np.float32)
            m[f"l{j}"] = rng.integers(0, 2, shape).astype(bool)
        out.append((p, g, m))
    return out


def _jax_tree(t):
    return {k: jnp.asarray(v[0], v[1]) if isinstance(v, tuple)
            else jnp.asarray(v) for k, v in t.items()}


def _torch_tree(t):
    return {k: torch.from_numpy(np.array(jnp.asarray(v[0], v[1]).astype(jnp.float32)))
            .to(getattr(torch, v[1])) if isinstance(v, tuple)
            else torch.from_numpy(np.asarray(v)) for k, v in t.items()}


def _state_from_jax(st):
    conv = lambda t: {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(  # noqa: E731
        getattr(torch, str(v.dtype))) for k, v in t.items()}
    return tma.MaskedAdamState(conv(st.m), conv(st.v),
                               torch.from_numpy(np.array(st.count)))


def _close(a, b, tol=2e-6):
    for x, y in zip(jax.tree.leaves(a), tree.leaves(b)):
        tol_x = 1e-2 if str(x.dtype) == "bfloat16" else tol
        np.testing.assert_allclose(np.asarray(x, np.float64),
                                   y.to(torch.float64).numpy(),
                                   rtol=tol_x, atol=tol_x)


def _warm_jax_state(p, g, st, m, steps):
    for _ in range(steps):
        p, st, _ = jma.masked_adam_update(p, g, st, m, **HP)
    return p, st


@pytest.mark.parametrize("steps", [0, 3])
@pytest.mark.parametrize("dtypes", [["float32"] * 4,
                                    ["bfloat16", "float32", "bfloat16", "float32"]])
def test_update_matches_jax(dtypes, steps):
    """The per-session update (the kernel's plain math on the CPU) from a
    JAX state ``steps`` iterations in."""
    (p, g, m), = _np_sessions(1, dtypes, seed=0)
    jp, jg, jm = _jax_tree(p), _jax_tree(g), _jax_tree(m)
    jp, jst = _warm_jax_state(jp, jg, jma.init_state(jp), jm, steps)
    px, sx, ux = jma.masked_adam_update(jp, jg, jst, jm, **HP)
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        getattr(torch, str(v.dtype))) for k, v in jp.items()}
    pt, st, ut = tma.masked_adam_update(tp, _torch_tree(g), _state_from_jax(jst),
                                        _torch_tree(m), **HP)
    _close(px, pt)
    _close(ux, ut)
    _close(sx.m, st.m)
    _close(sx.v, st.v)
    assert int(st.count) == int(sx.count) == steps + 1
    assert all(l.dtype == torch.float32 for l in tree.leaves(ut))
    for k, mk in _torch_tree(m).items():
        assert torch.equal(pt[k][~mk], tp[k][~mk])


def test_adam_update_is_the_all_ones_mask():
    (p, g, _), = _np_sessions(1, ["float32"] * 4, seed=6)
    jp, jg = _jax_tree(p), _jax_tree(g)
    px, sx, ux = jma.adam_update(jp, jg, jma.init_state(jp), **HP)
    tp = _torch_tree(p)
    pt, st, ut = tma.adam_update(tp, _torch_tree(g), tma.init_state(tp), **HP)
    _close(px, pt)
    _close(ux, ut)
    _close(sx.v, st.v)
    assert not any(torch.equal(a, b) for a, b in zip(tree.leaves(pt), tree.leaves(tp)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtypes", [["float32"] * 4,
                                    ["bfloat16", "float32", "bfloat16", "float32"]])
def test_stacked_matches_jax_pallas(dtypes, seed):
    """The stacked update against the Pallas kernel (interpret mode), with
    sessions at different Adam step counts."""
    sessions = _np_sessions(3, dtypes, seed)
    jstack = lambda i: jax.tree.map(lambda *ls: jnp.stack(ls),  # noqa: E731
                                    *[_jax_tree(s[i]) for s in sessions])
    jp, jg, jm = jstack(0), jstack(1), jstack(2)
    jst0 = jax.tree.map(lambda *ls: jnp.stack(ls),
                        *[jma.init_state(_jax_tree(s[0])) for s in sessions])
    counts = np.asarray([0, 5, 40], np.int32)
    jst = jst0._replace(count=jnp.asarray(counts))
    px, sx, ux = j_stacked(jp, jg, jst, jm, **HP)
    tp = stack_trees([_torch_tree(s[0]) for s in sessions])
    tg = stack_trees([_torch_tree(s[1]) for s in sessions])
    tm = stack_trees([_torch_tree(s[2]) for s in sessions])
    tst = tma.MaskedAdamState(
        tree.tree_map(torch.zeros_like, tp),
        tree.tree_map(lambda l: torch.zeros_like(l, dtype=torch.float32), tp),
        torch.from_numpy(counts))
    n0 = kops.launches
    pt, st, ut = kops.masked_adam_stacked(tp, tg, tst, tm, **HP)
    assert kops.launches == n0  # CPU tensors take the plain version
    _close(px, pt)
    _close(ux, ut)
    _close(sx.m, st.m)
    _close(sx.v, st.v)
    assert st.count.tolist() == [1, 6, 41]
    for k in tp:
        frozen = ~tm[k]
        assert torch.equal(pt[k][frozen], tp[k][frozen])


def test_stacked_equals_per_session_bitwise():
    """On one device the stacked layout changes no bit of the result."""
    sessions = _np_sessions(3, ["float32"] * 4, seed=4)
    trees = [[_torch_tree(s[i]) for s in sessions] for i in range(3)]
    states = [tma.init_state(t) for t in trees[0]]
    states = [st._replace(count=torch.tensor(c, dtype=torch.int32))
              for st, c in zip(states, (0, 2, 9))]
    pt, st, ut = kops.masked_adam_stacked(
        stack_trees(trees[0]), stack_trees(trees[1]), stack_trees(states),
        stack_trees(trees[2]), **HP)
    for i in range(3):
        p1, s1, u1 = tma.masked_adam_update(trees[0][i], trees[1][i], states[i],
                                            trees[2][i], **HP)
        for a, b in zip(tree.leaves((p1, s1, u1)),
                        tree.leaves(tree.tree_map(lambda l: l[i], (pt, st, ut)))):
            assert torch.equal(a, b)


def test_stacking_round_trip_and_layout():
    rng = np.random.default_rng(5)
    t = {"b": torch.from_numpy(rng.normal(size=(2, 37, 5)).astype(np.float32)),
         "a": torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32)).to(torch.bfloat16),
         "c": torch.from_numpy(rng.normal(size=(2, 300)).astype(np.float32))}
    plan = stacking.stack_plan(t)
    assert [g.dtype for g in plan.groups] == ["bfloat16", "float32"]
    f32 = plan.groups[1]
    assert f32.indices == (1, 2) and f32.offsets == (0, 185)
    assert f32.n == 485 and f32.rows == 4
    leaves = tree.leaves(t)
    out = [None] * len(leaves)
    for g in plan.groups:
        buf = stacking.flatten_group(leaves, g, plan.b)
        assert buf.shape == (2, g.rows, stacking.LANES)
        assert torch.count_nonzero(buf.reshape(2, -1)[:, g.n:]) == 0
        stacking.unflatten_group(buf, g, plan.b, plan.shapes, out=out)
    for a, b in zip(leaves, out):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert stacking.stack_plan(t) is plan  # cached per struct


def test_kernel_wrapper_checks_arguments():
    """What the CUDA kernel would refuse, the wrapper refuses first."""
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt)  # noqa: E731
    good = [z(2, 3, 128), z(2, 3, 128), z(2, 3, 128), z(2, 3, 128),
            z(2, 3, 128, dt=torch.bool), z(2)]
    kops._check_kernel_args(*good)
    bad_shape = list(good)
    bad_shape[1] = z(2, 3, 64)
    bad_dtype = list(good)
    bad_dtype[2] = z(2, 3, 128, dt=torch.float64)
    bad_bc = list(good)
    bad_bc[5] = z(3)
    strided = list(good)
    strided[0] = z(2, 3, 256)[:, :, ::2]
    for args, exc in ((bad_shape, ValueError), (bad_dtype, TypeError),
                      (bad_bc, ValueError), (strided, ValueError)):
        with pytest.raises(exc):
            kops._check_kernel_args(*args)
