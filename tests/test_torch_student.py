"""Port parity for the segmentation student (`models/seg/student.py`).

The JAX package's weights are carried over with `params_from_numpy`, and
the same numpy frames go through both packages' forward pass, loss and
gradient, at the student's width 1.0 and at the teacher's config, on an
even (24) and an odd (25) frame size, which exercise the two TF ``SAME``
paddings of a stride-2 conv.

Tolerances:
* in float64 (the maths: padding, folded norm, resize, loss) elementwise,
  logits and loss rtol/atol 1e-5, gradients rtol 1e-4 atol 1e-6 — the
  packages differ only in summation order;
* in float32, the working type, the same elementwise bounds do not hold:
  at random init the folded norm over a 2-frame batch amplifies float32
  rounding ~1e4-fold, and the JAX package's own float32 gradients sit up
  to ~4e-4 of a leaf's largest entry from the float64 ones (measured on
  these inputs). So float32 is held leaf by leaf in norm: max |Δ| at most
  1e-4 (logits) and 2e-3 (gradients) of the leaf's largest float64 entry,
  plus 1e-5; the loss elementwise at rtol/atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.seg import student as js
from repro.models.seg.teacher import teacher_config
from repro_torch import tree
from repro_torch.models.seg import student as ts
from repro_torch.sim.seg_world import SegWorld

CONFIGS = {"student": js.SegConfig(n_classes=5), "teacher": teacher_config(5)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(hw, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(2, hw, hw, 3)).astype(dtype)
    y = rng.integers(0, 5, size=(2, hw, hw)).astype(np.int32)
    return x, y


def _port_cfg(jc):
    return ts.SegConfig(**dataclasses.asdict(jc))


def _port_loss_and_grad(jc):
    world = SegWorld(video=None, teacher=None, seg_cfg=_port_cfg(jc))
    return world.loss_and_grad


@pytest.mark.parametrize("hw", [24, 25])
@pytest.mark.parametrize("name", ["student", "teacher"])
def test_forward_loss_grad_match_float64(name, hw):
    jc = CONFIGS[name]
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          js.make_student(jc, jax.random.PRNGKey(0)))
    x, y = _inputs(hw, dtype=np.float64)
    with jax.enable_x64(True):
        jp = jax.tree.map(jnp.asarray, params)
        xj = jnp.asarray(x)
        lj = np.asarray(jax.jit(lambda p: js.seg_forward(jc, p, xj))(jp))
        vj, gj = jax.jit(jax.value_and_grad(
            lambda p: js.seg_loss(jc, p, xj, y)))(jp)
        vj, gj = float(vj), jax.tree.map(np.asarray, gj)
        pj = np.asarray(jax.jit(lambda p: js.seg_predict(jc, p, xj))(jp))
    tp = ts.params_from_numpy(params, "cpu")
    xt = torch.from_numpy(x)
    lt = ts.seg_forward(_port_cfg(jc), tp, xt)
    assert lt.dtype == torch.float64 and lt.shape == (2, hw, hw, 5)
    np.testing.assert_allclose(lt.detach().numpy(), lj, rtol=1e-5, atol=1e-5)
    vt, gt = _port_loss_and_grad(jc)(tp, xt, torch.from_numpy(y))
    np.testing.assert_allclose(float(vt), vj, rtol=1e-5, atol=1e-5)
    for a, b in zip(jax.tree.leaves(gj), tree.leaves(gt)):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-6)
    assert np.array_equal(ts.seg_predict(_port_cfg(jc), tp, xt).numpy(), pj)


@pytest.mark.parametrize("hw", [24, 25])
@pytest.mark.parametrize("name", ["student", "teacher"])
def test_forward_loss_grad_match_float32(name, hw):
    jc = CONFIGS[name]
    jp = js.make_student(jc, jax.random.PRNGKey(1))
    x, y = _inputs(hw, seed=1)
    lj = np.asarray(jax.jit(lambda p: js.seg_forward(jc, p, x))(jp))
    vj, gj = jax.jit(jax.value_and_grad(lambda p: js.seg_loss(jc, p, x, y)))(jp)
    tp = ts.params_from_numpy(jp, "cpu")
    assert all(l.dtype == torch.float32 for l in tree.leaves(tp))
    lg = _port_loss_and_grad(jc)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    lt = ts.seg_forward(_port_cfg(jc), tp, xt).detach().numpy()
    vt, gt = lg(tp, xt, yt)
    # float64 scale of each leaf, from the port run in float64
    tp64 = tree.tree_map(lambda t: t.double(), tp)
    l64 = ts.seg_forward(_port_cfg(jc), tp64, xt.double()).detach().numpy()
    _, g64 = lg(tp64, xt.double(), yt)
    assert np.abs(lt - lj).max() <= 1e-4 * np.abs(l64).max() + 1e-5
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5, atol=1e-5)
    for a, b, c in zip(jax.tree.leaves(gj), tree.leaves(gt), tree.leaves(g64)):
        bound = 2e-3 * float(c.abs().max()) + 1e-5
        assert float(np.abs(b.numpy() - np.asarray(a)).max()) <= bound


@pytest.mark.parametrize("sizes", [((3, 3), (24, 24)), ((4, 4), (25, 25)),
                                   ((32, 32), (256, 256)), ((4, 3), (25, 17))])
def test_linear_resize_matches_jax_in_float64(sizes):
    """The student's upsample (`linear_resize`: two products with fixed
    weight matrices) against ``jax.image.resize(method="linear")`` and its
    ``jax.vjp``, on the student's logit sizes at 24, 25 and 256 frames and
    an odd non-square one: forward and backward within 1e-12 (they differ
    in summation order only)."""
    (h, w), (H, W) = sizes
    rng = np.random.default_rng(h * W)
    x = rng.normal(size=(2, 5, h, w))
    g = rng.normal(size=(2, 5, H, W))
    with jax.enable_x64(True):
        yj, vjp = jax.vjp(lambda a: jax.image.resize(a, (2, 5, H, W), method="linear"),
                          jnp.asarray(x))
        (gj,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    yt = ts.linear_resize(xt, (H, W))
    yt.backward(torch.from_numpy(g))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["student", "teacher"])
def test_metas_shapes_and_flatten_order_match(name):
    """Same leaf shapes in the same flatten order: the wire order of a
    delta is identical in both packages."""
    jc = CONFIGS[name]
    jp = js.make_student(jc, jax.random.PRNGKey(0))
    tp = ts.make_student(_port_cfg(jc), seed=0, device="cpu")
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    leaves_t = tree.leaves(tp)
    assert len(paths) == len(leaves_t) == 47 + (9 if name == "teacher" else 0)
    for a, b in zip(jax.tree.leaves(jp), leaves_t):
        assert tuple(a.shape) == tuple(b.shape)
    # the port's flatten order, spelled as key paths, is jax.tree's
    flat, treedef = tree.flatten(tp)
    marked = tree.unflatten(treedef, list(range(len(flat))))
    order = []

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + f"['{k}']")
        else:
            order.append((node, prefix))

    walk(marked, "")
    assert [p for _, p in sorted(order)] == paths


def test_param_counts():
    """The student's docstring counts are off; these are the real ones."""
    assert ts.seg_param_count(ts.SegConfig(n_classes=5)) == 24_661
    assert ts.seg_param_count(ts.SegConfig(n_classes=5, width=4.0)) == 334_405
    for w in (1.0, 4.0):
        assert ts.seg_param_count(ts.SegConfig(n_classes=5, width=w)) == \
            js.seg_param_count(js.SegConfig(n_classes=5, width=w))


@pytest.mark.parametrize("size", [7, 8, 24, 25, 64])
@pytest.mark.parametrize("stride", [1, 2])
def test_same_padding_matches_lax(size, stride):
    """TF SAME: the conv of a one-hot probe lands where lax's does."""
    x = np.zeros((1, size, size, 1), np.float32)
    x[0, 0, 0, 0] = 1.0
    x[0, -1, -1, 0] = 2.0
    w = np.arange(9, dtype=np.float32).reshape(3, 3, 1, 1)
    yj = np.asarray(js._conv(jnp.asarray(x), jnp.asarray(w), stride=stride))
    yt = ts._conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w),
                  stride=stride).permute(0, 2, 3, 1).numpy()
    assert np.array_equal(yj, yt)


def test_make_student_is_seeded():
    cfg = ts.SegConfig(n_classes=5)
    a = ts.make_student(cfg, seed=3, device="cpu")
    b = ts.make_student(cfg, seed=3, device="cpu")
    c = ts.make_student(cfg, seed=4, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))
    assert not torch.equal(a["stem"]["w"], c["stem"]["w"])
    # fan-in normal: std of b0's expand conv ~ 1/sqrt(fan_in = 16)
    assert 0.4 < float(a["blocks"]["b0"]["expand"]["w"].std() * 4.0) < 1.6
