"""The fused phase's execution shape in the port (`core/batched.py`).

* The flat layout: K steps of `masked_adam_flat` over buffers flattened
  once are bit for bit K calls of the tree step `masked_adam_stacked` on
  the same gradients (float32, and a mixed bf16/float32 tree), and a whole
  fused phase in the flat layout is bit for bit the per-iteration tree
  loop it replaced.
* The exec mode: `set_exec_mode` takes auto|graph|loop only; ``graph``
  on a CPU group raises and runs nothing.
* The runner cache follows the JAX package's `cache_info()` sequence on
  the same calls (one miss for the first fleet, one hit for a second
  same-shaped fleet, `cache_clear` resets), pinned to ``loop`` (no auto
  decision) and under ``auto`` (one decision each: the port's is
  ``loop`` on the CPU, the JAX package's either shape).
* `debug_snapshot` holds the JAX package's keys minus the four with no
  counterpart in the port.
* One fused phase against the JAX package's (float64 gradients in both,
  ROADMAP F10): wire masks byte-identical, fp16 values within 1 ULP.

The CUDA-graph shape itself runs only on the card
(`tests/test_torch_kernels_cuda.py`).
"""
import dataclasses
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as jbatched
from repro.core.server import AMSConfig as JAMSConfig
from repro.core.server import AMSSession as JAMSSession
from repro.core.server import Task as JTask
from repro.data.video import VideoConfig as JVideoConfig
from repro.models.seg.student import SegConfig as JSegConfig
from repro.models.seg.student import make_student as j_make_student
from repro.models.seg.student import seg_loss as j_seg_loss
from repro.serving import obs as j_obs
from repro.sim.seg_world import SegWorld as JSegWorld
from repro.sim.seg_world import phi_pixel_loss as j_phi
from repro_torch import tree
from repro_torch.core import batched, masked_adam, timing
from repro_torch.core.server import AMSConfig, AMSSession, Task
from repro_torch.data.video import VideoConfig
from repro_torch.kernels import stacking
from repro_torch.kernels.masked_adam import ops as kops
from repro_torch.models.seg.student import SegConfig, params_from_numpy
from repro_torch.serving import obs
from repro_torch.sim.seg_world import SegWorld, phi_pixel_loss

HP = dict(lr=2e-3, b1=0.9, b2=0.999, eps=1e-8)
HW, B = 16, 2
J_SEG = JSegConfig(n_classes=5)
J_AMS = JAMSConfig(t_update=8.0, t_horizon=30.0, k_iters=2, batch_size=2,
                   gamma=0.05, lr=2e-3, phi_target=0.15)
T_SEG = SegConfig(**dataclasses.asdict(J_SEG))
T_AMS = AMSConfig(**{f.name: getattr(J_AMS, f.name)
                     for f in dataclasses.fields(AMSConfig)})
# the JAX package's debug_snapshot keys with no counterpart in the port (the
# fourth, "sharded", has one since sharded execution was ported)
NO_COUNTERPART = {"kernel_dispatch", "stacked_select_cache",
                  "stacked_encode_cache"}


@pytest.fixture(autouse=True)
def _clean():
    """Each test starts and ends with empty caches in both packages and
    both exec modes at their default."""
    batched.cache_clear()
    jbatched.cache_clear()
    yield
    batched.set_exec_mode("auto")
    jbatched.set_exec_mode("auto")
    batched.cache_clear()
    jbatched.cache_clear()


# ---------------------------------------------------------------------------
# the flat layout
# ---------------------------------------------------------------------------


def _stacked_case(rng, b, mixed):
    """A B-stacked param tree with ragged leaf sizes (bf16 leaves too when
    ``mixed``), its Adam state at per-session step counts, and a mask."""
    shapes = {"a": (7, 5), "b": (300,), "c": {"d": (3, 3, 2, 4), "e": (129,)}}
    dts = {"a": torch.bfloat16, "b": torch.float32,
           "c": {"d": torch.float32, "e": torch.bfloat16}} if mixed else None

    def leaf(path, shape, scale=1.0):
        dt = torch.float32
        if mixed:
            dt = dts[path[0]] if len(path) == 1 else dts[path[0]][path[1]]
        x = rng.normal(size=(b, *shape)).astype(np.float32) * scale
        return torch.from_numpy(x).to(dt)

    def build(scale=1.0):
        return {"a": leaf(("a",), shapes["a"], scale),
                "b": leaf(("b",), shapes["b"], scale),
                "c": {"d": leaf(("c", "d"), shapes["c"]["d"], scale),
                      "e": leaf(("c", "e"), shapes["c"]["e"], scale)}}

    params = build()
    state = masked_adam.MaskedAdamState(
        build(1e-3), tree.tree_map(lambda l: l.float().abs() * 1e-4, build()),
        torch.tensor([0, 3, 11][:b], dtype=torch.int32))
    mask = tree.tree_map(
        lambda l: torch.from_numpy(rng.random(l.shape) < 0.3), params)
    return params, state, mask, build


@pytest.mark.parametrize("mixed", [False, True], ids=["float32", "bf16_float32"])
def test_flat_k_loop_is_the_tree_steps_bitwise(mixed):
    rng = np.random.default_rng(7)
    params, state, mask, build = _stacked_case(rng, 3, mixed)
    grads = [build(1e-2) for _ in range(3)]
    p_t, s_t, u_t = params, state, None
    for g in grads:
        p_t, s_t, u_t = kops.masked_adam_stacked(p_t, g, s_t, mask, **HP)
    plan = stacking.stack_plan(params)
    p, m, v, msk = (stacking.flatten_tree(t, plan)
                    for t in (params, state.m, state.v, mask))
    count = state.count
    for g in grads:
        p, m, v, u, count = kops.masked_adam_flat(p, g, m, v, msk, count, plan, **HP)
    p_f, m_f, v_f, u_f = (stacking.unflatten_tree(x, plan) for x in (p, m, v, u))
    assert torch.equal(count, s_t.count)
    for a, b in zip(tree.leaves((p_t, s_t.m, s_t.v, u_t)),
                    tree.leaves((p_f, m_f, v_f, u_f))):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_flatten_group_is_the_per_leaf_layout_bitwise():
    """The one-``torch.cat`` flatten lays each leaf at its plan offset in a
    zero-padded ``(B, rows, 128)`` buffer, bit for bit a copy of each leaf
    into its slice of a zeroed buffer; with a ``transform`` too (|u| for
    the top-k), and the tree round trip is exact."""
    rng = np.random.default_rng(8)
    params, state, mask, _ = _stacked_case(rng, 2, mixed=True)
    plan = stacking.stack_plan(params)
    for t, transform in ((params, None), (state.m, torch.abs), (state.v, None),
                         (mask, None)):
        leaves = tree.leaves(t)
        flat = stacking.flatten_tree(t, plan)
        for g, buf in zip(plan.groups, flat):
            got = stacking.flatten_group(leaves, g, plan.b, transform)
            parts = [leaves[i] if transform is None else transform(leaves[i])
                     for i in g.indices]
            want = torch.zeros((plan.b, g.rows * stacking.LANES), dtype=parts[0].dtype)
            for off, size, x in zip(g.offsets, g.sizes, parts):
                want[:, off:off + size] = x.reshape(plan.b, -1)
            want = want.view(plan.b, g.rows, stacking.LANES)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            if transform is None:
                assert torch.equal(buf.view(torch.uint8), want.view(torch.uint8))
        back = stacking.unflatten_tree(flat, plan)
        for a, b in zip(leaves, tree.leaves(back)):
            assert torch.equal(a, b)


def _port_sessions(n, hw=HW, p0=None, first_masks=None, lg=None):
    worlds = [SegWorld.make(VideoConfig(seed=100 + i, height=hw, width=hw,
                                        fps=2.0, duration=20.0), T_SEG)
              for i in range(n)]
    if p0 is None:
        p0 = params_from_numpy(_np(j_make_student(J_SEG, jax.random.PRNGKey(0))), "cpu")
    sessions = [AMSSession(Task(loss_and_grad=lg or w.loss_and_grad, teacher=None,
                                phi_loss=phi_pixel_loss), T_AMS, p0, seed=i,
                           first_mask=None if first_masks is None
                           else params_from_numpy(first_masks[i], "cpu"))
                for i, w in enumerate(worlds)]
    _feed(sessions, worlds)
    return sessions


def _feed(sessions, worlds):
    for s, w in zip(sessions, worlds):
        f = np.stack([w.video.frame(j)[0] for j in range(6)])
        lab = np.stack([w.teacher.label(j) for j in range(6)])
        s.receive_labeled(f, lab, 5.0)


def _np(t):
    return jax.tree.map(np.asarray, t)


def test_flat_phase_is_the_tree_loop_bitwise():
    """A whole stacked phase in the flat layout against the loop it
    replaced: per iteration the vmapped loss/grad over the stacked tree,
    then `masked_adam_stacked`."""
    sessions = _port_sessions(B)
    params = batched.stack_trees([s.params for s in sessions])
    opt = batched.stack_trees([s.opt_state for s in sessions])
    rng = np.random.default_rng(3)
    mask = tree.tree_map(lambda l: torch.from_numpy(rng.random(l.shape) < 0.2), params)
    batches = [[s.buffer.sample(rng, T_AMS.batch_size, 5.0) for _ in range(2)]
               for s in sessions]
    frames = torch.from_numpy(np.stack([np.stack([b[0] for b in bs]) for bs in batches], 1))
    labels = torch.from_numpy(np.stack([np.stack([b[1] for b in bs]) for bs in batches], 1))
    vgrad = torch.func.vmap(sessions[0].task.loss_and_grad)
    p, st, u = params, opt, None
    for k in range(frames.shape[0]):
        losses, grads = vgrad(p, frames[k], labels[k])
        p, st, u = kops.masked_adam_stacked(p, grads, st, mask, **HP)
    runs0 = batched.exec_info()["loop_runs"]
    phase = batched.fused_phase_fn(
        sessions[0].task.loss_and_grad,
        struct=tree.struct((params, opt, mask, frames, labels)), k_iters=2,
        optimizer="adam", momentum=0.9, device="cpu", **HP)
    p_f, st_f, u_f, losses_f = phase(params, opt, mask, frames, labels)
    assert batched.exec_info()["loop_runs"] == runs0 + 1
    assert torch.equal(losses, losses_f)
    for a, b in zip(tree.leaves((p, st, u)), tree.leaves((p_f, st_f, u_f))):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the exec mode
# ---------------------------------------------------------------------------


def test_set_exec_mode_rejects_bad_modes():
    for bad in ("scan", "unrolled", "", "Graph"):
        with pytest.raises(ValueError):
            batched.set_exec_mode(bad)
    for good in ("graph", "loop", "auto"):
        batched.set_exec_mode(good)


def test_graph_on_a_cpu_group_raises_and_runs_nothing():
    sessions = _port_sessions(B)
    before = [tree.tree_map(torch.clone, s.params) for s in sessions]
    ran0 = batched.exec_info()
    batched.set_exec_mode("graph")
    with pytest.raises(ValueError, match="CUDA"):
        batched.train_phases_fused(sessions, 6.0, force_stack=True)
    assert batched.exec_info() == ran0
    assert batched.cache_info() == {"size": 0, "hits": 0, "misses": 0}
    for s, p in zip(sessions, before):
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(s.params),
                                                     tree.leaves(p)))


def _jax_fleet(pre):
    out = []
    for i in range(B):
        w = JSegWorld.make(JVideoConfig(seed=100 + i, height=HW, width=HW, fps=2.0,
                                        duration=20.0), J_SEG)
        s = JAMSSession(JTask(w.loss_and_grad, None, j_phi), J_AMS,
                        jax.tree.map(lambda x: x, pre), seed=i)
        f = np.stack([w.video.frame(j)[0] for j in range(6)])
        lab = np.stack([w.teacher.label(j) for j in range(6)])
        s.receive_labeled(f, lab, 5.0)
        out.append(s)
    return out


@pytest.mark.parametrize("mode", ["loop", "auto"])
def test_cache_sequence_is_the_jax_package_s(mode):
    pre = j_make_student(J_SEG, jax.random.PRNGKey(0))
    batched.set_exec_mode(mode)
    jbatched.set_exec_mode(mode)
    snap = timing.snapshot()
    seq = {"port": [], "jax": []}
    for _ in range(2):  # two same-shaped fleets
        jbatched.train_phases_fused(_jax_fleet(pre), 6.0, force_stack=True)
        batched.train_phases_fused(_port_sessions(B), 6.0, force_stack=True)
        seq["jax"].append(jbatched.cache_info())
        seq["port"].append(batched.cache_info())
    assert seq["port"] == seq["jax"] == [{"size": 1, "hits": 0, "misses": 1},
                                         {"size": 1, "hits": 1, "misses": 1}]
    decisions = batched.auto_mode_info()
    j_decisions = jbatched.auto_mode_info()
    if mode == "loop":
        assert decisions == j_decisions == {}
    else:
        assert len(decisions) == len(j_decisions) == 1
        ((backend, _), winner), = decisions.items()
        assert (backend, winner) == ("cpu", "loop")
        assert list(j_decisions.values())[0] in ("scan", "loop")
    assert batched.race_info() == {}  # no race off CUDA
    # train_fused's first call is the miss, the second the hit
    (stats,) = [v for (st, _), v in timing.delta(snap).items() if st == "train_fused"]
    assert (stats["calls"], stats["first_calls"]) == (2, 1)
    batched.cache_clear()
    jbatched.cache_clear()
    assert batched.cache_info() == jbatched.cache_info() == {
        "size": 0, "hits": 0, "misses": 0}
    assert batched.auto_mode_info() == jbatched.auto_mode_info() == {}


def test_debug_snapshot_keys_are_the_jax_package_s_minus_four():
    batched.train_phases_fused(_port_sessions(B), 6.0, force_stack=True)
    snap = obs.debug_snapshot()
    assert set(snap) == set(j_obs.debug_snapshot()) - NO_COUNTERPART
    assert snap["sharded"] == batched.sharded_info()
    assert snap["fused_train_cache"] == batched.cache_info() == {
        "size": 1, "hits": 0, "misses": 1}
    ((key, winner),) = snap["auto_exec_modes"].items()
    backend, digits = key.split(":")
    assert (backend, winner, len(digits)) == ("cpu", "loop", 8) and digits.isdigit()


# ---------------------------------------------------------------------------
# one fused phase against the JAX package's
# ---------------------------------------------------------------------------


@jax.jit
def _j_loss_and_grad64(params, frames, labels):
    p64 = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    loss, g = jax.value_and_grad(lambda p: j_seg_loss(
        J_SEG, p, frames.astype(jnp.float64), labels))(p64)
    return loss.astype(jnp.float32), jax.tree.map(lambda a: a.astype(jnp.float32), g)


def _t_loss_and_grad64(lg):
    def loss_and_grad(params, frames, labels):
        loss, g = lg(tree.tree_map(torch.Tensor.double, params), frames.double(), labels)
        return loss.float(), tree.tree_map(torch.Tensor.float, g)
    return loss_and_grad


def _unpack_mask(delta, like):
    flat = np.unpackbits(np.frombuffer(gzip.decompress(delta.packed_mask),
                                       np.uint8))[:delta.n_total].astype(bool)
    leaves, treedef = jax.tree.flatten(like)
    out, off = [], 0
    for l in leaves:
        out.append(flat[off:off + l.size].reshape(l.shape))
        off += l.size
    return jax.tree.unflatten(treedef, out)


def _ulps(a16, b16):
    def key(x):
        i = x.view(np.int16).astype(np.int32)
        return np.where(i < 0, -32768 - i, i)
    return np.abs(key(a16) - key(b16))


@pytest.fixture(scope="module")
def jax_phase64():
    with jax.enable_x64(True):
        jbatched.set_exec_mode("loop")
        try:
            p0 = j_make_student(J_SEG, jax.random.PRNGKey(0))
            fleet = []
            for i in range(B):
                w = JSegWorld.make(JVideoConfig(seed=100 + i, height=HW, width=HW,
                                                fps=2.0, duration=20.0), J_SEG)
                s = JAMSSession(JTask(_j_loss_and_grad64, None, j_phi), J_AMS, p0, seed=i)
                f = np.stack([w.video.frame(j)[0] for j in range(6)])
                lab = np.stack([w.teacher.label(j) for j in range(6)])
                s.receive_labeled(f, lab, 5.0)
                fleet.append(s)
            deltas = jbatched.train_phases_fused(fleet, 6.0, force_stack=True)
        finally:
            jbatched.set_exec_mode("auto")
            jbatched.cache_clear()
    p0 = _np(p0)
    return p0, deltas, [_unpack_mask(d, p0) for d in deltas], \
        [s.history[-1]["loss"] for s in fleet]


@pytest.mark.parametrize("mode", ["auto", "loop"])
def test_one_fused_phase_against_the_jax_package(jax_phase64, mode):
    p0, j_deltas, masks, j_losses = jax_phase64
    batched.set_exec_mode(mode)
    lg = _t_loss_and_grad64(SegWorld(video=None, teacher=None, seg_cfg=T_SEG).loss_and_grad)
    sessions = _port_sessions(B, p0=params_from_numpy(p0, "cpu"), first_masks=masks, lg=lg)
    deltas = batched.train_phases_fused(sessions, 6.0, force_stack=True)
    for i, (dt, dj) in enumerate(zip(deltas, j_deltas)):
        assert dt.packed_mask == dj.packed_mask, i
        assert dt.values.dtype == dj.values.dtype == np.float16
        assert _ulps(dt.values, dj.values).max() <= 1, i
        np.testing.assert_allclose(sessions[i].history[-1]["loss"], j_losses[i],
                                   rtol=1e-6)
    assert batched.cache_info() == {"size": 1, "hits": 0, "misses": 1}
