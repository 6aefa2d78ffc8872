"""Port parity for the slice as a whole: 3 sessions of the width-1.0
student through 3 fused AMS phases (`core/batched.train_phases_fused`),
against the JAX package's fused path with its Pallas kernels (interpret
mode), on even (24) and odd (25) frame sizes.

* With float64 gradients in both packages (each student's forward and
  backward in float64, cast to float32 for the optimizer), free-running
  from the same initial weights and phase-0 masks: every wire mask is
  byte-identical, every fp16 value within 1 ULP, every loss within rtol
  1e-6, over all 3 phases.
* With the float32 gradients of the real path, per phase, each port
  session started from the JAX session's state (params, Adam state,
  previous update u; the JAX phase-0 mask injected): the wire masks are
  byte-identical and the losses agree within rtol 1e-4. The fp16 values
  agree within 1 ULP except at a few coordinates: the float32 gradients of
  both packages sit up to ~4e-4 of a leaf's largest entry from the float64
  ones (`test_torch_student`), and Adam's normalised step follows that
  rounding noise wherever a coordinate's gradient is small beside it. They
  were measured at up to 3.3% of a delta in the random-mask phase 0 and up
  to 0.25% in the gradient-guided phases, which select well-conditioned
  coordinates; the bounds are 5% and 0.5%. The float64 case above shows
  that these coordinates come from the gradients' rounding alone.
* Free-running from the same initial weights and phase-0 masks: the mean
  edge mIoU on held-out frames agrees within 0.02 and every delta
  selects the same number of coordinates.
"""
import contextlib
import dataclasses
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as jbatched
from repro.core import kernel_dispatch
from repro.core.client import EdgeClient as JEdgeClient
from repro.core.server import AMSConfig as JAMSConfig
from repro.core.server import AMSSession as JAMSSession
from repro.core.server import Task as JTask
from repro.data.video import VideoConfig
from repro.metrics.miou import miou
from repro.models.seg.student import SegConfig as JSegConfig
from repro.models.seg.student import make_student as j_make_student
from repro.models.seg.student import seg_loss as j_seg_loss
from repro.sim.seg_world import SegWorld as JSegWorld
from repro.sim.seg_world import phi_pixel_loss
from repro_torch import tree
from repro_torch.core import batched
from repro_torch.core.client import EdgeClient
from repro_torch.core.masked_adam import MaskedAdamState
from repro_torch.core.server import AMSConfig, AMSSession, Task
from repro_torch.models.seg.student import SegConfig, params_from_numpy
from repro_torch.sim.seg_world import SegWorld

B, PHASES = 3, 3
J_SEG = JSegConfig(n_classes=5)
J_AMS = JAMSConfig(t_update=8.0, t_horizon=30.0, k_iters=4, batch_size=2,
                   gamma=0.05, lr=2e-3, phi_target=0.15)
T_AMS = AMSConfig(**{f.name: getattr(J_AMS, f.name)
                     for f in dataclasses.fields(AMSConfig)})
FEED = [(range(0, 6), 5.0, 6.0), (range(6, 10), 13.0, 14.0),
        (range(10, 14), 21.0, 22.0)]  # (frames, t_feed, t_train) per phase
HELD_OUT = range(16, 20)


def _worlds(hw):
    return [JSegWorld.make(VideoConfig(seed=100 + i, height=hw, width=hw,
                                       fps=2.0, duration=20.0), J_SEG)
            for i in range(B)]


def _feed(sessions, worlds, phase):
    frames, t_feed, _ = FEED[phase]
    for s, w in zip(sessions, worlds):
        f = np.stack([w.video.frame(j)[0] for j in frames])
        l = np.stack([w.teacher.label(j) for j in frames])
        s.receive_labeled(f, l, t_feed)


def _edge_miou(predict, clients, worlds):
    scores = []
    for c, w in zip(clients, worlds):
        for j in HELD_OUT:
            img, _ = w.video.frame(j)
            pred = np.asarray(predict(c.active, img[None]))[0]
            scores.append(miou(pred, w.teacher.label(j), 5))
    return float(np.mean(scores))


def _unpack_mask(delta, params_np):
    flat = np.unpackbits(np.frombuffer(gzip.decompress(delta.packed_mask),
                                       np.uint8))[:delta.n_total].astype(bool)
    leaves, treedef = jax.tree.flatten(params_np)
    out, off = [], 0
    for l in leaves:
        out.append(flat[off:off + l.size].reshape(l.shape))
        off += l.size
    return jax.tree.unflatten(treedef, out)


def _np(t):
    return jax.tree.map(np.asarray, t)


@jax.jit
def _j_loss_and_grad64(params, frames, labels):
    """The JAX student's loss and gradients computed in float64 (x64
    mode), returned in float32."""
    p64 = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    loss, g = jax.value_and_grad(lambda p: j_seg_loss(
        J_SEG, p, frames.astype(jnp.float64), labels))(p64)
    return loss.astype(jnp.float32), jax.tree.map(lambda a: a.astype(jnp.float32), g)


def _t_loss_and_grad64(lg):
    """The port's ``lg`` computed in float64, returned in float32."""
    def loss_and_grad(params, frames, labels):
        loss, g = lg(tree.tree_map(torch.Tensor.double, params),
                     frames.double(), labels)
        return loss.float(), tree.tree_map(torch.Tensor.float, g)
    return loss_and_grad


def _jax_reference(hw, float64_grads=False):
    """The JAX package's fused run, with every session's state kept from
    before each phase, its deltas, and its edge mIoU."""
    x64 = jax.enable_x64(True) if float64_grads else contextlib.nullcontext()
    kernel_dispatch.set_kernel_mode("pallas")
    try:
        with x64:
            worlds = _worlds(hw)
            p0 = j_make_student(J_SEG, jax.random.PRNGKey(0))
            sessions = [JAMSSession(JTask(_j_loss_and_grad64 if float64_grads
                                          else w.loss_and_grad, None, phi_pixel_loss),
                                    J_AMS, p0, seed=i) for i, w in enumerate(worlds)]
            clients = [JEdgeClient(w.predict, p0) for w in worlds]
            before, deltas, losses = [], [], []
            for phase in range(PHASES):
                _feed(sessions, worlds, phase)
                before.append([(_np(s.params), _np(s.opt_state),
                                None if s.u_prev is None else _np(s.u_prev))
                               for s in sessions])
                ds = jbatched.train_phases_fused(sessions, FEED[phase][2])
                deltas.append(ds)
                losses.append([s.history[-1]["loss"] for s in sessions])
                for c, d in zip(clients, ds):
                    c.apply_update(d)
            p0_np = _np(p0)
            return dict(hw=hw, p0=p0_np, before=before, deltas=deltas,
                        losses=losses,
                        first_masks=[_unpack_mask(d, p0_np) for d in deltas[0]],
                        miou=_edge_miou(worlds[0].predict, clients, worlds))
    finally:
        kernel_dispatch.reset()


@pytest.fixture(scope="module", params=[24, 25])
def jax_run(request):
    torch.set_num_threads(1)
    return _jax_reference(request.param)


@pytest.fixture(scope="module", params=[24, 25])
def jax_run64(request):
    torch.set_num_threads(1)
    return _jax_reference(request.param, float64_grads=True)


def _port_sessions(run, float64_grads=False):
    worlds = _worlds(run["hw"])
    seg = SegConfig(**dataclasses.asdict(J_SEG))
    lg = SegWorld(video=None, teacher=None, seg_cfg=seg).loss_and_grad
    if float64_grads:
        lg = _t_loss_and_grad64(lg)
    p0 = params_from_numpy(run["p0"], "cpu")
    sessions = [AMSSession(Task(loss_and_grad=lg, teacher=None, phi_loss=phi_pixel_loss),
                           T_AMS, p0, seed=i,
                           first_mask=params_from_numpy(run["first_masks"][i], "cpu"))
                for i in range(B)]
    return worlds, sessions, p0, seg


def _ulps(a16: np.ndarray, b16: np.ndarray) -> np.ndarray:
    """Elementwise distance in fp16 units in the last place (on the
    ordered integer view of the bit patterns, so across zero too)."""
    def key(x):
        i = x.view(np.int16).astype(np.int32)
        return np.where(i < 0, -32768 - i, i)
    return np.abs(key(a16) - key(b16))


def test_phases_from_jax_state(jax_run):
    worlds, sessions, _, _ = _port_sessions(jax_run)
    for phase in range(PHASES):
        _feed(sessions, worlds, phase)
        for s, (p, st, u) in zip(sessions, jax_run["before"][phase]):
            s.params = params_from_numpy(p, "cpu")
            s.opt_state = MaskedAdamState(params_from_numpy(st.m, "cpu"),
                                          params_from_numpy(st.v, "cpu"),
                                          torch.tensor(int(st.count), dtype=torch.int32))
            s.u_prev = None if u is None else params_from_numpy(u, "cpu")
        ds = batched.train_phases_fused(sessions, FEED[phase][2])
        for i, (dt, dj) in enumerate(zip(ds, jax_run["deltas"][phase])):
            assert dt.packed_mask == dj.packed_mask, (phase, i)
            assert dt.values.dtype == dj.values.dtype == np.float16
            far = _ulps(dt.values, dj.values) > 1
            assert far.mean() <= (0.05 if phase == 0 else 0.005), \
                (phase, i, int(far.sum()))
            np.testing.assert_allclose(sessions[i].history[-1]["loss"],
                                       jax_run["losses"][phase][i], rtol=1e-4)


def test_phases_float64_grads_within_one_ulp(jax_run64):
    worlds, sessions, _, _ = _port_sessions(jax_run64, float64_grads=True)
    for phase in range(PHASES):
        _feed(sessions, worlds, phase)
        ds = batched.train_phases_fused(sessions, FEED[phase][2])
        for i, (dt, dj) in enumerate(zip(ds, jax_run64["deltas"][phase])):
            assert dt.packed_mask == dj.packed_mask, (phase, i)
            assert dt.values.dtype == dj.values.dtype == np.float16
            assert _ulps(dt.values, dj.values).max() <= 1, (phase, i)
            np.testing.assert_allclose(sessions[i].history[-1]["loss"],
                                       jax_run64["losses"][phase][i], rtol=1e-6)


def test_free_running_miou_and_counts(jax_run):
    worlds, sessions, p0, seg = _port_sessions(jax_run)
    lg_predict = SegWorld(video=None, teacher=None, seg_cfg=seg).predict
    clients = [EdgeClient(lg_predict, p0) for _ in range(B)]
    for phase in range(PHASES):
        _feed(sessions, worlds, phase)
        ds = batched.train_phases_fused(sessions, FEED[phase][2])
        for c, d, dj in zip(clients, ds, jax_run["deltas"][phase]):
            assert d.values.size == dj.values.size
            c.apply_update(d)
        for s in sessions:
            assert np.isfinite(s.history[-1]["loss"])
    m = _edge_miou(lambda p, x: lg_predict(p, torch.from_numpy(x)), clients, worlds)
    assert abs(m - jax_run["miou"]) <= 0.02, (m, jax_run["miou"])
    assert all(c.updates_applied == PHASES for c in clients)
    assert all(tree.leaves(c.active)[0].dtype == torch.float32 for c in clients)


def test_singleton_group_is_the_sequential_phase(jax_run):
    """A group of one takes the sequential step path: bit for bit the
    session's own `train_phase`."""
    worlds, a, _, _ = _port_sessions(jax_run)
    _, b, _, _ = _port_sessions(jax_run)
    for phase in range(2):
        _feed(a[:1], worlds[:1], phase)
        _feed(b[:1], worlds[:1], phase)
        (d_fused,) = batched.train_phases_fused(a[:1], FEED[phase][2])
        d_seq = b[0].train_phase(FEED[phase][2])
        assert d_fused.packed_mask == d_seq.packed_mask
        assert d_fused.values.tobytes() == d_seq.values.tobytes()
    for x, y in zip(tree.leaves((a[0].params, a[0].opt_state, a[0].u_prev)),
                    tree.leaves((b[0].params, b[0].opt_state, b[0].u_prev))):
        assert torch.equal(x, y)
