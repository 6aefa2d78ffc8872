"""Port parity for sharded execution (`core/batched.train_phases_sharded`,
`launch/host_mesh.py`, the session mesh of `launch/mesh.py`, the drift
report's per-device audit in `serving/obs.py`), on the CPU.

* With float64 gradients in both packages (the pattern of
  `tests/test_torch_slice.py`), 4 sessions of the width-1.0 student at
  24x24 frames, K = 4, in D = 2 groups of B = 2, free-running from the
  same initial weights and phase-0 masks through 3 phases of the JAX
  package's ``train_phases_sharded(devices=[None] * 2)`` and the port's:
  every wire mask byte-identical, every fp16 value within 1 ULP, every
  loss within rtol 1e-6, and the two packages' `sharded_info()` equal.
* The port against itself: ``devices=[None] * D`` and ``[cpu] * D`` are
  byte-identical to per-group ``train_phases_fused(force_stack=True)``
  over the layouts (D, B) in (1, 2), (2, 1), (2, 2), (3, 1), as the JAX
  package's `tests/test_sharded.py` holds its own path.
* A session with nothing to train gets None; the validation errors have
  the JAX package's wording; a CUDA binding on a host without CUDA raises
  (nothing falls back to the CPU).
* One synthetic `core.timing` stats dict through both packages'
  `drift_report` under equal cost models gives equal dicts, the
  ``per_device`` audit included; `debug_snapshot()["sharded"]` is
  `sharded_info()`.
* `host_devices` and `make_session_mesh` raise on this CUDA-less host, and
  with the CUDA count stubbed they give the cards and the JAX mesh's axis
  names.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # hypothesis, or a fallback when absent
from test_torch_slice import (FEED, J_AMS, J_SEG, T_AMS, _j_loss_and_grad64, _np,
                              _t_loss_and_grad64, _ulps, _unpack_mask)

from repro.core import batched as jbatched
from repro.core.scheduler import GPUCostModel as JGPUCostModel
from repro.core.server import AMSSession as JAMSSession
from repro.core.server import Task as JTask
from repro.data.video import VideoConfig
from repro.launch.mesh import make_session_mesh as j_make_session_mesh
from repro.models.seg.student import make_student as j_make_student
from repro.serving import obs as jobs
from repro.sim.seg_world import SegWorld as JSegWorld
from repro.sim.seg_world import phi_pixel_loss
from repro_torch import tree
from repro_torch.core import batched
from repro_torch.core.scheduler import GPUCostModel
from repro_torch.core.server import AMSConfig, AMSSession, Task
from repro_torch.launch import host_mesh, mesh
from repro_torch.models.seg.student import SegConfig, make_student, params_from_numpy
from repro_torch.serving import obs
from repro_torch.sim.seg_world import SegWorld

D, GB, HW, PHASES = 2, 2, 24, 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _worlds(n, seed0=100):
    return [JSegWorld.make(VideoConfig(seed=seed0 + i, height=HW, width=HW, fps=2.0,
                                       duration=20.0), J_SEG) for i in range(n)]


def _feed(sessions, worlds, phase):
    frames, t_feed, _ = FEED[phase]
    for s, w in zip(sessions, worlds):
        s.receive_labeled(np.stack([w.video.frame(j)[0] for j in frames]),
                          np.stack([w.teacher.label(j) for j in frames]), t_feed)


def _groups(fleet, d, b):
    return [fleet[g * b:(g + 1) * b] for g in range(d)]


def _flat(groups_out):
    return [x for grp in groups_out for x in grp]


# ---------------- float64 parity with the JAX package ----------------


@pytest.fixture(scope="module")
def jax_run64():
    """The JAX package's sharded run (loop shape, float64 gradients): its
    deltas, losses, `sharded_info` and phase-0 masks."""
    mode = jbatched._EXEC_MODE
    jbatched.set_exec_mode("loop")
    try:
        with jax.enable_x64(True):
            worlds = _worlds(D * GB)
            p0 = j_make_student(J_SEG, jax.random.PRNGKey(0))
            sessions = [JAMSSession(JTask(_j_loss_and_grad64, None, phi_pixel_loss),
                                    J_AMS, p0, seed=i) for i in range(D * GB)]
            jbatched.sharded_reset()
            deltas, losses = [], []
            for phase in range(PHASES):
                _feed(sessions, worlds, phase)
                deltas.append(_flat(jbatched.train_phases_sharded(
                    _groups(sessions, D, GB), FEED[phase][2], devices=[None] * D)))
                losses.append([s.history[-1]["loss"] for s in sessions])
            p0_np = _np(p0)
            return dict(p0=p0_np, deltas=deltas, losses=losses,
                        info=jbatched.sharded_info(),
                        first_masks=[_unpack_mask(d, p0_np) for d in deltas[0]])
    finally:
        jbatched.set_exec_mode(mode)


def test_sharded_float64_matches_jax(jax_run64):
    seg = SegConfig(**dataclasses.asdict(J_SEG))
    lg = _t_loss_and_grad64(SegWorld(video=None, teacher=None, seg_cfg=seg).loss_and_grad)
    p0 = params_from_numpy(jax_run64["p0"], "cpu")
    sessions = [AMSSession(Task(loss_and_grad=lg, teacher=None, phi_loss=phi_pixel_loss),
                           T_AMS, p0, seed=i,
                           first_mask=params_from_numpy(jax_run64["first_masks"][i], "cpu"))
                for i in range(D * GB)]
    worlds = _worlds(D * GB)
    batched.sharded_reset()
    for phase in range(PHASES):
        _feed(sessions, worlds, phase)
        ds = _flat(batched.train_phases_sharded(_groups(sessions, D, GB), FEED[phase][2],
                                                devices=[None] * D))
        for i, (dt, dj) in enumerate(zip(ds, jax_run64["deltas"][phase])):
            assert dt.packed_mask == dj.packed_mask, (phase, i)
            assert dt.values.dtype == dj.values.dtype == np.float16
            assert _ulps(dt.values, dj.values).max() <= 1, (phase, i)
            np.testing.assert_allclose(sessions[i].history[-1]["loss"],
                                       jax_run64["losses"][phase][i], rtol=1e-6)
    assert batched.sharded_info() == jax_run64["info"] == {
        "batches": PHASES, "groups": PHASES * D, "sessions": PHASES * D * GB,
        "dispatch_launches": PHASES * D, "spmd_launches": 0, "distinct_devices": 1}


# ---------------- the port against its own fused path ----------------


def _fleet(n, seed0=600, k_iters=2, hw=16):
    """A port-only fleet (K = 2 at 16x16 frames, as the JAX package's own
    sharded tests size theirs), every session from one seeded init."""
    seg = SegConfig(n_classes=5)
    ams = AMSConfig(**{**dataclasses.asdict(T_AMS), "k_iters": k_iters})
    pre = make_student(seg, seed=0, device="cpu")
    worlds = [SegWorld.make(VideoConfig(seed=seed0 + i, height=hw, width=hw, fps=2.0,
                                        duration=20.0), seg) for i in range(n)]
    sessions = [AMSSession(Task(loss_and_grad=w.loss_and_grad, teacher=None,
                                phi_loss=phi_pixel_loss), ams,
                           tree.tree_map(torch.clone, pre), seed=i)
                for i, w in enumerate(worlds)]
    return sessions, worlds


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.packed_mask == y.packed_mask
            assert x.values.tobytes() == y.values.tobytes()


@settings(max_examples=4, deadline=None)
@given(layout=st.sampled_from(((1, 2), (2, 1), (2, 2), (3, 1))))
def test_sharded_grouping_property(layout):
    """Over (pool size D, group width B), 2 phases (a random mask, then
    gradient-guided selection): the sharded results, flattened, align slot
    for slot with per-group fused results, byte for byte, placed on no
    device and on the CPU; the sessions' states end equal bit for bit."""
    d, b = layout
    (ref, worlds), (none, _), (cpu, _) = (_fleet(d * b) for _ in range(3))
    batched.sharded_reset()
    for phase in range(2):
        for f in (ref, none, cpu):
            _feed(f, worlds, phase)
        t = FEED[phase][2]
        want = [x for g in _groups(ref, d, b)
                for x in batched.train_phases_fused(g, t, force_stack=True)]
        got_none = batched.train_phases_sharded(_groups(none, d, b), t, devices=[None] * d)
        got_cpu = batched.train_phases_sharded(_groups(cpu, d, b), t,
                                               devices=[torch.device("cpu")] * d)
        assert [len(g) for g in got_none] == [len(g) for g in got_cpu] == [b] * d
        _same(want, _flat(got_none))
        _same(want, _flat(got_cpu))
    for f in (none, cpu):
        for x, y in zip(ref, f):
            assert x.phase == y.phase == 2
            for a, c in zip(tree.leaves((x.params, x.opt_state, x.u_prev)),
                            tree.leaves((y.params, y.opt_state, y.u_prev))):
                assert torch.equal(a, c)
    info = batched.sharded_info()
    assert info == {"batches": 4, "groups": 4 * d, "sessions": 4 * d * b,
                    "dispatch_launches": 4 * d, "spmd_launches": 0,
                    "distinct_devices": 1}


def test_sharded_handles_nothing_to_train_slots():
    """A session with nothing ingested gets None in its slot, as in
    `train_phases_fused`; the other slots train."""
    (fleet, worlds) = _fleet(2)
    _feed(fleet, worlds, 0)
    idle = AMSSession(fleet[0].task, fleet[0].cfg,
                      tree.tree_map(torch.clone, fleet[0].params), seed=9)
    batched.sharded_reset()
    out = batched.train_phases_sharded([[idle, fleet[0]], [fleet[1]]], FEED[0][2],
                                       devices=[None, None])
    assert out[0][0] is None
    assert out[0][1] is not None and out[1][0] is not None
    assert batched.sharded_info()["sessions"] == 2


class _Prepared:
    """A session whose phase preparation hands back a fixed phase, keyed
    by ``key`` (`_group_key` stubbed): what the JAX package's validation
    reads before it trains anything."""

    def __init__(self, key):
        self.key = key

    def _prepare_phase_deferred(self, t_now):
        return None, np.zeros((1, 1)), np.zeros((1, 1))


def test_sharded_validates_inputs(monkeypatch):
    """The two validation errors, word for word the JAX package's."""
    def message(train, groups, devices):
        with pytest.raises(ValueError) as e:
            train(groups, FEED[0][2], devices=devices)
        return str(e.value)

    (fleet, worlds) = _fleet(2)
    (k3, _) = _fleet(1, k_iters=3)
    _feed(fleet + k3, worlds + worlds[:1], 0)
    monkeypatch.setattr(jbatched, "_group_key", lambda s, *_: s.key)
    got = message(batched.train_phases_sharded, [[fleet[0]], [fleet[1]]], [None])
    assert "device bindings" in got
    assert got == message(jbatched.train_phases_sharded, [[_Prepared(0)], [_Prepared(0)]],
                          [None])
    got = message(batched.train_phases_sharded, [[fleet[0], k3[0]]], [None])
    assert "ONE compile key" in got
    assert got == message(jbatched.train_phases_sharded, [[_Prepared(0), _Prepared(1)]],
                          [None])


def test_sharded_refuses_a_card_the_host_lacks():
    """A CUDA binding on a host without CUDA raises before any session is
    touched: nothing runs the group on the CPU instead."""
    (fleet, worlds) = _fleet(1)
    _feed(fleet, worlds, 0)
    phase0 = fleet[0].phase
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batched.train_phases_sharded([fleet], 6.0, devices=[torch.device("cuda", 0)])
    assert fleet[0].phase == phase0


# ---------------- the drift report and the snapshot ----------------


def _stats():
    """One synthetic `core.timing` stats dict: the fused stages and a
    sharded batch of 3 slots, uniform and not."""
    def e(calls, first, first_s, steady_s, nbytes):
        return {"calls": calls, "first_calls": first, "first_s": first_s,
                "steady_s": steady_s, "nbytes": nbytes}

    return {
        ("train_fused", (2, 4)): e(5, 1, 0.9, 0.61, 4_000_000),
        ("select_stacked", (2,)): e(5, 1, 0.2, 0.013, 0),
        ("sharded_device", (0, 2, 4)): e(4, 1, 1.5, 0.72, 3_300_000),
        ("sharded_device", (1, 2, 4)): e(4, 1, 1.6, 0.81, 3_300_000),
        ("sharded_device", (2, 3, 4)): e(3, 0, 0.0, 0.95, 4_950_000),
        ("sharded_device", (3, 2, 4)): e(2, 2, 2.0, 0.0, 1_650_000),
        ("train_sharded", (2, 2, 4)): e(4, 1, 1.7, 0.83, 6_600_000),
        ("train_sharded", (3,)): e(3, 0, 0.0, 1.2, 9_900_000),
        ("encode_stacked", (2,)): e(5, 0, 0.0, 0.05, 120_000),
    }


def test_drift_report_per_device_matches_jax():
    kw = dict(select_s=0.15, delta_comp_s_per_mb=5.0)
    got = obs.drift_report(GPUCostModel(**kw), _stats())
    want = jobs.drift_report(JGPUCostModel(**kw), _stats())
    assert got == want
    per = got["sharded_device"]["per_device"]
    assert sorted(per) == [0, 1, 2, 3]
    assert per[3]["drift_ratio"] is None and per[3]["steady_calls"] == 0
    # the (3,) batch of unequal groups is priced per device only
    assert got["train_sharded"]["steady_calls"] == 3
    assert obs._modeled_stage_s(GPUCostModel(**kw), "train_sharded", (3,), 0, 3) is None


def test_debug_snapshot_reports_the_sharded_counters():
    snap = obs.debug_snapshot()
    assert snap["sharded"] == batched.sharded_info()
    assert set(snap["sharded"]) == set(jobs.debug_snapshot()["sharded"])


# ---------------- the session mesh and the host's cards ----------------


def test_meshes_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    assert host_mesh.host_devices() == []
    with pytest.raises(RuntimeError, match="asked for 2 CUDA cards but only 0 exist; "
                                           "this path needs 2 cards"):
        host_mesh.host_devices(2)
    for make in (mesh.make_session_mesh, host_mesh.make_host_mesh):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(1)


def test_session_mesh_on_stubbed_cards(monkeypatch):
    """With two cards stubbed: the mesh holds them in order under the JAX
    mesh's axis name, and asking for a count out of range raises as JAX's
    does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = mesh.make_session_mesh()
    assert m.axis_names == tuple(j_make_session_mesh(1).axis_names) == ("session",)
    assert m.shape == (2,) and m.size == 2
    assert m.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert host_mesh.make_host_mesh(1).devices == (torch.device("cuda", 0),)
    for n in (0, 3):
        with pytest.raises(ValueError, match=f"session mesh wants {n} devices, have 2"):
            mesh.make_session_mesh(n)
    assert host_mesh.host_devices(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="asked for 3 CUDA cards but only 2 exist"):
        host_mesh.host_devices(3)
