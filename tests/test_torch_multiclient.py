"""Port parity for the multi-client simulation (`sim/multiclient.
run_multiclient`) on real AMS sessions: the serving engine driving fused
groups of segmentation sessions through `core.batched.train_phases_fused`,
against the JAX package on the CPU.

Three clients on 32x32 frames at 2 fps for 30 s, a narrow student (width
0.5), T_update 5 s, K = 3, batch 3, ``fuse_train=3`` on one modeled GPU.
Both packages start from the JAX package's init (`params_from_numpy`), and
the port replays the JAX run's random masks in draw order (ROADMAP F4),
as `tests/test_torch_runner.py` does.

* Float64 gradients and cross-entropy in both packages (ROADMAP F10):
  every schedule and byte key of the results is equal, mean mIoU within
  1e-3, `update_pipeline_info` moves alike, and the `core.timing` stats
  agree on ``(stage, key)``, calls and bytes.
* The edge's params move only through ``apply_delta``; a singleton goes
  through the stacked path under ``force_stack=True`` and is bitwise its
  own ``train_phase`` without it; ``device=`` places a group and commits
  each session back.

`tests/test_torch_multiclient_float32.py` holds the float32 run and the
B = 3 ``force_stack`` case (each file stays near a minute on the CPU: the
JAX package compiles its whole path once per dtype).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as jbatched
from repro.core import selection as jsel
from repro.core import timing as jtiming
from repro.core.server import AMSConfig as JAMSConfig
from repro.models.seg.student import SegConfig as JSegConfig
from repro.models.seg.student import make_student as j_make_student
from repro.models.seg.student import seg_forward as j_seg_forward
from repro.sim import multiclient as jmc
from repro.sim import seg_world as jworld
from repro_torch import tree
from repro_torch.core import batched as tbatched
from repro_torch.core import selection as tsel
from repro_torch.core import timing as ttiming
from repro_torch.core.server import AMSConfig, AMSSession, Task
from repro_torch.data.video import VideoConfig
from repro_torch.models.seg.student import SegConfig, params_from_numpy, seg_forward
from repro_torch.serving import train_many
from repro_torch.sim import multiclient as tmc
from repro_torch.sim import seg_world as tworld

J_SEG = JSegConfig(n_classes=5, width=0.5)
T_SEG = SegConfig(**dataclasses.asdict(J_SEG))
N_CLIENTS, DURATION = 3, 30.0
VIDEO_KW = dict(height=32, width=32, fps=2.0, drift_period=30.0)
AMS_KW = dict(t_update=5.0, t_horizon=20.0, k_iters=3, batch_size=3,
              gamma=0.05, lr=2e-3, phi_target=0.04)
RUN_KW = dict(duration=DURATION, video_kw=VIDEO_KW, fuse_train=3, seed=1)
# keys that read the clock, and the model's accuracy (compared by tolerance)
WALL = ("wall_s", "events_per_sec", "events_per_sec_steady", "observability")
ACCURACY = ("miou_per_client", "mean_miou")


@functools.lru_cache(maxsize=None)  # one callable: sessions group, jit caches
def _j_loss_and_grad64(cfg):
    @jax.jit
    def loss_and_grad(params, frames, labels):
        def loss(p):
            logits = j_seg_forward(cfg, p, frames.astype(jnp.float64))
            lab = jnp.take_along_axis(
                logits, labels[..., None].astype(jnp.int32), -1)[..., 0]
            return (jax.nn.logsumexp(logits, axis=-1) - lab).mean()
        p64 = jax.tree.map(lambda a: a.astype(jnp.float64), params)
        value, g = jax.value_and_grad(loss)(p64)
        return value.astype(jnp.float32), jax.tree.map(
            lambda a: a.astype(jnp.float32), g)
    return loss_and_grad


@functools.lru_cache(maxsize=None)
def _t_loss_and_grad64(cfg):
    def loss(p, frames, labels):
        logits = seg_forward(cfg, p, frames.double())
        lab = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
        return (torch.logsumexp(logits, dim=-1) - lab).mean()

    def loss_and_grad(params, frames, labels):
        g, value = torch.func.grad_and_value(loss)(
            tree.tree_map(torch.Tensor.double, params), frames, labels)
        return value.float(), tree.tree_map(torch.Tensor.float, g)
    return loss_and_grad


def _np(t):
    return jax.tree.map(np.asarray, t)


def _with_loss(fns, lg):
    """A `_compiled_fns`/`_seg_fns` stand-in: the world's own predict and
    accuracy, ``lg`` for its loss and gradient (one callable for every
    world, so the sessions still group)."""
    return lambda cfg: (lg, *fns(cfg)[1:])


def _jax_run(float64: bool):
    pre = j_make_student(J_SEG, jax.random.PRNGKey(0))
    masks = []
    draw = jsel.random_mask

    def recording(*args, **kw):
        m = draw(*args, **kw)
        masks.append(_np(m))
        return m

    x64 = jax.enable_x64(True) if float64 else contextlib.nullcontext()
    with pytest.MonkeyPatch.context() as mp, x64:
        mp.setattr(jsel, "random_mask", recording)
        pin_loop(mp)
        if float64:
            mp.setattr(jworld, "_compiled_fns", _with_loss(
                jworld._compiled_fns, _j_loss_and_grad64(J_SEG)))
        info0, snap = jbatched.update_pipeline_info(), jtiming.snapshot()
        r = jmc.run_multiclient(N_CLIENTS, pre, J_SEG, JAMSConfig(**AMS_KW),
                                **RUN_KW)
        info = {k: v - info0[k] for k, v in jbatched.update_pipeline_info().items()}
        stats = jtiming.delta(snap)
    return r, masks, _np(pre), info, stats


def pin_loop(mp):
    """Pin the JAX package's fused phase to its loop shape, the port's.
    Its default races loop against scan on the wall clock, and the two
    agree only to float32 tolerance, so the reference would depend on
    which won."""
    mp.setattr(jbatched, "_EXEC_MODE", "loop")


def _replaying(masks):
    it = iter(masks)

    def random_mask(gen, params, frac):
        assert isinstance(gen, torch.Generator)
        return params_from_numpy(next(it), tree.leaves(params)[0].device)

    return random_mask, it


def _port_run(float64: bool, masks, p0):
    replay, left = _replaying(masks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsel, "random_mask", replay)
        if float64:
            mp.setattr(tworld, "_seg_fns", _with_loss(
                tworld._seg_fns, _t_loss_and_grad64(T_SEG)))
        info0, snap = tbatched.update_pipeline_info(), ttiming.snapshot()
        r = tmc.run_multiclient(N_CLIENTS, params_from_numpy(p0, "cpu"), T_SEG,
                                AMSConfig(**AMS_KW), **RUN_KW)
        info = {k: v - info0[k] for k, v in tbatched.update_pipeline_info().items()}
        stats = ttiming.delta(snap)
    assert next(left, None) is None, "the port drew fewer random masks"
    return r, info, stats


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    cache = {}

    def get(float64: bool):
        if float64 not in cache:
            j, masks, p0, j_info, j_stats = _jax_run(float64)
            t, t_info, t_stats = _port_run(float64, masks, p0)
            cache[float64] = dict(j=j, t=t, j_info=j_info, t_info=t_info,
                                  j_stats=j_stats, t_stats=t_stats,
                                  n_masks=len(masks))
        return cache[float64]

    return get


def _schedule(r):
    return {k: v for k, v in r.items() if k not in WALL + ACCURACY}


def test_float64_schedule_and_bytes_exact(runs):
    got = runs(True)
    j, t = got["j"], got["t"]
    assert got["n_masks"] == N_CLIENTS  # each session's first phase
    assert t["fused_launches"] > 0 and t["rider_grants"] > 0
    assert _schedule(t) == _schedule(j)
    assert abs(t["mean_miou"] - j["mean_miou"]) <= 1e-3, (t["mean_miou"],
                                                          j["mean_miou"])
    assert np.allclose(t["miou_per_client"], j["miou_per_client"], atol=2e-3)


def test_update_pipeline_and_stage_timings_agree(runs):
    got = runs(True)
    assert got["t_info"] == got["j_info"]
    assert got["t_info"]["stacked_select_launches"] > 0
    assert got["t_info"]["stacked_encode_sessions"] >= 2

    def counted(stats):
        return {k: (v["calls"], v["nbytes"]) for k, v in stats.items()}

    assert counted(got["t_stats"]) == counted(got["j_stats"])
    stages = {stage for stage, _ in got["t_stats"]}
    assert {"train_fused", "select_stacked", "encode_stacked"} <= stages
    # the engine's own report covers the same stages, priced by the model
    obs = got["t"]["observability"]
    assert set(obs["stage_timings"]) == stages
    assert obs["drift"]["train_fused"]["modeled_steady_s"] >= 0.0


def test_edge_moves_only_through_apply_delta():
    pre = params_from_numpy(_j_init(), "cpu")
    sessions = tmc.build_sessions(2, pre, T_SEG, AMSConfig(**AMS_KW),
                                  duration=20.0, video_kw=VIDEO_KW)
    ptrs = {l.data_ptr() for l in tree.leaves(pre)}
    for s in sessions:
        ptrs_edge = {l.data_ptr() for l in tree.leaves(s.edge.active)}
        ptrs_srv = {l.data_ptr() for l in tree.leaves(s.session.params)}
        assert not (ptrs_edge & ptrs) and not (ptrs_edge & ptrs_srv)
        assert not (ptrs_srv & ptrs)
        s.label_and_ingest(list(range(8)), 4.0)
    before = [tree.tree_map(torch.clone, s.edge.active) for s in sessions]
    # an in-place write on the server side must not reach the edge
    with torch.no_grad():
        for l in tree.leaves(sessions[0].session.params):
            l.add_(1.0)
    deltas = train_many(sessions, 4.0)
    for s, b in zip(sessions, before):
        for x, y in zip(tree.leaves(s.edge.active), tree.leaves(b)):
            assert torch.equal(x, y)
    for s, d, b in zip(sessions, deltas, before):
        s.apply_delta(d, 4.0, 5.0)
        moved = [not torch.equal(x, y) for x, y in
                 zip(tree.leaves(s.edge.active), tree.leaves(b))]
        assert any(moved)
        assert s.phases == 1 and s.delta_latencies == [1.0]


def _sessions(pkg, n, p0, float64):
    """``n`` sessions of ``pkg`` with 6 labeled frames each (the JAX
    package's `tests/test_update_pipeline.py` helper, at this file's
    shapes), from init ``p0``."""
    if pkg == "jax":
        from repro.core.server import AMSSession as S
        from repro.core.server import Task as T
        from repro.data.video import VideoConfig as V
        world_mod, seg, cfg = jworld, J_SEG, JAMSConfig(**AMS_KW)
        params = lambda: jax.tree.map(jnp.asarray, p0)  # noqa: E731
        lg = _j_loss_and_grad64(J_SEG) if float64 else None
    else:
        S, T, V = AMSSession, Task, VideoConfig
        world_mod, seg, cfg = tworld, T_SEG, AMSConfig(**AMS_KW)
        params = lambda: params_from_numpy(p0, "cpu")  # noqa: E731
        lg = _t_loss_and_grad64(T_SEG) if float64 else None
    out = []
    for i in range(n):
        world = world_mod.SegWorld.make(
            V(seed=100 + i, duration=20.0, **VIDEO_KW), seg)
        task = T(loss_and_grad=lg or world.loss_and_grad, teacher=None,
                 phi_loss=world_mod.phi_pixel_loss)
        s = S(task, cfg, params(), seed=i)
        frames = np.stack([world.video.frame(j)[0] for j in range(6)])
        labels = np.stack([world.teacher.label(j) for j in range(6)])
        s.receive_labeled(frames, labels, 5.0)
        out.append(s)
    return out


def _ulps(a16: np.ndarray, b16: np.ndarray) -> np.ndarray:
    """Elementwise distance in fp16 units in the last place (on the
    ordered integer view of the bit patterns, so across zero too)."""
    def key(x):
        i = x.view(np.int16).astype(np.int32)
        return np.where(i < 0, -32768 - i, i)
    return np.abs(key(a16) - key(b16))


def _j_init():
    return _np(j_make_student(J_SEG, jax.random.PRNGKey(0)))


def test_force_stack_takes_one_session_through_the_stacked_path():
    """B = 1 with ``force_stack=True`` runs the stacked lifecycle (one
    stacked selection and encode, stage keys at B = 1); without it, the
    fused entry point's singleton is bitwise the session's own
    ``train_phase`` across two phases (the second one's selection
    deferred), as in the JAX package."""
    p0 = _j_init()
    tbatched.update_pipeline_reset()
    snap = ttiming.snapshot()
    [s] = _sessions("torch", 1, p0, False)
    for t in (6.0, 14.0):
        tbatched.train_phases_fused([s], t, force_stack=True)
    stats = ttiming.delta(snap)
    assert tbatched.update_pipeline_info() == {
        "stacked_select_launches": 1, "stacked_select_sessions": 1,
        "stacked_encode_launches": 2, "stacked_encode_sessions": 2}
    assert stats[("train_fused", (1, AMS_KW["k_iters"]))]["calls"] == 2
    assert stats[("select_stacked", (1,))]["calls"] == 1
    assert stats[("encode_stacked", (1,))]["calls"] == 2
    assert ("select_solo", ()) not in stats
    [a] = _sessions("torch", 1, p0, False)
    [b] = _sessions("torch", 1, p0, False)
    for t in (6.0, 14.0):
        da = a.train_phase(t)
        [db] = tbatched.train_phases_fused([b], t)
        assert np.array_equal(da.values, db.values)
        assert da.packed_mask == db.packed_mask
    for x, y in zip(tree.leaves(a.params), tree.leaves(b.params)):
        assert torch.equal(x, y)


def test_device_argument_places_the_group_and_commits_back():
    """``device=`` moves a stacked group's lifecycle onto that device and
    commits each session's state back to its own: on this host the CPU,
    where the result must equal the unplaced run bit for bit."""
    p0 = _j_init()
    outs = []
    for device in (None, torch.device("cpu")):
        ss = _sessions("torch", 2, p0, False)
        deltas = [tbatched.train_phases_fused(ss, t, device=device)
                  for t in (6.0, 14.0)]
        assert all(l.device == s.device for s in ss
                   for l in tree.leaves((s.params, s.opt_state, s.u_prev)))
        outs.append((deltas, ss))
    (da, sa), (db, sb) = outs
    for x, y in zip(sum(da, []), sum(db, [])):
        assert x.packed_mask == y.packed_mask
        assert np.array_equal(x.values, y.values)
    for a, b in zip(sa, sb):
        for x, y in zip(tree.leaves(a.params), tree.leaves(b.params)):
            assert torch.equal(x, y)
