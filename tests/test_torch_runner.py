"""Port parity for the five streaming schemes (`sim/runner.run_scheme`),
the teacher path of the AMS session (`receive_frames`), the learned
teacher (`models/seg/teacher.py`) and `pretrain_student`, against the JAX
package on the CPU, at the size of `tests/test_sim_schemes.py` (32x32
frames at 2 fps for 40 s, the width-1.0 student, K=3, batch 3,
T_update 5 s; One-Time trains after a 10 s window).

Both packages start from the JAX package's `make_student` init, carried
over with `params_from_numpy`. PRNGs are not portable (ROADMAP F4): every
random mask the JAX run draws through `repro.core.selection.random_mask`
is recorded, and the port's run replays them in order through
`repro_torch.core.selection.random_mask`; the test asserts that the port
drew exactly as many.

* ``no_custom``: no bytes move in either; mean mIoU within 1e-3.
* ``remote_tracking`` is pure numpy: every per-frame mIoU and every
  ledger event are equal exactly. ``one_time``: every ledger event equal.
* ``ams`` and ``jit`` with float64 gradients in both packages (each
  student's forward, cross-entropy and backward in float64, cast to
  float32 for the optimizer; ROADMAP F5): the same
  number of updates, every ledger event equal (so every delta's bytes),
  the AMS history's ASR rates and T_update equal, mean mIoU within 1e-3.
* All five schemes with the real float32 gradients: mean mIoU within
  0.02, and the same number of AMS updates.
* ``pretrain_student`` and ``train_teacher`` (3 Adam steps from the
  injected init, batch 4): the norm of the difference of the two
  packages' params, relative to the norm of the JAX package's change,
  is at most 5e-4 (student) and 0.05 (teacher). Measured on these
  inputs after 1, 2, 3 and 6 steps: 9.8e-5, 8.8e-5, 8.5e-5, 8.0e-4
  (student); 1.6e-3, 1.1e-2, 2.1e-2, 5.2e-2 (teacher). The float32
  gradients of the two packages round differently at random init (F5),
  and Adam's first steps are about lr * sign(g) wherever |g| dwarfs its
  eps, so a coordinate whose gradient flips sign moves 2 lr apart; the
  wider, deeper teacher spreads such coordinates faster.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro.core.server import AMSConfig as JAMSConfig
from repro.core.server import AMSSession as JAMSSession
from repro.core.server import Task as JTask
from repro.data.video import SyntheticVideo as JSyntheticVideo
from repro.data.video import VideoConfig as JVideoConfig
from repro.models.seg import teacher as jteacher
from repro.models.seg.student import SegConfig as JSegConfig
from repro.models.seg.student import make_student as j_make_student
from repro.models.seg.student import seg_forward as j_seg_forward
from repro.sim import runner as jrunner
from repro.sim import seg_world as jworld
from repro_torch import tree
from repro_torch.core import selection as tsel
from repro_torch.core.server import AMSConfig, AMSSession, Task
from repro_torch.data.video import SyntheticVideo, VideoConfig
from repro_torch.models.seg import teacher as tteacher
from repro_torch.models.seg.student import SegConfig, params_from_numpy, seg_forward
from repro_torch.sim import runner as trunner
from repro_torch.sim import seg_world as tworld

J_SEG = JSegConfig(n_classes=5)
VKW = dict(height=32, width=32, fps=2.0, duration=40.0, seed=5, drift_period=30.0)
DURATION = VKW["duration"]
AMS_KW = dict(t_update=5.0, t_horizon=20.0, k_iters=3, batch_size=3, gamma=0.05,
              phi_target=0.04)
SIM_KW = dict(eval_stride=5, jit_max_iters=3, one_time_window=10.0, one_time_iters=5)
SCHEMES = ("no_custom", "one_time", "remote_tracking", "jit", "ams")


@jax.jit
def _j_loss_and_grad64(params, frames, labels):
    """The JAX student's loss (its cross-entropy, here in float64) and
    gradients, all in float64 (x64 mode), returned in float32."""
    def loss(p):
        logits = j_seg_forward(J_SEG, p, frames.astype(jnp.float64))
        lab = jnp.take_along_axis(logits, labels[..., None].astype(jnp.int32), -1)[..., 0]
        return (jax.nn.logsumexp(logits, axis=-1) - lab).mean()
    p64 = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    value, g = jax.value_and_grad(loss)(p64)
    return value.astype(jnp.float32), jax.tree.map(lambda a: a.astype(jnp.float32), g)


def _t_loss_and_grad64(seg_cfg):
    """The same in the port."""
    def loss(p, frames, labels):
        logits = seg_forward(seg_cfg, p, frames.double())
        lab = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
        return (torch.logsumexp(logits, dim=-1) - lab).mean()

    def loss_and_grad(params, frames, labels):
        g, value = torch.func.grad_and_value(loss)(
            tree.tree_map(torch.Tensor.double, params), frames, labels)
        return value.float(), tree.tree_map(torch.Tensor.float, g)
    return loss_and_grad


def _np(t):
    return jax.tree.map(np.asarray, t)


def _jax_run(scheme: str, float64_grads: bool):
    """The JAX package's run, with every random mask it drew."""
    world = jworld.SegWorld.make(JVideoConfig(**VKW), J_SEG)
    pre = j_make_student(J_SEG, jax.random.PRNGKey(0))
    masks = []
    draw = jsel.random_mask

    def recording(*args, **kw):
        m = draw(*args, **kw)
        masks.append(_np(m))
        return m

    x64 = jax.enable_x64(True) if float64_grads else contextlib.nullcontext()
    with pytest.MonkeyPatch.context() as mp, x64:
        mp.setattr(jsel, "random_mask", recording)
        if float64_grads:
            world.loss_and_grad = _j_loss_and_grad64
        r = jrunner.run_scheme(scheme, world, pre, JAMSConfig(**AMS_KW),
                               jrunner.SimConfig(**SIM_KW))
    return r, masks, _np(pre)


def _replaying(masks):
    """A stand-in for the port's `selection.random_mask` that hands out the
    JAX run's masks in order, beside the params."""
    it = iter(masks)

    def random_mask(gen, params, frac):
        assert isinstance(gen, torch.Generator)
        return params_from_numpy(next(it), tree.leaves(params)[0].device)

    return random_mask, it


def _port_run(scheme: str, float64_grads: bool, masks, p0):
    world = tworld.SegWorld.make(VideoConfig(**VKW), SegConfig(**dataclasses.asdict(J_SEG)))
    if float64_grads:
        world.loss_and_grad = _t_loss_and_grad64(world.seg_cfg)
    replay, left = _replaying(masks)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsel, "random_mask", replay)
        r = trunner.run_scheme(scheme, world, params_from_numpy(p0, "cpu"),
                               AMSConfig(**AMS_KW), trunner.SimConfig(**SIM_KW))
    assert next(left, None) is None, "the port drew fewer random masks"
    return r


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    cache = {}

    def get(scheme, float64_grads=False):
        key = (scheme, float64_grads)
        if key not in cache:
            j, masks, p0 = _jax_run(scheme, float64_grads)
            cache[key] = j, _port_run(scheme, float64_grads, masks, p0)
        return cache[key]

    return get


def test_task_fields_line_up():
    """Both packages' Task built positionally: the same fields in the same
    order."""
    a, b, c = object(), object(), object()
    jt, tt = JTask(a, b, c), Task(a, b, c)
    names = [f.name for f in dataclasses.fields(JTask)]
    assert names == [f.name for f in dataclasses.fields(Task)]
    assert names == ["loss_and_grad", "teacher", "phi_loss"]
    for n in names:
        assert getattr(jt, n) is getattr(tt, n)


@pytest.mark.parametrize("pair", [(JAMSConfig, AMSConfig),
                                  (jrunner.SimConfig, trunner.SimConfig)],
                         ids=["AMSConfig", "SimConfig"])
def test_configs_and_schemes_match(pair):
    j, t = pair
    assert ([(f.name, f.default) for f in dataclasses.fields(j)]
            == [(f.name, f.default) for f in dataclasses.fields(t)])
    assert trunner.SCHEMES == jrunner.SCHEMES == SCHEMES


def test_no_custom_moves_nothing(runs):
    j, t = runs("no_custom")
    assert j.ledger.events == t.ledger.events == []
    assert t.updates == j.updates == 0
    assert t.eval_times == j.eval_times
    assert abs(t.mean_miou - j.mean_miou) <= 1e-3, (t.mean_miou, j.mean_miou)


def test_remote_tracking_is_exact(runs):
    j, t = runs("remote_tracking")
    assert len(t.miou_per_frame) > 5
    assert t.miou_per_frame == j.miou_per_frame
    assert t.ledger.events == j.ledger.events
    assert t.bandwidth_kbps(DURATION) == j.bandwidth_kbps(DURATION)
    up, down = t.bandwidth_kbps(DURATION)
    assert up > 0 and down > 0


def test_one_time_ledger_is_exact(runs):
    j, t = runs("one_time")
    assert t.updates == j.updates == 1
    assert t.ledger.events == j.ledger.events
    assert [e[2] for e in t.ledger.events] == ["frames", "full-model"]


@pytest.mark.parametrize("scheme", ["ams", "jit"])
def test_float64_grads_same_updates_and_bytes(runs, scheme):
    j, t = runs(scheme, True)
    assert t.updates == j.updates > 0
    assert t.ledger.events == j.ledger.events
    if scheme == "ams":
        th, jh = t.extras["history"], j.extras["history"]
        assert [(h["t"], h["rate"], h["t_update"], h["bytes"]) for h in th] == \
               [(h["t"], h["rate"], h["t_update"], h["bytes"]) for h in jh]
    assert abs(t.mean_miou - j.mean_miou) <= 1e-3, (t.mean_miou, j.mean_miou)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_float32_grads_mean_miou(runs, scheme):
    j, t = runs(scheme)
    assert 0.0 <= t.mean_miou <= 1.0
    assert len(t.miou_per_frame) == len(j.miou_per_frame)
    assert abs(t.mean_miou - j.mean_miou) <= 0.02, (t.mean_miou, j.mean_miou)
    if scheme == "ams":
        assert t.updates == j.updates > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_relu6_gradient_at_the_kinks_is_jax_clips(dtype):
    """ROADMAP F9: the student's ReLU6 has ``jnp.clip``'s gradient, 0.5 at
    0 and 6 (``torch.clamp``'s is 1), and the same values."""
    from repro_torch.models.seg.student import _ReLU6

    xs = np.array([-7.0, -1e-30, -0.0, 0.0, 1e-30, 3.0, 6.0 - 1e-6, 6.0,
                   6.0 + 1e-6, 9.0], dtype)
    with jax.enable_x64(dtype == "float64"):
        jx = jnp.asarray(xs)
        want_y = np.asarray(jnp.clip(jx, 0.0, 6.0))
        want_g = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 6.0) * 3.0))(jx))
    x = torch.from_numpy(xs.copy()).requires_grad_()
    y = _ReLU6.apply(x)
    (y * 3.0).sum().backward()
    assert np.array_equal(y.detach().numpy(), want_y)
    assert np.array_equal(x.grad.numpy(), want_g), (x.grad, want_g)
    assert want_g[2] == want_g[3] == want_g[7] == 1.5


def test_batch_of_one_gradients_match_reference():
    """At batch 1 (Just-In-Time's) the ASPP context branch sits on ReLU6's
    kink at init: the float64 gradients (cast to float32) agree leaf by
    leaf with the JAX package's, to 1e-6 of each leaf's largest entry, on
    every leaf whose gradient is not rounding noise: 38 of the 47 (the
    others, the biases before a norm and the context branch's scale, are
    0 in exact arithmetic and ~1e-17 here)."""
    video = JSyntheticVideo(JVideoConfig(**VKW))
    img, _ = video.frame(0)
    lab = jworld.OracleTeacher(video).label(0)
    p0 = _np(j_make_student(J_SEG, jax.random.PRNGKey(0)))
    with jax.enable_x64(True):
        _, gj = _j_loss_and_grad64(jax.tree.map(jnp.asarray, p0), img[None], lab[None])
        gj = _np(gj)
    _, gt = _t_loss_and_grad64(SegConfig(**dataclasses.asdict(J_SEG)))(
        params_from_numpy(p0, "cpu"), torch.from_numpy(img[None]),
        torch.from_numpy(lab[None]))
    checked = 0
    for a, b in zip(jax.tree.leaves(gj), tree.leaves(gt)):
        scale = float(np.abs(a).max())
        if scale < 1e-6:  # analytically zero (a bias before a norm): noise
            continue
        assert np.abs(a - b.numpy()).max() <= 1e-6 * scale
        checked += 1
    assert checked == 38
    ctx_bias = np.asarray(gj["aspp"]["ctx"]["bn"]["bias"])
    assert np.abs(ctx_bias).max() > 1e-3


def _label_fn(frames):
    """A deterministic host teacher: brightness bands as classes."""
    return (np.asarray(frames).mean(axis=-1) * 9).astype(np.int32) % 5


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_receive_frames_matches_reference(as_tensor):
    """The same teacher callable in both sessions (the port's also as one
    that returns a tensor): the same buffer, last label and ASR rate after
    every call, an empty call included."""
    video = SyntheticVideo(VideoConfig(**VKW))
    teacher = ((lambda f: torch.from_numpy(_label_fn(f))) if as_tensor
               else _label_fn)
    kw = dict(AMS_KW, phi_target=0.9)  # φ below target: the rate falls
    js = JAMSSession(JTask(None, _label_fn, jworld.phi_pixel_loss),
                     JAMSConfig(**kw), None)
    ts = AMSSession(Task(None, teacher, tworld.phi_pixel_loss),
                    AMSConfig(**kw), {"w": torch.zeros(3)})
    for frames, t_now in ((range(0, 4), 1.0), (range(4, 12), 6.0), ((), 9.0),
                          (range(12, 20), 12.0), (range(20, 22), 40.0)):
        batch = [video.frame(i)[0] for i in frames]
        js.receive_frames(batch, t_now)
        ts.receive_frames(batch, t_now)
        assert ts.buffer.stamps == js.buffer.stamps
        for a, b in zip(ts.buffer.labels + ts.buffer.frames,
                        js.buffer.labels + js.buffer.frames):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(ts.last_label, js.last_label)
        assert ts.asr.rate == js.asr.rate
        assert ts.asr.phi_ema == js.asr.phi_ema
    assert ts.sampling_rate == js.sampling_rate < 1.0


def _rel_diff(t_params, j_params, j_init) -> float:
    """||port - JAX|| / ||JAX - init|| over the whole tree."""
    tl = [l.numpy() for l in tree.leaves(t_params)]
    jl, j0 = jax.tree.leaves(_np(j_params)), jax.tree.leaves(_np(j_init))
    num = np.sqrt(sum(float(np.sum((a - b) ** 2)) for a, b in zip(tl, jl)))
    den = np.sqrt(sum(float(np.sum((b - c) ** 2)) for b, c in zip(jl, j0)))
    return num / den


def _inject_init(mp, module, cfg_j):
    """Make ``module.make_student`` return the JAX package's init."""
    def make_student(cfg, seed=0, device="cuda"):
        assert cfg == SegConfig(**dataclasses.asdict(cfg_j))
        return params_from_numpy(_np(j_make_student(cfg_j, jax.random.PRNGKey(seed))), device)
    mp.setattr(module, "make_student", make_student)


def test_pretrain_student_matches_reference():
    kw = dict(n_videos=2, steps=3, batch=4, lr=2e-3, seed=42,
              video_kw=dict(height=32, width=32, fps=2.0, duration=20.0))
    j = jworld.pretrain_student(J_SEG, **kw)
    with pytest.MonkeyPatch.context() as mp:
        _inject_init(mp, tworld, J_SEG)
        t = tworld.pretrain_student(SegConfig(**dataclasses.asdict(J_SEG)), **kw,
                                    device="cpu")
    err = _rel_diff(t, j, j_make_student(J_SEG, jax.random.PRNGKey(42)))
    assert err <= 5e-4, err


@pytest.fixture(scope="module")
def teachers():
    """The JAX package's learned teacher after 3 steps on a 32x32 video,
    and the port's from the same init and batches."""
    jvideo = JSyntheticVideo(JVideoConfig(**VKW))
    j = jteacher.train_teacher(jvideo, 5, steps=3, batch=4)
    video = SyntheticVideo(VideoConfig(**VKW))
    j_cfg = jteacher.teacher_config(5)
    with pytest.MonkeyPatch.context() as mp:
        _inject_init(mp, tteacher, j_cfg)
        t = tteacher.train_teacher(video, 5, steps=3, batch=4, device="cpu")
    return j, t, j_make_student(j_cfg, jax.random.PRNGKey(7))


def test_train_teacher_matches_reference(teachers):
    j, t, init = teachers
    assert t.cfg == SegConfig(**dataclasses.asdict(j.cfg))
    assert tteacher.teacher_config(5) == t.cfg
    err = _rel_diff(t.params, j.params, init)
    assert err <= 0.05, err


def test_model_teacher_labels_match_reference(teachers):
    """Both teachers from the JAX package's trained params: labels agree
    on at least 99.9% of pixels; the cache keeps at most 512 frames."""
    j, _, _ = teachers
    t = tteacher.ModelTeacher(video=SyntheticVideo(VideoConfig(**VKW)),
                              cfg=SegConfig(**dataclasses.asdict(j.cfg)),
                              params=params_from_numpy(_np(j.params), "cpu"))
    agree = total = 0
    for idx in range(0, 80, 4):
        a, b = t.label(idx), j.label(idx)
        assert a.shape == b.shape == (32, 32)
        agree += int((a == b).sum())
        total += a.size
    assert agree >= 0.999 * total, agree / total
    assert t.label(0) is t.label(0)
    for idx in range(520):
        t.label(idx)
    assert len(t._cache) == 512 and 28 not in t._cache and 32 in t._cache
