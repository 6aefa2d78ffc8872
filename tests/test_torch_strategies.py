"""Port parity for the Table-3 selection strategies (`selection.make_mask`),
momentum SGD (`masked_adam.momentum_update`), the sessions and the fused
phase that use them, and the byte-cost models (`data/codec.py`,
`core/bandwidth.py`), against the JAX package on the CPU.

* `momentum_update` on float32 and bfloat16 trees, masked and not: p,
  velocity and u equal to the JAX package's bit for bit. Both run the
  same elementwise operations one by one (XLA's eager dispatch fuses
  nothing, so nothing is contracted into an FMA).
* The positional masks (first, last, first_last) and full: byte-identical
  on the width-1.0 and width-4.0 students' trees at γ ∈ {0.01, 0.05, 0.5}.
* One session through 2 sequential phases per (strategy, optimizer), and
  3 sessions through 3 fused phases with momentum SGD and the ``last``
  strategy, from the same init and with float64 gradients in both
  packages (ROADMAP F5; the random masks replayed from the JAX run, F4):
  every wire mask byte-identical, every fp16 value within 1 ULP, every
  loss within rtol 1e-6. The forward, the cross-entropy and the backward
  run in float64 (the students' own `seg_loss` takes its cross-entropy
  in float32); cast to float32 for the optimizer. With the float32
  cross-entropy, the ``full`` strategy under momentum SGD put fp16
  values up to 80 ULPs apart in its second phase: every coordinate moves
  by lr * g, and the rounding of the two packages' log-sum-exp reaches
  the gradients at a random init, where they are ill-conditioned. With
  it in float64, momentum SGD measured 0 ULPs and Adam at most 1.
* The codec and the ledger: equal on a grid of inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as jbatched
from repro.core import bandwidth as jbandwidth
from repro.core import masked_adam as jma
from repro.core import selection as jsel
from repro.core.server import AMSConfig as JAMSConfig
from repro.core.server import AMSSession as JAMSSession
from repro.core.server import Task as JTask
from repro.data import codec as jcodec
from repro.data.video import VideoConfig
from repro.models.seg.student import SegConfig as JSegConfig
from repro.models.seg.student import make_student as j_make_student
from repro.models.seg.student import seg_forward as j_seg_forward
from repro.sim.seg_world import SegWorld as JSegWorld
from repro.sim.seg_world import phi_pixel_loss
from repro_torch import tree
from repro_torch.core import bandwidth as tbandwidth
from repro_torch.core import batched
from repro_torch.core import masked_adam as tma
from repro_torch.core import selection as tsel
from repro_torch.core.server import AMSConfig, AMSSession, Task
from repro_torch.data import codec as tcodec
from repro_torch.models.seg.student import (SegConfig, make_student, params_from_numpy,
                                            seg_forward)

J_SEG = JSegConfig(n_classes=5)
T_SEG = SegConfig(**dataclasses.asdict(J_SEG))
AMS_KW = dict(t_update=8.0, t_horizon=30.0, k_iters=3, batch_size=2, gamma=0.05,
              lr=2e-3, phi_target=0.15)
FEED = [(range(0, 6), 5.0, 6.0), (range(6, 10), 13.0, 14.0),
        (range(10, 14), 21.0, 22.0)]  # (frames, t_feed, t_train) per phase


def _np(t):
    return jax.tree.map(np.asarray, t)


def _random_tree(rng, dtype=np.float32):
    return {"a": rng.normal(size=(7, 5)).astype(dtype),
            "b": {"c": rng.normal(size=(301,)).astype(dtype),
                  "d": rng.normal(size=(3, 4, 2)).astype(dtype)}}


def _to_jax(t, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), t)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_momentum_update_bitwise(masked, dtype):
    rng = np.random.default_rng(3)
    p = _random_tree(rng)
    jp = _to_jax(p, jnp.dtype(dtype))
    tp = params_from_numpy(_np(jp), "cpu")
    j_state, t_state = jma.init_momentum(jp), tma.init_momentum(tp)
    for step in range(3):
        g = _random_tree(rng)
        g = jax.tree.map(lambda a, s=step: a * 10.0 ** -(s + 1), g)
        jg = _to_jax(g, jnp.dtype(dtype))
        tg = params_from_numpy(_np(jg), "cpu")
        jm = tm = None
        if masked:
            m = jax.tree.map(lambda a: rng.random(a.shape) < 0.3, p)
            jm, tm = _to_jax(m), params_from_numpy(m, "cpu")
        jp, j_state, ju = jma.momentum_update(jp, jg, j_state, jm, lr=2e-3,
                                              momentum=0.9)
        tp, t_state, tu = tma.momentum_update(tp, tg, t_state, tm, lr=2e-3,
                                              momentum=0.9)
        for a, b in zip(jax.tree.leaves((jp, j_state.velocity, ju)),
                        tree.leaves((tp, t_state.velocity, tu))):
            a = np.asarray(a)
            b = b.float().numpy() if b.dtype == torch.bfloat16 else b.numpy()
            a = a.astype(np.float32)
            assert a.shape == b.shape
            assert np.array_equal(a.view(np.int32), b.view(np.int32)), step


@pytest.fixture(scope="module", params=[1.0, 4.0], ids=["width1", "width4"])
def student_trees(request):
    t = make_student(SegConfig(n_classes=5, width=request.param), 0, "cpu")
    return t, _to_jax(tree.tree_map(lambda l: l.numpy(), t))


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.5])
@pytest.mark.parametrize("strategy", ["first", "last", "first_last", "full"])
def test_positional_masks_byte_identical(student_trees, strategy, frac):
    tp, jp = student_trees
    jm = jsel.make_mask(strategy, params=jp, frac=frac)
    tm = tsel.make_mask(strategy, params=tp, frac=frac)
    jl, tl = jax.tree.leaves(jm), tree.leaves(tm)
    assert len(jl) == len(tl) == len(tree.leaves(tp))
    for a, b in zip(jl, tl):
        assert b.dtype == torch.bool
        a = np.asarray(a)
        assert a.dtype == np.bool_ and a.tobytes() == b.numpy().tobytes()
    n = sum(l.numel() for l in tree.leaves(tp))
    want = {"full": n, "first": int(frac * n), "last": int(frac * n),
            "first_last": 2 * int(frac / 2 * n)}[strategy]  # halves never meet
    assert sum(int(l.sum()) for l in tl) == want
    assert tsel.mask_fraction(tm) == pytest.approx(jsel.mask_fraction(jm))


def test_make_mask_random_and_errors():
    p = params_from_numpy(_random_tree(np.random.default_rng(0)), "cpu")
    a = tsel.make_mask("random", params=p, frac=0.3, rng=torch.Generator().manual_seed(4))
    b = tsel.make_mask("random", params=p, frac=0.3, rng=torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) and x.dtype == torch.bool
               for x, y in zip(tree.leaves(a), tree.leaves(b)))
    assert 0.2 < tsel.mask_fraction(a) < 0.4
    u = tree.tree_map(torch.abs, p)
    g = tsel.make_mask("gradient_guided", u_prev=u, frac=0.1)
    assert all(torch.equal(x, y) for x, y in zip(
        tree.leaves(g), tree.leaves(tsel.gradient_guided_mask(u, 0.1))))
    with pytest.raises(ValueError):
        tsel.make_mask("gradient_guided", params=p, frac=0.1)
    with pytest.raises(ValueError):
        tsel.make_mask("random", params=p, frac=0.1)
    with pytest.raises(ValueError):
        tsel.make_mask("nope", params=p, frac=0.1)


def test_codec_and_bandwidth_match():
    for n_pixels in (1, 1024, 32 * 32, 256 * 256, 1024 * 512, 1920 * 1080):
        for q in (0.5, 1.0, 1.7):
            assert tcodec.jpeg_bytes(n_pixels, q) == jcodec.jpeg_bytes(n_pixels, q)
        for n in (0, 1, 2, 5, 40):
            for t_update in (0.5, 10.0, 60.0):
                assert (tcodec.h264_buffer_bytes(n, n_pixels, t_update)
                        == jcodec.h264_buffer_bytes(n, n_pixels, t_update))
    jl, tl = jbandwidth.BandwidthLedger(), tbandwidth.BandwidthLedger()
    for i, (nbytes, what) in enumerate([(100, "frames"), (3.7, "jpeg"), (0, "x")]):
        for ledger in (jl, tl):
            ledger.uplink(nbytes, float(i), what)
            ledger.downlink(2 * nbytes + 1, i + 0.5)
    assert tl.events == jl.events and tl.up_bytes == jl.up_bytes
    for duration in (-1.0, 0.0, 1.0, 40.0):
        assert tl.kbps(duration) == jl.kbps(duration)


# ---------------------------------------------------------------------------
# sessions and the fused phase, float64 gradients
# ---------------------------------------------------------------------------


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


def _t_loss_and_grad64():
    """The same in the port."""
    def loss(p, frames, labels):
        logits = seg_forward(T_SEG, p, frames.double())
        lab = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
        return (torch.logsumexp(logits, dim=-1) - lab).mean()

    def loss_and_grad(params, frames, labels):
        g, value = torch.func.grad_and_value(loss)(
            tree.tree_map(torch.Tensor.double, params), frames, labels)
        return value.float(), tree.tree_map(torch.Tensor.float, g)
    return loss_and_grad


def _worlds(n):
    return [JSegWorld.make(VideoConfig(seed=100 + i, height=24, width=24, fps=2.0,
                                       duration=20.0), J_SEG) for i in range(n)]


def _feed(sessions, worlds, phase):
    frames, t_feed, _ = FEED[phase]
    for s, w in zip(sessions, worlds):
        f = np.stack([w.video.frame(j)[0] for j in frames])
        lab = np.stack([w.teacher.label(j) for j in frames])
        s.receive_labeled(f, lab, t_feed)


def _ulps(a16, b16):
    def key(x):
        i = x.view(np.int16).astype(np.int32)
        return np.where(i < 0, -32768 - i, i)
    return np.abs(key(a16) - key(b16))


def _run_both(n, phases, train, **cfg_kw):
    """n sessions of each package through ``phases`` phases of ``train``
    (a function of the package's sessions and t_now returning deltas),
    from the JAX init, the port replaying the JAX run's random masks."""
    worlds = _worlds(n)
    p0 = j_make_student(J_SEG, jax.random.PRNGKey(0))
    masks, draw = [], jsel.random_mask

    def recording(*a, **k):
        m = draw(*a, **k)
        masks.append(_np(m))
        return m

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jsel, "random_mask", recording)
        js = [JAMSSession(JTask(_j_loss_and_grad64, None, phi_pixel_loss),
                          JAMSConfig(**AMS_KW, **cfg_kw), p0, seed=i) for i in range(n)]
        j_out = []
        for phase in range(phases):
            _feed(js, worlds, phase)
            j_out.append((train[0](js, FEED[phase][2]),
                          [s.history[-1]["loss"] for s in js]))
    it = iter(masks)
    lg = _t_loss_and_grad64()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsel, "random_mask",
                   lambda gen, params, frac: params_from_numpy(next(it), "cpu"))
        ts = [AMSSession(Task(lg, None, phi_pixel_loss), AMSConfig(**AMS_KW, **cfg_kw),
                         params_from_numpy(_np(p0), "cpu"), seed=i) for i in range(n)]
        t_out = []
        for phase in range(phases):
            _feed(ts, worlds, phase)
            t_out.append((train[1](ts, FEED[phase][2]),
                          [s.history[-1]["loss"] for s in ts]))
    assert next(it, None) is None, "the port drew fewer random masks"
    return j_out, t_out, ts


def _assert_same_deltas(j_out, t_out):
    for phase, ((jd, jl), (td, tl)) in enumerate(zip(j_out, t_out)):
        for i, (a, b) in enumerate(zip(jd, td)):
            assert b.packed_mask == a.packed_mask, (phase, i)
            assert b.values.dtype == a.values.dtype == np.float16
            assert _ulps(b.values, a.values).max() <= 1, (phase, i)
        np.testing.assert_allclose(tl, jl, rtol=1e-6)


@pytest.mark.parametrize("strategy,optimizer", [
    ("gradient_guided", "momentum"), ("random", "adam"), ("first", "momentum"),
    ("first_last", "adam"), ("full", "momentum")])
def test_sequential_session_strategies(strategy, optimizer):
    torch.set_num_threads(1)
    train = (lambda ss, t: [s.train_phase(t) for s in ss],) * 2
    j_out, t_out, ts = _run_both(1, 2, train, strategy=strategy, optimizer=optimizer)
    _assert_same_deltas(j_out, t_out)
    state = ts[0].opt_state
    assert isinstance(state, tma.MomentumState if optimizer == "momentum"
                      else tma.MaskedAdamState)


def test_fused_momentum_last_group():
    """3 sessions with momentum SGD and the ``last`` strategy through the
    fused phase (one group: the grouping key includes the optimizer and
    the strategy) against the JAX package's fused phase."""
    torch.set_num_threads(1)
    train = (jbatched.train_phases_fused, batched.train_phases_fused)
    j_out, t_out, ts = _run_both(3, 3, train, strategy="last", optimizer="momentum")
    _assert_same_deltas(j_out, t_out)
    keys = {batched._group_key(s, s._select_mask_or_defer(), np.zeros((3, 2, 24, 24, 3)),
                               np.zeros((3, 2, 24, 24), np.int32)) for s in ts}
    assert len(keys) == 1
    assert all(isinstance(s.opt_state, tma.MomentumState) for s in ts)
