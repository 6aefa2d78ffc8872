"""Port parity for the host-side modules copied from the JAX package:
frames, teacher labels, mIoU, replay picks and the ASR/ATR controllers
must be identical for the same seeds and inputs (exact comparison)."""
import numpy as np
import pytest

from repro.core.atr import ATRController as JATR
from repro.core.buffer import ReplayBuffer as JBuffer
from repro.core.sampler import ASRController as JASR
from repro.data.video import OracleTeacher as JTeacher
from repro.data.video import SyntheticVideo as JVideo
from repro.data.video import VideoConfig as JVideoConfig
from repro.data.video import stop_and_go as j_stop_and_go
from repro.metrics.miou import confusion as j_confusion
from repro.metrics.miou import miou as j_miou
from repro.sim.seg_world import phi_pixel_loss as j_phi
from repro_torch.core.atr import ATRController
from repro_torch.core.buffer import ReplayBuffer
from repro_torch.core.sampler import ASRController
from repro_torch.data.video import OracleTeacher, SyntheticVideo, VideoConfig, stop_and_go
from repro_torch.metrics.miou import confusion, miou
from repro_torch.sim.seg_world import phi_pixel_loss


@pytest.mark.parametrize("kw", [
    dict(seed=5, height=24, width=24),
    dict(seed=7, height=25, width=33, cut_period=3.0),
    dict(seed=2, height=24, width=24, motion="stop_and_go"),
])
def test_frames_and_labels_identical(kw):
    kw = dict(kw)
    motion = kw.pop("motion", None)
    jv = JVideo(JVideoConfig(
        motion_schedule=j_stop_and_go(1.0, 3.0) if motion else None, **kw))
    tv = SyntheticVideo(VideoConfig(
        motion_schedule=stop_and_go(1.0, 3.0) if motion else None, **kw))
    jt, tt = JTeacher(jv, error_rate=0.05), OracleTeacher(tv, error_rate=0.05)
    for idx in (0, 7, 31, 64):
        (fj, mj), (ft, mt) = jv.frame(idx), tv.frame(idx)
        assert fj.dtype == ft.dtype and np.array_equal(fj, ft)
        assert np.array_equal(mj, mt)
        assert np.array_equal(jt.label(idx), tt.label(idx))


def test_miou_and_confusion_identical():
    rng = np.random.default_rng(0)
    for n in (2, 5):
        a = rng.integers(0, n, size=(25, 24))
        b = rng.integers(0, n, size=(25, 24))
        assert np.array_equal(j_confusion(a, b, n), confusion(a, b, n))
        assert j_miou(a, b, n) == miou(a, b, n)
    assert j_phi(a, b) == phi_pixel_loss(a, b)


def test_replay_picks_identical():
    jb, tb = JBuffer(horizon=30.0), ReplayBuffer(horizon=30.0)
    rng = np.random.default_rng(1)
    for t in range(0, 120, 3):
        frame = rng.uniform(size=(4, 4, 3)).astype(np.float32)
        label = rng.integers(0, 5, size=(4, 4))
        jb.add(frame, label, float(t))
        tb.add(frame, label, float(t))
    assert len(jb) == len(tb)
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    for t_now in (100.0, 117.0, 400.0):
        a, b = jb.sample(jr, 5, t_now), tb.sample(tr, 5, t_now)
        if a is None:
            assert b is None
            continue
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_asr_and_atr_identical():
    ja, ta = JASR(phi_target=0.2), ASRController(phi_target=0.2)
    jt, tt = JATR(), ATRController()
    rng = np.random.default_rng(2)
    for step in range(60):
        phi = float(rng.uniform(0.0, 0.6 if step < 30 else 0.05))
        ja.observe(phi)
        ta.observe(phi)
        t_now = 2.5 * step
        assert ja.maybe_update(t_now) == ta.maybe_update(t_now)
        assert ja.phi_ema == ta.phi_ema
        assert jt.update(ja.rate) == tt.update(ta.rate)
        assert jt.slowdown == tt.slowdown
