"""Binds the AMS core to the segmentation world (student + oracle teacher)."""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch import tree
from repro_torch.core.masked_adam import adam_update, init_state
from repro_torch.data.video import OracleTeacher, SyntheticVideo, VideoConfig
from repro_torch.device import host_to_device
from repro_torch.models.seg.student import (
    SegConfig,
    make_student,
    seg_loss,
    seg_predict,
)


def phi_pixel_loss(label_now: np.ndarray, label_prev: np.ndarray) -> float:
    """Task loss between consecutive teacher labels (0-1 pixel loss) — the
    φ-score signal for segmentation."""
    return float(np.mean(label_now != label_prev))


@functools.lru_cache(maxsize=None)
def _seg_fns(cfg: SegConfig):
    """One (loss_and_grad, predict, accuracy) triple per SegConfig.

    Module-level on purpose: N worlds with the same config share the SAME
    callables, so `core.batched` can group their phases into one fused
    launch (its grouping key includes the loss callable's identity).

    ``loss_and_grad`` is deterministic on the card: the student's upsample
    is matrix products (`models.seg.student.linear_resize`) and its
    convolutions run under cuDNN's deterministic algorithms, scoped to the
    call (the LLM paths keep the process's settings)."""

    def loss_and_grad(params, frames, labels):
        # deterministic cuDNN convolutions (no atomics in the weight
        # gradients) for this call only, so that two runs of a phase, and
        # its CUDA graph, give the same bits; no process-wide flag changes
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            grads, loss = grad_and_value(
                lambda p: seg_loss(cfg, p, frames, labels))(params)
        return loss, grads

    @torch.no_grad()
    def predict(params, frames):
        return seg_predict(cfg, params, frames)

    @torch.no_grad()
    def accuracy(params, frames, labels):
        pred = seg_predict(cfg, params, frames)
        return (pred == labels).to(torch.float32).mean()

    return loss_and_grad, predict, accuracy


@dataclass
class SegWorld:
    video: SyntheticVideo
    teacher: OracleTeacher
    seg_cfg: SegConfig

    def __post_init__(self):
        self.loss_and_grad, self.predict, self.accuracy = _seg_fns(self.seg_cfg)

    @classmethod
    def make(cls, video_cfg: VideoConfig, seg_cfg: SegConfig | None = None,
             teacher_error: float = 0.04):
        video = SyntheticVideo(video_cfg)
        seg_cfg = seg_cfg or SegConfig(n_classes=video_cfg.n_classes)
        return cls(video=video, teacher=OracleTeacher(video, error_rate=teacher_error),
                   seg_cfg=seg_cfg)


def pretrain_student(seg_cfg: SegConfig, n_videos: int = 6, steps: int = 200,
                     batch: int = 8, lr: float = 2e-3, seed: int = 42,
                     video_kw: dict | None = None, device="cuda"):
    """The "No Customization" checkpoint: train on a generic mixture of
    videos (different seeds/drifts) — analogous to the paper's
    Cityscapes/VOC-pretrained student. The init is
    ``make_student(seg_cfg, seed, device)``; each step is one
    `adam_update` (one masked-Adam kernel launch on the card)."""
    video_kw = video_kw or {}
    videos = [
        SyntheticVideo(VideoConfig(seed=1000 + i, drift_period=120 + 60 * i, **video_kw))
        for i in range(n_videos)
    ]
    teachers = [OracleTeacher(v, error_rate=0.04) for v in videos]
    rng = np.random.default_rng(seed)
    params = make_student(seg_cfg, seed, device)
    dev = tree.leaves(params)[0].device
    opt = init_state(params)
    loss_and_grad = _seg_fns(seg_cfg)[0]
    for _ in range(steps):
        vi = rng.integers(0, n_videos)
        idxs = rng.integers(0, videos[vi].cfg.n_frames, size=batch)
        frames = np.stack([videos[vi].frame(int(i))[0] for i in idxs])
        labels = np.stack([teachers[vi].label(int(i)) for i in idxs])
        _, grads = loss_and_grad(params, host_to_device(frames, dev),
                                 host_to_device(labels, dev))
        params, opt, _ = adam_update(params, grads, opt, lr=lr)
    return params
