"""Binds the AMS core to the segmentation world (student + oracle teacher)."""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch.data.video import OracleTeacher, SyntheticVideo, VideoConfig
from repro_torch.models.seg.student import SegConfig, seg_loss, seg_predict


def phi_pixel_loss(label_now: np.ndarray, label_prev: np.ndarray) -> float:
    """Task loss between consecutive teacher labels (0-1 pixel loss) — the
    φ-score signal for segmentation."""
    return float(np.mean(label_now != label_prev))


@functools.lru_cache(maxsize=None)
def _seg_fns(cfg: SegConfig):
    """One (loss_and_grad, predict) pair per SegConfig.

    Module-level on purpose: N worlds with the same config share the SAME
    callables, so `core.batched` can group their phases into one fused
    launch (its grouping key includes the loss callable's identity)."""

    def loss_and_grad(params, frames, labels):
        grads, loss = grad_and_value(
            lambda p: seg_loss(cfg, p, frames, labels))(params)
        return loss, grads

    @torch.no_grad()
    def predict(params, frames):
        return seg_predict(cfg, params, frames)

    return loss_and_grad, predict


@dataclass
class SegWorld:
    video: SyntheticVideo
    teacher: OracleTeacher
    seg_cfg: SegConfig

    def __post_init__(self):
        self.loss_and_grad, self.predict = _seg_fns(self.seg_cfg)

    @classmethod
    def make(cls, video_cfg: VideoConfig, seg_cfg: SegConfig | None = None,
             teacher_error: float = 0.04):
        video = SyntheticVideo(video_cfg)
        seg_cfg = seg_cfg or SegConfig(n_classes=video_cfg.n_classes)
        return cls(video=video, teacher=OracleTeacher(video, error_rate=teacher_error),
                   seg_cfg=seg_cfg)
