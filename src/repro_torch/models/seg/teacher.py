"""Learned teacher: a wider same-family convnet trained on ground truth.

Used by the teacher-fidelity ablation: AMS's measured quantity is
student-vs-teacher mIoU, so swapping the oracle teacher for a *learned*
model must not change the paper's conclusions.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch import tree
from repro_torch.core.masked_adam import adam_update, init_state
from repro_torch.data.video import SyntheticVideo
from repro_torch.device import host_to_device
from repro_torch.models.seg.student import SegConfig, make_student, seg_loss, seg_predict


def teacher_config(n_classes: int) -> SegConfig:
    return SegConfig(name="seg-teacher", n_classes=n_classes, width=3.0,
                     blocks=((3, 24, 2), (3, 24, 1), (3, 32, 2), (3, 32, 1),
                             (3, 48, 1)))


@dataclass
class ModelTeacher:
    """Same interface as OracleTeacher: label(frame_index) -> (H, W) int.
    The prediction runs on the device of ``params``."""

    video: SyntheticVideo
    cfg: SegConfig
    params: object

    def __post_init__(self):
        self._device = tree.leaves(self.params)[0].device
        self._cache: dict = {}

    @torch.no_grad()
    def _predict(self, params, frames):
        return seg_predict(self.cfg, params, frames)

    def label(self, idx: int) -> np.ndarray:
        if idx not in self._cache:
            img, _ = self.video.frame(idx)
            x = host_to_device(img[None], self._device)
            self._cache[idx] = self._predict(self.params, x)[0].cpu().numpy()
            if len(self._cache) > 512:
                self._cache.pop(next(iter(self._cache)))
        return self._cache[idx]


def train_teacher(video: SyntheticVideo, n_classes: int, steps: int = 400,
                  batch: int = 8, lr: float = 2e-3, seed: int = 7,
                  device="cuda") -> ModelTeacher:
    """Fit the wide teacher on the video's ground truth (the stand-in for
    the paper's Cityscapes-pretrained Xception65). The init is
    ``make_student(teacher_config(n_classes), seed, device)``; each step is
    one `adam_update` (one masked-Adam kernel launch on the card)."""
    cfg = teacher_config(n_classes)
    params = make_student(cfg, seed, device)
    dev = tree.leaves(params)[0].device
    opt = init_state(params)
    rng = np.random.default_rng(seed)

    def loss_and_grad(params, frames, labels):
        grads, loss = grad_and_value(
            lambda p: seg_loss(cfg, p, frames, labels))(params)
        return loss, grads

    for _ in range(steps):
        idxs = rng.integers(0, video.cfg.n_frames, size=batch)
        frames = np.stack([video.frame(int(i))[0] for i in idxs])
        labels = np.stack([video.frame(int(i))[1] for i in idxs])
        _, grads = loss_and_grad(params, host_to_device(frames, dev),
                                 host_to_device(labels, dev))
        params, opt, _ = adam_update(params, grads, opt, lr=lr)
    return ModelTeacher(video=video, cfg=cfg, params=params)
