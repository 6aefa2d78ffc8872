"""Procedural video streams with exact ground-truth segmentation.

Replaces the paper's YouTube/Cityscapes footage (unavailable offline) with a
controllable generator (DESIGN.md §5): moving shapes over a drifting textured
background. Two properties matter for reproducing the paper's phenomena:

  * **temporal coherence** — objects move smoothly, so a student trained on
    the recent horizon generalizes to the near future;
  * **distribution drift** — the color palette and background slowly rotate,
    so a model customized once (One-Time) degrades, while continual
    adaptation (AMS) tracks; the drift rate is the scene-dynamics knob.

`motion_schedule` modulates object speed over time (e.g. a stop/go profile
reproduces the Fig. 3 traffic-light ASR behaviour).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np


@dataclass(frozen=True)
class VideoConfig:
    height: int = 64
    width: int = 64
    fps: float = 10.0
    duration: float = 300.0  # seconds
    n_classes: int = 5  # incl. background = class 0
    n_objects: int = 7
    base_speed: float = 10.0  # px/sec
    drift_period: float = 240.0  # seconds for a full palette rotation
    cut_period: float = 0.0  # >0: palette jumps (scene cuts) every P seconds
    texture_scale: float = 8.0
    seed: int = 0
    motion_schedule: Callable[[float], float] | None = None  # t -> speed mult

    @property
    def n_frames(self) -> int:
        return int(self.duration * self.fps)


class SyntheticVideo:
    """Deterministic function of (config, frame index)."""

    def __init__(self, cfg: VideoConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        n = cfg.n_objects
        self.cls = rng.integers(1, cfg.n_classes, size=n)
        self.cx0 = rng.uniform(0, cfg.width, size=n)
        self.cy0 = rng.uniform(0, cfg.height, size=n)
        self.phase = rng.uniform(0, 2 * math.pi, size=n)
        self.omega = rng.uniform(0.2, 1.0, size=n)  # direction wobble
        self.radius = rng.uniform(0.09, 0.22, size=n) * min(cfg.height, cfg.width)
        self.shape = rng.integers(0, 2, size=n)  # 0=disk, 1=square
        self.tex_phase = rng.uniform(0, 2 * math.pi, size=4)
        yy, xx = np.mgrid[0 : cfg.height, 0 : cfg.width]
        self.yy, self.xx = yy.astype(np.float32), xx.astype(np.float32)
        # per-class base hue anchors (palette drifts around these)
        self.class_hue = np.linspace(0.0, 1.0, cfg.n_classes, endpoint=False)

    # -- motion ----------------------------------------------------------
    def _speed_mult(self, t: float) -> float:
        ms = self.cfg.motion_schedule
        return float(ms(t)) if ms is not None else 1.0

    def _integrated_motion(self, t: float) -> float:
        """∫ speed_mult dt, evaluated cheaply (piecewise-constant per 0.5s)."""
        if self.cfg.motion_schedule is None:
            return t
        steps = int(t / 0.5)
        acc = sum(self._speed_mult(i * 0.5) for i in range(steps)) * 0.5
        return acc + self._speed_mult(steps * 0.5) * (t - steps * 0.5)

    def _positions(self, t: float):
        """Bounded orbits: position change rate is proportional to the
        *instantaneous* speed (a frozen schedule freezes the scene exactly —
        no lever-arm growth with accumulated path length)."""
        cfg = self.cfg
        s = self.cfg.base_speed * self._integrated_motion(t)
        r_orbit = 0.45 * min(cfg.height, cfg.width)
        ang = self.phase + self.omega * (s / r_orbit) * 4.0
        cx = (self.cx0 + r_orbit * np.cos(ang)) % cfg.width
        cy = (self.cy0 + r_orbit * np.sin(ang)) % cfg.height
        return cx, cy

    # -- appearance --------------------------------------------------------
    def _cut_phase(self, t: float) -> float:
        if self.cfg.cut_period <= 0:
            return 0.0
        return 0.35 * (int(t / self.cfg.cut_period) % 2)  # A/B palette jumps

    def _palette(self, t: float) -> np.ndarray:
        """(n_classes, 3) RGB; hue rotates with the drift period (plus scene
        cuts when cut_period > 0 — the fast-scene-change regime)."""
        drift = (t / self.cfg.drift_period + self._cut_phase(t)) % 1.0
        hues = (self.class_hue + drift) % 1.0
        # cheap HSV->RGB at s=0.75, v=0.9
        h6 = hues * 6.0
        i = np.floor(h6).astype(int) % 6
        f = h6 - np.floor(h6)
        v, s = 0.9, 0.75
        p, q, u = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
        table = np.stack(
            [
                np.stack([np.full_like(f, v), u, np.full_like(f, p)], -1),
                np.stack([q, np.full_like(f, v), np.full_like(f, p)], -1),
                np.stack([np.full_like(f, p), np.full_like(f, v), u], -1),
                np.stack([np.full_like(f, p), q, np.full_like(f, v)], -1),
                np.stack([u, np.full_like(f, p), np.full_like(f, v)], -1),
                np.stack([np.full_like(f, v), np.full_like(f, p), q], -1),
            ],
            0,
        )
        return table[i, np.arange(len(hues))]

    def _background(self, t: float) -> np.ndarray:
        cfg = self.cfg
        drift = 2 * math.pi * (t / cfg.drift_period + self._cut_phase(t))
        k = 2 * math.pi / cfg.texture_scale
        tex = (
            np.sin(k * self.xx + self.tex_phase[0] + drift)
            + np.sin(k * self.yy + self.tex_phase[1] - 0.7 * drift)
            + 0.5 * np.sin(k * (self.xx + self.yy) / 1.4 + self.tex_phase[2] + 0.3 * drift)
        ) / 2.5
        base = self._palette(t)[0]
        img = base[None, None, :] * (0.6 + 0.4 * tex[..., None])
        return img.astype(np.float32)

    # -- frame -------------------------------------------------------------
    def frame(self, idx: int):
        """Returns (img (H,W,3) float32 in [0,1], mask (H,W) int32)."""
        cfg = self.cfg
        t = idx / cfg.fps
        img = self._background(t)
        mask = np.zeros((cfg.height, cfg.width), np.int32)
        pal = self._palette(t)
        cx, cy = self._positions(t)
        order = np.argsort(self.radius)  # big shapes first, small on top
        for j in order[::-1]:
            if self.shape[j] == 0:
                inside = (self.xx - cx[j]) ** 2 + (self.yy - cy[j]) ** 2 <= self.radius[j] ** 2
            else:
                inside = (np.abs(self.xx - cx[j]) <= self.radius[j]) & (
                    np.abs(self.yy - cy[j]) <= self.radius[j]
                )
            c = int(self.cls[j])
            shade = 0.75 + 0.25 * math.sin(0.13 * t + j)
            img[inside] = pal[c] * shade
            mask[inside] = c
        noise = np.random.default_rng(cfg.seed * 100003 + idx).normal(
            0.0, 0.02, size=img.shape
        )
        return np.clip(img + noise, 0.0, 1.0).astype(np.float32), mask

    def frames(self, start: int = 0, stop: int | None = None, stride: int = 1):
        stop = stop if stop is not None else self.cfg.n_frames
        for i in range(start, stop, stride):
            yield i, *self.frame(i)


def stop_and_go(stop_at: float, go_at: float) -> Callable[[float], float]:
    """Fig.-3-style motion schedule: full speed, halt, resume."""

    def sched(t: float) -> float:
        return 0.02 if stop_at <= t < go_at else 1.0

    return sched


class OracleTeacher:
    """Stochastic oracle standing in for the paper's DeeplabV3-Xception65
    teacher (DESIGN.md §5): ground truth + controlled, temporally-consistent
    corruption (boundary erosion + patch flips) at a target error rate."""

    def __init__(self, video: SyntheticVideo, error_rate: float = 0.04, seed: int = 1):
        self.video = video
        self.error_rate = error_rate
        self.seed = seed

    def label(self, idx: int) -> np.ndarray:
        _, mask = self.video.frame(idx)
        rng = np.random.default_rng(self.seed * 7919 + idx // 8)  # consistent over ~8 frames
        out = mask.copy()
        h, w = mask.shape
        n_patches = int(self.error_rate * h * w / 25)
        for _ in range(n_patches):
            y, x = rng.integers(0, h - 5), rng.integers(0, w - 5)
            out[y : y + 5, x : x + 5] = rng.integers(0, self.video.cfg.n_classes)
        return out
