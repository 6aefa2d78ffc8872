"""Adaptive frame sampling (ASR, §3.2) and the φ-score.

φ_k = task loss of the teacher's prediction on frame I_k measured against the
teacher's label for I_{k-1} — a label-space scene-change signal. The server
runs an integral controller (Eq. 1):

    r_{t+1} = clip(r_t + η_r (φ̄_t - φ_target), r_min, r_max)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def phi_score(loss_fn, label_prev, label_now) -> float:
    """φ for one consecutive pair of teacher labels; `loss_fn` is the task's
    own loss with (prediction=label_now, target=label_prev)."""
    return float(loss_fn(label_now, label_prev))


@dataclass
class ASRController:
    phi_target: float
    eta: float = 0.5
    r_min: float = 0.1
    r_max: float = 1.0
    delta_t: float = 10.0  # seconds between rate updates
    rate: float = field(default=0.0)
    phi_ema: float = field(default=-1.0)  # recent-φ EMA; <0 until first observe
    _phis: list = field(default_factory=list)
    _last_update: float = 0.0

    def __post_init__(self):
        if not self.rate:
            self.rate = self.r_max

    def observe(self, phi: float) -> None:
        phi = float(phi)
        self._phis.append(phi)
        # fast scene-dynamics signal for schedulers: unlike `rate` (integral
        # controller, lags by design) this separates static from dynamic
        # feeds within a few observations
        self.phi_ema = phi if self.phi_ema < 0 else 0.8 * self.phi_ema + 0.2 * phi

    def maybe_update(self, t_now: float) -> float:
        """Apply Eq. 1 every delta_t seconds; returns the current rate."""
        if t_now - self._last_update >= self.delta_t and self._phis:
            phi_bar = float(np.mean(self._phis))
            self.rate = float(
                np.clip(self.rate + self.eta * (phi_bar - self.phi_target),
                        self.r_min, self.r_max)
            )
            self._phis.clear()
            self._last_update = t_now
        return self.rate
