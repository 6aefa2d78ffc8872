"""Time-stamped training buffer B (Algorithm 1 lines 3, 8, 12).

Holds (sample, teacher_label, timestamp) tuples; minibatches are sampled
uniformly over the last T_horizon seconds. Host-side (numpy) — this is the
server's data-plane state, not device state.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ReplayBuffer:
    horizon: float  # T_horizon seconds
    slack: float = 60.0  # keep a little history beyond the horizon
    frames: list = field(default_factory=list)
    labels: list = field(default_factory=list)
    stamps: list = field(default_factory=list)

    def add(self, frame, label, t: float) -> None:
        self.frames.append(np.asarray(frame))
        self.labels.append(np.asarray(label))
        self.stamps.append(float(t))
        self._evict(t)

    def _evict(self, t_now: float) -> None:
        cutoff = t_now - self.horizon - self.slack
        k = 0
        while k < len(self.stamps) and self.stamps[k] < cutoff:
            k += 1
        if k:
            del self.frames[:k], self.labels[:k], self.stamps[:k]

    def window_indices(self, t_now: float) -> np.ndarray:
        stamps = np.asarray(self.stamps)
        return np.nonzero(stamps >= t_now - self.horizon)[0]

    def __len__(self) -> int:
        return len(self.stamps)

    def sample(self, rng: np.random.Generator, batch_size: int, t_now: float):
        """Uniform minibatch over the last T_horizon seconds (line 12).
        Returns (frames, labels) stacked, or None if the window is empty."""
        idx = self.window_indices(t_now)
        if idx.size == 0:
            return None
        pick = rng.choice(idx, size=batch_size, replace=idx.size < batch_size)
        frames = np.stack([self.frames[i] for i in pick])
        labels = np.stack([self.labels[i] for i in pick])
        return frames, labels
