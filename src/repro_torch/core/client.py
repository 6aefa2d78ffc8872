"""Edge client: local inference + double-buffered model swap (§3, "Edge
device"): updates are applied to an inactive copy and atomically swapped so
inference is never disrupted."""
from __future__ import annotations

from typing import Callable

from repro_torch.core.delta import ModelDelta, apply_delta


class EdgeClient:
    def __init__(self, predict_fn: Callable, params0):
        self._predict = predict_fn
        self.active = params0
        self.inactive = params0
        self.updates_applied = 0

    def apply_update(self, delta: ModelDelta) -> None:
        """Build the updated tree off to the side, then swap it in with one
        assignment — inference never sees a half-applied update.
        `apply_delta` returns a new tree and leaves its input untouched, so
        the "inactive buffer" is the new tree under construction and both
        names point at it once it is swapped in."""
        self.active = self.inactive = apply_delta(self.active, delta)
        self.updates_applied += 1

    def infer(self, frame):
        return self._predict(self.active, frame)
