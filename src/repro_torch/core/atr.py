"""Adaptive Training Rate (Appendix D, Eq. 2).

A *slowdown mode* stretches T_update by Δ per step while the ASR sampling
rate indicates a stationary scene (r_n < γ0) and snaps back to τ_min as soon
as variation picks up (r_n > γ1)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ATRController:
    tau_min: float = 10.0
    delta: float = 2.0
    gamma0: float = 0.25  # enter slowdown below this sampling rate (fps)
    gamma1: float = 0.35  # exit slowdown above this sampling rate (fps)
    t_update: float = 10.0
    slowdown: bool = False

    def update(self, sampling_rate: float) -> float:
        if self.slowdown and sampling_rate > self.gamma1:
            self.slowdown = False
        elif not self.slowdown and sampling_rate < self.gamma0:
            self.slowdown = True
        if self.slowdown:
            self.t_update = self.t_update + self.delta
        else:
            self.t_update = self.tau_min
        return self.t_update
