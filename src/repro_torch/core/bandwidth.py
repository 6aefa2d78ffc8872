"""Uplink/downlink byte ledger -> Kbps accounting (paper Tables 1-2)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BandwidthLedger:
    up_bytes: int = 0
    down_bytes: int = 0
    events: list = field(default_factory=list)

    def uplink(self, nbytes: int, t: float, what: str = "frames") -> None:
        self.up_bytes += int(nbytes)
        self.events.append((t, "up", what, int(nbytes)))

    def downlink(self, nbytes: int, t: float, what: str = "delta") -> None:
        self.down_bytes += int(nbytes)
        self.events.append((t, "down", what, int(nbytes)))

    def kbps(self, duration_s: float) -> tuple[float, float]:
        if duration_s <= 0:
            return 0.0, 0.0
        return (self.up_bytes * 8 / duration_s / 1e3,
                self.down_bytes * 8 / duration_s / 1e3)
