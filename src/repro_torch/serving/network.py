"""Modeled client<->server network (§3.2 uplink / §3.1.2 downlink).

Each client owns two half-duplex `Link`s (uplink for frame batches, downlink
for `ModelDelta`s). A transfer occupies its link for ``bytes * 8 / rate``
seconds — concurrent sends on the same link serialize — then lands after a
propagation delay. Every byte is also charged to the client's
`BandwidthLedger`, so per-client Kbps falls out of the same accounting the
single-client benchmarks use. With finite rates, deltas arrive *stale*: the
server's weights have moved on by the time an edge applies them.

Links are constant-rate by default; attach a `RateTrace` (directly, via
`LinkSpec.from_trace`, or through a `FaultPlan`) to replay a cellular-style
variable-bandwidth trace instead — transfer completion is then the exact
piecewise integral of the trace, still fully deterministic.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from repro_torch.core.bandwidth import BandwidthLedger

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer (`serving.faults` has the same one; a local
    copy because faults imports this module)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


@dataclass(frozen=True)
class RateTrace:
    """A cyclic variable-bandwidth replay: ``kbps[i]`` holds for the i-th
    ``interval_s`` slice of wall-clock, repeating past the end. Zero-rate
    slices model dead air (a burst gap), so at least one slice must be
    positive or no transfer could ever finish.

    ``phase_s`` shifts where in the cycle the replay starts: the link sees
    ``rate_at(t + phase_s)``. A fleet replaying ONE trace in phase fades
    and recovers in lock-step — every uplink stalls together, which is a
    different (and rarer) regime than a fleet of independently-faded
    links. `for_client` derives a deterministic per-client phase from the
    client id, decorrelating the fleet while staying fully reproducible;
    the default 0.0 is bit-identical to the unphased trace."""

    kbps: tuple[float, ...]
    interval_s: float = 1.0
    phase_s: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "kbps",
                           tuple(float(r) for r in self.kbps))
        if not self.kbps:
            raise ValueError("RateTrace needs at least one rate sample")
        if any(r < 0.0 for r in self.kbps):
            raise ValueError("RateTrace rates must be >= 0 kbps")
        if not any(r > 0.0 for r in self.kbps):
            raise ValueError("RateTrace needs a positive rate somewhere, "
                             "or transfers never finish")
        if self.interval_s <= 0.0:
            raise ValueError("RateTrace interval_s must be > 0")
        if self.phase_s < 0.0:
            raise ValueError("RateTrace phase_s must be >= 0 (it is an "
                             "offset into a cyclic trace; wrap negatives "
                             "by adding the period)")

    @property
    def mean_kbps(self) -> float:
        return sum(self.kbps) / len(self.kbps)

    @property
    def period_s(self) -> float:
        return len(self.kbps) * self.interval_s

    def with_phase(self, phase_s: float) -> "RateTrace":
        """This trace shifted to start ``phase_s`` into its cycle (wrapped
        to the period). Returns ``self`` unchanged for a 0 offset, so the
        unphased path keeps object identity (and bit-identity)."""
        phase_s = float(phase_s) % self.period_s
        if phase_s == self.phase_s:
            return self
        return RateTrace(self.kbps, self.interval_s, phase_s)

    def for_client(self, client: int) -> "RateTrace":
        """A deterministically client-phased copy: the offset is a
        splitmix64 hash of the client id mapped onto the trace period —
        stable across runs and processes, no RNG consumed. Client fades
        then decorrelate across the fleet instead of synchronizing."""
        frac = (_mix64(int(client) & _M64) >> 11) / float(1 << 53)
        return self.with_phase(self.phase_s + frac * self.period_s)

    def rate_at(self, t: float) -> float:
        """Instantaneous rate (kbps) at absolute time ``t``, cyclic."""
        t = t + self.phase_s
        return self.kbps[int(t // self.interval_s) % len(self.kbps)]

    def finish_time(self, start: float, nbits: float) -> float:
        """When a transfer of ``nbits`` beginning at ``start`` drains,
        walking the trace slice by slice (exact piecewise integral)."""
        if nbits <= 0.0:
            return start
        n, iv = len(self.kbps), self.interval_s
        start = start + self.phase_s  # walk in trace time, return wall time
        idx = int(start // iv)
        t, remaining = start, float(nbits)
        while True:
            rate_bps = self.kbps[idx % n] * 1e3
            seg_end = (idx + 1) * iv
            cap = rate_bps * (seg_end - t)
            if rate_bps > 0.0 and remaining <= cap:
                return t + remaining / rate_bps - self.phase_s
            remaining -= cap
            t = seg_end
            idx += 1


@dataclass(frozen=True)
class LinkSpec:
    """Per-client provisioning. Defaults sit near the paper's operating
    points: a few-hundred-Kbps video uplink, a Mbps-class downlink.
    Optional per-direction `RateTrace`s override the constant rates."""

    up_kbps: float = 1000.0
    down_kbps: float = 2000.0
    prop_delay_s: float = 0.05
    up_trace: RateTrace | None = None
    down_trace: RateTrace | None = None

    @classmethod
    def from_trace(cls, path_or_dict, *, prop_delay_s: float | None = None,
                   client: int | None = None) -> "LinkSpec":
        """Build a spec from a JSON trace fixture (path or parsed dict):
        ``{"interval_s": 1.0, "up_kbps": [...], "down_kbps": [...]}``.
        A direction without samples keeps the constant default; scalar
        rates are set to each trace's mean so rate-only consumers (cost
        models, back-of-envelope sizing) see the right average.

        ``client`` phase-shifts both traces deterministically from the
        client id (`RateTrace.for_client`), so a fleet built from one
        fixture fades out of lock-step; None (the default) keeps the
        fixture's own phase — bit-identical to the pre-phasing loader."""
        if isinstance(path_or_dict, dict):
            data = path_or_dict
        else:
            with open(path_or_dict) as f:
                data = json.load(f)
        iv = float(data.get("interval_s", 1.0))
        phase = float(data.get("phase_s", 0.0))
        kw: dict = {}
        up = data.get("up_kbps")
        if up:
            kw["up_trace"] = RateTrace(tuple(up), iv, phase)
            if client is not None:
                kw["up_trace"] = kw["up_trace"].for_client(client)
            kw["up_kbps"] = kw["up_trace"].mean_kbps
        down = data.get("down_kbps")
        if down:
            kw["down_trace"] = RateTrace(tuple(down), iv, phase)
            if client is not None:
                kw["down_trace"] = kw["down_trace"].for_client(client)
            kw["down_kbps"] = kw["down_trace"].mean_kbps
        delay = (prop_delay_s if prop_delay_s is not None
                 else data.get("prop_delay_s"))
        if delay is not None:
            kw["prop_delay_s"] = float(delay)
        return cls(**kw)


@dataclass
class Link:
    """One direction of a client's pipe: rate limit + propagation delay."""

    rate_kbps: float
    prop_delay_s: float = 0.0
    busy_until: float = 0.0
    bytes_carried: int = 0
    transfers: int = 0
    trace: RateTrace | None = None  # overrides rate_kbps when set

    def tx_seconds(self, nbytes: int) -> float:
        if self.rate_kbps <= 0:  # unmodeled link: instantaneous
            return 0.0
        return nbytes * 8.0 / (self.rate_kbps * 1e3)

    def transfer(self, t_now: float, nbytes: int) -> float:
        """Occupy the link starting no earlier than ``t_now``; returns the
        arrival time at the far end."""
        start = max(t_now, self.busy_until)
        if self.trace is not None:
            self.busy_until = self.trace.finish_time(start, nbytes * 8.0)
        else:
            self.busy_until = start + self.tx_seconds(nbytes)
        self.bytes_carried += int(nbytes)
        self.transfers += 1
        return self.busy_until + self.prop_delay_s


@dataclass
class ClientNetwork:
    """Both directions for one client, wired into its bandwidth ledger."""

    spec: LinkSpec = field(default_factory=LinkSpec)
    ledger: BandwidthLedger = field(default_factory=BandwidthLedger)

    def __post_init__(self):
        self.up = Link(self.spec.up_kbps, self.spec.prop_delay_s,
                       trace=self.spec.up_trace)
        self.down = Link(self.spec.down_kbps, self.spec.prop_delay_s,
                         trace=self.spec.down_trace)
        # flight recorder wiring (set by the engine when tracing): the span
        # covers link occupancy [start, busy_until]; propagation delay is
        # in-flight time, not link time, so it stays outside the span
        self.tracer = None
        self.client = -1
        self.last_span = None  # most recent transfer span (flow anchoring)

    def _traced_transfer(self, link: Link, direction: str, t_now: float,
                         nbytes: int, what: str) -> float:
        if self.tracer is None:
            return link.transfer(t_now, nbytes)
        start = max(t_now, link.busy_until)
        arrival = link.transfer(t_now, nbytes)
        self.last_span = self.tracer.client_span(
            self.client, direction, what, start, link.busy_until,
            {"bytes": int(nbytes)})
        return arrival

    def send_up(self, t_now: float, nbytes: int, what: str = "frames") -> float:
        self.ledger.uplink(nbytes, t_now, what)
        return self._traced_transfer(self.up, "up", t_now, nbytes, what)

    def send_down(self, t_now: float, nbytes: int, what: str = "delta") -> float:
        self.ledger.downlink(nbytes, t_now, what)
        return self._traced_transfer(self.down, "down", t_now, nbytes, what)

    def send_ctrl(self, t_now: float, nbytes: int) -> float:
        """The ASR rate-control message: a few bytes, but they queue behind
        the delta on the same downlink and pay the same propagation delay —
        the edge samples at its *old* rate until this lands."""
        return self.send_down(t_now, nbytes, what="asr-rate")

    def kbps(self, duration_s: float) -> tuple[float, float]:
        return self.ledger.kbps(duration_s)
