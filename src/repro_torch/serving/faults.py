"""Deterministic fault injection for the serving runtime (chaos testing).

The paper's prototype lives on real cellular links and a shared GPU server;
neither is fault-free. This module is the single description of everything
that can go wrong in a run — a seeded, declarative `FaultPlan`:

* **link outages** (`OutageWindow`) — an uplink/downlink is dead for a time
  window, for one client or the whole fleet. Client disconnect/reconnect is
  the same thing in both directions (``disconnects``).
* **per-transfer loss** (``up_loss`` / ``down_loss``) — each transfer is
  independently lost with a fixed probability. The bytes still occupy the
  link (wasted air time is the point); the payload never lands.
* **burst/jitter rate traces** (``up_rate_trace`` / ``down_rate_trace``) —
  a `network.RateTrace` applied to every client's links, replacing the
  constant-rate model with a cellular-style variable-bandwidth replay.
* **device crashes** (`CrashWindow`) — a pool device is dead for a window:
  residency on it is lost (sessions spill to host and restage on a survivor
  via the normal migration machinery), a grant in flight dies with it (the
  engine's ``gpu_done`` watchdog detects and requeues the fused group), and
  the scheduler stops placing work on it until the window ends.
* **device slowdowns** (`SlowdownWindow`) — grants placed while the window
  covers the device run ``factor``x slower (thermal throttling, a noisy
  neighbor).

Determinism is the contract: every stochastic decision (per-transfer loss,
retry backoff jitter) is a pure function of ``(plan.seed, decision keys)``
via a splitmix64-style hash — no global RNG is consumed, and two runs of
the same plan are byte-identical (the property CI asserts). The default
`FaultPlan.none()` configures nothing, and the engine's fault hooks are all
behind an ``active`` check, so a fault-free engine is bit-identical to the
pre-chaos code (golden-tested).

`FaultInjector` is the runtime view: it normalizes/merges windows once and
answers the engine's point queries (is this link down at t? is this
transfer lost? how long is the next backoff?).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.serving.network import RateTrace

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: avalanche one 64-bit lane."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _u01(seed: int, *keys: int) -> float:
    """Deterministic uniform in [0, 1) from the seed and integer keys."""
    h = _mix64(seed & _M64)
    for k in keys:
        h = _mix64(h ^ (k & _M64))
    return (h >> 11) / float(1 << 53)


@dataclass(frozen=True)
class OutageWindow:
    """One link-outage interval. ``client=None`` hits the whole fleet;
    ``direction`` is ``"up"``, ``"down"`` or ``"both"``."""

    start: float
    end: float
    direction: str = "both"
    client: int | None = None

    def __post_init__(self):
        if self.direction not in ("up", "down", "both"):
            raise ValueError(f"direction must be up/down/both, "
                             f"got {self.direction!r}")
        if self.end < self.start:
            raise ValueError(f"outage window ends before it starts: "
                             f"[{self.start}, {self.end}]")


@dataclass(frozen=True)
class CrashWindow:
    """Device ``gid`` is dead during [start, end); it rejoins at ``end``."""

    gid: int
    start: float
    end: float

    def __post_init__(self):
        if self.end <= self.start:
            raise ValueError(f"crash window empty: [{self.start}, {self.end}]")


@dataclass(frozen=True)
class SlowdownWindow:
    """Grants placed on ``gid`` while covered run ``factor``x slower."""

    gid: int
    start: float
    end: float
    factor: float = 1.5

    def __post_init__(self):
        if self.factor < 1.0:
            raise ValueError(f"slowdown factor must be >= 1.0, "
                             f"got {self.factor}")


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, declarative chaos schedule for one engine run.

    The default instance (== `FaultPlan.none()`) configures no faults and
    the engine treats it as "chaos off": no extra events, no extra RNG, a
    bit-identical schedule. The retry knobs only matter once something can
    actually fail."""

    seed: int = 0
    # per-transfer loss probability (bytes burn the link; payload is lost)
    up_loss: float = 0.0
    down_loss: float = 0.0
    # scheduled windows
    outages: tuple[OutageWindow, ...] = ()
    disconnects: tuple[OutageWindow, ...] = ()  # client off-air, both ways
    crashes: tuple[CrashWindow, ...] = ()
    slowdowns: tuple[SlowdownWindow, ...] = ()
    # fleet-wide variable-bandwidth replay (network.RateTrace)
    up_rate_trace: RateTrace | None = None
    down_rate_trace: RateTrace | None = None
    # retry policy: exponential backoff with deterministic jitter
    max_retries: int = 5
    backoff_base_s: float = 0.5
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.25  # +/- fraction of the backoff, hashed
    detect_timeout_s: float = 0.2  # sender's loss/outage detection lag
    # gpu_done straggler timeout, measured past the planned completion
    watchdog_s: float = 5.0

    def __post_init__(self):
        for name in ("up_loss", "down_loss"):
            p = getattr(self, name)
            if not 0.0 <= p < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {p}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_factor < 1.0 or self.backoff_base_s < 0.0:
            raise ValueError("backoff must not shrink: need base >= 0 and "
                             "factor >= 1")
        if not 0.0 <= self.backoff_jitter < 1.0:
            raise ValueError(f"backoff_jitter must be in [0, 1), "
                             f"got {self.backoff_jitter}")
        if self.watchdog_s <= 0.0 or self.detect_timeout_s < 0.0:
            raise ValueError("watchdog_s must be > 0, detect_timeout_s >= 0")
        for w in self.disconnects:
            if w.client is None:
                raise ValueError("a disconnect window needs a client "
                                 "(fleet-wide loss is an OutageWindow)")
        by_gid: dict[int, list[CrashWindow]] = {}
        for w in self.crashes:
            by_gid.setdefault(w.gid, []).append(w)
        for gid, ws in by_gid.items():
            ws = sorted(ws, key=lambda w: w.start)
            for a, b in zip(ws, ws[1:]):
                if b.start < a.end:
                    raise ValueError(
                        f"overlapping crash windows on device {gid}: "
                        f"[{a.start}, {a.end}] and [{b.start}, {b.end}]")

    @staticmethod
    def none() -> "FaultPlan":
        """The fault-free plan: hooks disabled, schedule bit-identical to
        an engine that never heard of faults (golden-tested)."""
        return FaultPlan()

    @property
    def active(self) -> bool:
        return bool(self.up_loss > 0.0 or self.down_loss > 0.0
                    or self.outages or self.disconnects or self.crashes
                    or self.slowdowns or self.up_rate_trace is not None
                    or self.down_rate_trace is not None)

    @staticmethod
    def reference(duration: float, n_gpus: int = 2) -> "FaultPlan":
        """The reference chaos plan: lossy links, a fleet-wide uplink
        outage, a long downlink outage (longer than one update period, so
        deferred deltas get superseded by fresh ones), one mid-run device
        crash while the pool is loaded, and a thermal slowdown on the
        survivor — every recovery path exercised in one deterministic
        run."""
        return FaultPlan(
            seed=7,
            up_loss=0.12,
            down_loss=0.12,
            outages=(OutageWindow(start=0.25 * duration,
                                  end=0.25 * duration + 12.0,
                                  direction="up"),
                     OutageWindow(start=0.65 * duration,
                                  end=0.65 * duration + 16.0,
                                  direction="down")),
            crashes=(CrashWindow(gid=n_gpus - 1, start=0.5 * duration,
                                 end=0.5 * duration + 0.12 * duration),),
            slowdowns=(SlowdownWindow(gid=0, start=0.75 * duration,
                                      end=0.85 * duration, factor=1.5),),
        )


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class FaultInjector:
    """Runtime view of a `FaultPlan`: merged window indexes + deterministic
    point draws. Holds per-(direction, client) draw counters so that the
    n-th transfer of a client is always judged by the same hash — replaying
    a run replays its losses exactly."""

    # key-space tags, so draws for different purposes never collide
    _TAG_LOSS = {"up": 1, "down": 2}
    _TAG_BACKOFF = 3

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        # (direction, client-or-None) -> merged outage intervals
        self._outages: dict[tuple[str, int | None], list] = {}
        for w in plan.outages + plan.disconnects:
            dirs = ("up", "down") if w.direction == "both" else (w.direction,)
            for d in dirs:
                self._outages.setdefault((d, w.client), []).append(
                    (w.start, w.end))
        for k, ivs in self._outages.items():
            self._outages[k] = _merge(ivs)
        self._slow = sorted(plan.slowdowns, key=lambda w: (w.gid, w.start))
        self._draws: dict[tuple[int, int], int] = {}

    # ---- point queries --------------------------------------------------
    def outage_until(self, direction: str, client: int, t: float
                     ) -> float | None:
        """If the client's ``direction`` link is down at ``t``, when the
        covering outage window ends; None when the link is up."""
        for key in ((direction, None), (direction, client)):
            for a, b in self._outages.get(key, ()):
                if a <= t < b:
                    return b
        return None

    def transfer_lost(self, direction: str, client: int) -> bool:
        """Deterministic per-transfer loss draw: keyed by the plan seed,
        the direction, the client, and that client's transfer count in
        this direction (advanced on every call)."""
        p = self.plan.up_loss if direction == "up" else self.plan.down_loss
        tag = self._TAG_LOSS[direction]
        n = self._draws.get((tag, client), 0)
        self._draws[(tag, client)] = n + 1
        if p <= 0.0:
            return False
        return _u01(self.plan.seed, tag, client, n) < p

    def backoff_s(self, client: int, attempt: int) -> float:
        """Exponential backoff with deterministic jitter for the (attempt)th
        retry of ``client`` — jitter is hashed, not drawn, so re-runs and
        concurrent clients never correlate or diverge."""
        base = self.plan.backoff_base_s * self.plan.backoff_factor ** attempt
        j = self.plan.backoff_jitter
        if j <= 0.0:
            return base
        u = _u01(self.plan.seed, self._TAG_BACKOFF, client, attempt)
        return base * (1.0 + j * (2.0 * u - 1.0))

    def slowdown_factor(self, gid: int, t: float) -> float:
        for w in self._slow:
            if w.gid == gid and w.start <= t < w.end:
                return w.factor
        return 1.0

    # ---- window telemetry ----------------------------------------------
    def outage_windows(self) -> list[tuple[str, int | None, float, float]]:
        """Merged (direction, client-or-None, start, end) outage windows —
        the tracer's `outage` spans and the outage-seconds gauge read
        these."""
        return [(d, c, a, b) for (d, c), ivs in sorted(
                    self._outages.items(),
                    key=lambda kv: (kv[0][0], -1 if kv[0][1] is None
                                    else kv[0][1]))
                for a, b in ivs]

    def link_outage_s(self, duration: float, n_clients: int) -> float:
        """Total client-link-seconds of scheduled outage inside the run
        (a fleet-wide window counts once per client)."""
        total = 0.0
        for _, c, a, b in self.outage_windows():
            w = max(0.0, min(b, duration) - max(a, 0.0))
            total += w * (n_clients if c is None else 1)
        return total

    def crash_s(self, duration: float) -> float:
        """Total device-seconds of scheduled crash downtime in the run."""
        return sum(max(0.0, min(w.end, duration) - max(w.start, 0.0))
                   for w in self.plan.crashes)
