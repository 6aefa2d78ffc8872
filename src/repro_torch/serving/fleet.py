"""Struct-of-arrays stub fleets: one engine, 10⁴–10⁵ modeled clients.

AMS is a many-client system (one server continuously adapting models for a
fleet of edge devices), but a `StubSession` per client tops the engine out
in the dozens: every session is a Python object graph (session + network +
two links + ledger + unbounded per-eval lists) and every event touches it
attribute by attribute. `FleetState` keeps the whole fleet as parallel
numpy arrays instead — sampling rate, φ, staleness (last-update time),
outbox depth, admitted mask, per-direction link rate/occupancy/bytes — and
the engine's fleet path (`engine.ServingEngine` with a `FleetState` in
place of the session list) updates whole *cohorts* of clients per event.

Equivalence contract
--------------------
The fleet path is an optimization, not a different model: driven by the
same config, a `FleetState` reproduces the per-object `StubSession` engine
**bit-for-bit** — the results dict (minus wall-clock fields) and, under a
tracer, the emitted trace bytes. The pieces that make that hold:

* every array is float64/int64 and every update mirrors the per-object
  expression operand-for-operand (same IEEE ops, same order);
* `FleetSessionView` is a flyweight over the arrays exposing the exact
  `SessionBase` duck surface (including a `ClientNetwork`-shaped ``net``),
  so every rare per-client engine path — grants, deltas, chaos retries,
  traced transfers — runs the *same scalar code* against array storage;
* per-eval mIoU samples are stored as (clients, values) cohort chunks and
  re-grouped per client by one stable argsort at read time, so
  ``np.mean`` sees the same values in the same order.

What a fleet deliberately drops: per-transfer `BandwidthLedger.events`
tuples (never read by results) and real frame indices in the outbox (only
counts are ever consumed — the engine's labeling, tracing, and byte math
all use ``len``); the outbox is a depth counter and `take_outbox`
synthesizes ``[0] * depth``.

Telemetry modes
---------------
``telemetry="full"`` (default) keeps every mIoU/latency sample —
bit-identical to `StubSession`, O(total evals) memory. ``"moments"`` keeps
running (count, sum, max) accumulators instead — O(1) memory per client,
which is what lets a 10⁵-client sweep run in bounded RSS; its means are
``sum/count`` rather than ``np.mean`` (pairwise), so it is numerically
equal only to ~1 ulp and is NOT covered by the bit-identity contract.

`StubSession` grows the same knob for per-object fleets; the differential
tests in ``tests/test_fleet.py`` and the ``serving_scale --fleet`` gate
hold the contract.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.session import StubDelta

TELEMETRY_MODES = ("full", "moments")


def _arr(x, n: int, dtype) -> np.ndarray:
    """Broadcast a scalar or per-client sequence to an (n,) array."""
    a = np.asarray(x, dtype=dtype)
    if a.ndim == 0:
        return np.full(n, a, dtype=dtype)
    if a.shape != (n,):
        raise ValueError(f"per-client field has shape {a.shape}, "
                         f"expected ({n},)")
    return a.copy()


class _LinkView:
    """One direction of one client's pipe, as a view over the fleet arrays.
    Mirrors `network.Link` field-for-field (`transfer` is the same math
    against array cells), so the engine's scalar paths — chaos retries,
    traced transfers, rate-trace replay — run unchanged."""

    __slots__ = ("f", "i", "_rate", "_busy", "_bytes", "_count", "_traces",
                 "_dir")

    def __init__(self, fleet: "FleetState", idx: int, direction: str):
        self.f = fleet
        self.i = idx
        self._dir = direction
        if direction == "up":
            self._rate = fleet.up_kbps
            self._busy = fleet.up_busy
            self._bytes = fleet.up_bytes
            self._count = fleet.up_transfers
            self._traces = fleet._up_traces
        else:
            self._rate = fleet.down_kbps
            self._busy = fleet.down_busy
            self._bytes = fleet.down_bytes
            self._count = fleet.down_transfers
            self._traces = fleet._down_traces

    @property
    def rate_kbps(self) -> float:
        return float(self._rate[self.i])

    @property
    def prop_delay_s(self) -> float:
        return float(self.f.prop_delay_s[self.i])

    @property
    def busy_until(self) -> float:
        return float(self._busy[self.i])

    @busy_until.setter
    def busy_until(self, v: float) -> None:
        self._busy[self.i] = v

    @property
    def bytes_carried(self) -> int:
        return int(self._bytes[self.i])

    @property
    def transfers(self) -> int:
        return int(self._count[self.i])

    @property
    def trace(self):
        return self._traces[self.i]

    @trace.setter
    def trace(self, value) -> None:
        old = self._traces[self.i]
        self._traces[self.i] = value
        # O(1) "any link customized?" check for the engine's fast lane
        self.f._n_traced += (value is not None) - (old is not None)

    def tx_seconds(self, nbytes: int) -> float:
        rate = self._rate[self.i]
        if rate <= 0:  # unmodeled link: instantaneous
            return 0.0
        return nbytes * 8.0 / (rate * 1e3)

    def transfer(self, t_now: float, nbytes: int) -> float:
        i = self.i
        start = max(t_now, self._busy[i])
        tr = self._traces[i]
        if tr is not None:
            self._busy[i] = tr.finish_time(start, nbytes * 8.0)
        else:
            self._busy[i] = start + self.tx_seconds(nbytes)
        self._bytes[i] += int(nbytes)
        self._count[i] += 1
        return float(self._busy[i] + self.f.prop_delay_s[i])


class FleetNet:
    """`ClientNetwork`-shaped view for one fleet client: same send/kbps
    surface, same traced-transfer span emission, ledger bytes held in the
    fleet arrays (per-transfer ledger *events* are not kept — nothing in
    the engine's results reads them)."""

    __slots__ = ("f", "client", "tracer", "last_span", "up", "down")

    def __init__(self, fleet: "FleetState", idx: int):
        self.f = fleet
        self.client = idx
        self.tracer = None
        self.last_span = None
        self.up = _LinkView(fleet, idx, "up")
        self.down = _LinkView(fleet, idx, "down")

    def _traced_transfer(self, link: _LinkView, direction: str, t_now: float,
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
        # ledger bytes and Link.bytes_carried receive identical increments
        # in the per-object path; here one array serves both, filled by
        # _LinkView.transfer below.
        return self._traced_transfer(self.up, "up", t_now, nbytes, what)

    def send_down(self, t_now: float, nbytes: int, what: str = "delta") -> float:
        return self._traced_transfer(self.down, "down", t_now, nbytes, what)

    def send_ctrl(self, t_now: float, nbytes: int) -> float:
        return self.send_down(t_now, nbytes, what="asr-rate")

    def kbps(self, duration_s: float) -> tuple[float, float]:
        if duration_s <= 0:
            return 0.0, 0.0
        i = self.client
        return (int(self.f.up_bytes[i]) * 8 / duration_s / 1e3,
                int(self.f.down_bytes[i]) * 8 / duration_s / 1e3)


class FleetSessionView:
    """Flyweight `StubSession` over one fleet row — the `SessionBase` duck
    surface, every scalar produced as a plain Python int/float/bool/list so
    results dicts stay JSON-safe and bit-comparable to per-object runs."""

    __slots__ = ("f", "idx", "_net", "ams_session")

    def __init__(self, fleet: "FleetState", idx: int):
        self.f = fleet
        self.idx = idx
        self._net = None
        self.ams_session = None  # stubs never enter the fused real math

    # ---- identity / config ---------------------------------------------
    @property
    def net(self) -> FleetNet:
        n = self._net
        if n is None:
            n = self._net = FleetNet(self.f, self.idx)
        return n

    @property
    def sampling_rate(self) -> float:
        return float(self.f.sampling_rate[self.idx])

    @property
    def phi_signal(self) -> float:
        return float(self.f.phi[self.idx])

    @property
    def dynamics(self) -> float:
        return float(self.f.dynamics[self.idx])

    @property
    def fps(self) -> float:
        return float(self.f.fps[self.idx])

    @property
    def eval_interval_s(self) -> float:
        return float(self.f.eval_interval_s[self.idx])

    @property
    def t_update(self) -> float:
        return float(self.f.t_update[self.idx])

    @property
    def k_iters(self) -> int:
        return int(self.f.k_iters[self.idx])

    @property
    def state_bytes(self) -> int:
        return int(self.f.state_bytes[self.idx])

    @property
    def delta_bytes_hint(self) -> int:
        return int(self.f.delta_bytes[self.idx])

    @property
    def admitted(self) -> bool:
        return bool(self.f.admitted[self.idx])

    @admitted.setter
    def admitted(self, v: bool) -> None:
        self.f.admitted[self.idx] = v

    @property
    def edge_sampling_rate(self) -> float:
        er = self.f.edge_rate[self.idx]
        if np.isnan(er):
            return float(self.f.sampling_rate[self.idx])
        return float(er)

    def apply_rate_ctrl(self, rate: float) -> None:
        self.f.edge_rate[self.idx] = rate

    # ---- edge side ------------------------------------------------------
    def capture(self, t: float) -> None:
        self.f.outbox_depth[self.idx] += 1

    def take_outbox(self) -> list[int]:
        d = int(self.f.outbox_depth[self.idx])
        self.f.outbox_depth[self.idx] = 0
        return [0] * d  # frame identities are never consumed, only counts

    def upload_bytes(self, n_frames: int) -> int:
        return 256 + n_frames * int(self.f.frame_bytes[self.idx])

    def evaluate(self, t: float) -> None:
        f = self.f
        staleness = t - float(f.last_update_t[self.idx])
        v = max(0.2, 0.9 - float(f.dynamics[self.idx]) * staleness)
        f.record_miou(self.idx, v)

    def apply_delta(self, delta, t_sent: float, t_now: float) -> None:
        f = self.f
        f.last_update_t[self.idx] = t_now
        f.record_latency(self.idx, t_now - t_sent)

    # ---- server side ----------------------------------------------------
    def label_and_ingest(self, idxs: list, t: float) -> None:
        self.f.ingested[self.idx] += len(idxs)

    def train(self, t: float):
        f = self.f
        if f.ingested[self.idx] == 0:
            return None
        f.phases[self.idx] += 1
        return StubDelta(total_bytes=int(f.delta_bytes[self.idx]))

    def note_device(self, gid: int, stream: str = "train") -> None:
        self.f._phase_devices.setdefault(self.idx, []).append(gid)
        self.f._phase_streams.setdefault(self.idx, []).append(stream)

    # ---- telemetry ------------------------------------------------------
    @property
    def phases(self) -> int:
        return int(self.f.phases[self.idx])

    @property
    def mious(self) -> list[float]:
        return self.f.miou_values(self.idx).tolist()

    @property
    def delta_latencies(self) -> list[float]:
        vals = self.f.latency_values_of(self.idx)
        return [] if vals is None else vals

    @property
    def phase_devices(self) -> list[int]:
        return self.f._phase_devices.get(self.idx, [])

    @property
    def phase_streams(self) -> list[str]:
        return self.f._phase_streams.get(self.idx, [])

    def miou_mean(self) -> float:
        return self.f.miou_mean_of(self.idx)

    def latency_values(self):
        return self.f.latency_values_of(self.idx)

    def latency_summary(self) -> tuple[int, float, float]:
        return self.f.latency_summary_of(self.idx)


class _FleetViews:
    """Lazy, cached sequence of per-client views: the engine's
    ``self.sessions``. Views are flyweights, built on first index so a
    10⁵-client run only materializes the ones its scalar paths touch
    (plus one pass at results time)."""

    __slots__ = ("f", "_cache")

    def __init__(self, fleet: "FleetState"):
        self.f = fleet
        self._cache: list = [None] * fleet.n

    def __len__(self) -> int:
        return self.f.n

    def __getitem__(self, i: int) -> FleetSessionView:
        v = self._cache[i]
        if v is None:
            v = self._cache[i] = FleetSessionView(self.f, i)
        return v

    def __iter__(self):
        return (self[i] for i in range(self.f.n))


class FleetState:
    """The whole stub fleet as parallel arrays (one row per client).

    Scalars broadcast; per-client values may be passed as length-``n``
    sequences. Defaults mirror `StubSession` + `LinkSpec` defaults, so
    ``FleetState(n)`` twins ``[StubSession(i) for i in range(n)]``.
    """

    is_fleet = True

    def __init__(self, n: int, *, fps=4.0, t_update=10.0, k_iters=20,
                 rate=1.0, dynamics=0.01, frame_bytes=7000,
                 delta_bytes=20_000, state_bytes=32_000_000, eval_stride=6,
                 up_kbps=1000.0, down_kbps=2000.0, prop_delay_s=0.05,
                 telemetry: str = "full"):
        if n <= 0:
            raise ValueError(f"a fleet needs at least one client, got {n}")
        if telemetry not in TELEMETRY_MODES:
            raise ValueError(f"telemetry must be one of {TELEMETRY_MODES}, "
                             f"got {telemetry!r}")
        self.n = int(n)
        self.telemetry = telemetry
        f64, i64 = np.float64, np.int64
        self.fps = _arr(fps, n, f64)
        self.t_update = _arr(t_update, n, f64)
        self.k_iters = _arr(k_iters, n, i64)
        self.sampling_rate = _arr(rate, n, f64)
        self.phi = self.sampling_rate.copy()  # stubs: configured rate IS φ
        self.dynamics = _arr(dynamics, n, f64)
        self.frame_bytes = _arr(frame_bytes, n, i64)
        self.delta_bytes = _arr(delta_bytes, n, i64)
        self.state_bytes = _arr(state_bytes, n, i64)
        self.eval_interval_s = _arr(eval_stride, n, f64) / self.fps
        self.last_update_t = np.zeros(n, f64)
        self.outbox_depth = np.zeros(n, i64)
        self.ingested = np.zeros(n, i64)
        self.phases = np.zeros(n, i64)
        self.admitted = np.ones(n, dtype=bool)
        self.edge_rate = np.full(n, np.nan, f64)  # nan = no delivered rate
        # link state (ledger bytes and Link.bytes_carried are incremented
        # identically in the per-object path, so one array serves both)
        self.up_kbps = _arr(up_kbps, n, f64)
        self.down_kbps = _arr(down_kbps, n, f64)
        self.prop_delay_s = _arr(prop_delay_s, n, f64)
        self.up_busy = np.zeros(n, f64)
        self.down_busy = np.zeros(n, f64)
        self.up_bytes = np.zeros(n, i64)
        self.down_bytes = np.zeros(n, i64)
        self.up_transfers = np.zeros(n, i64)
        self.down_transfers = np.zeros(n, i64)
        self._up_traces: list = [None] * n  # per-client RateTrace overrides
        self._down_traces: list = [None] * n
        self._n_traced = 0
        # sparse per-client records (only clients that get grants pay)
        self._phase_devices: dict[int, list] = {}
        self._phase_streams: dict[int, list] = {}
        if telemetry == "full":
            # cohort chunks, re-grouped per client by one stable argsort at
            # read time — same values in the same order as per-object lists
            self._miou_c: list[np.ndarray] = []
            self._miou_v: list[np.ndarray] = []
            self._miou_sorted = None
            self._lat: dict[int, list[float]] = {}
        else:
            self._m_n = np.zeros(n, i64)
            self._m_sum = np.zeros(n, f64)
            self._lat_n = np.zeros(n, i64)
            self._lat_sum = np.zeros(n, f64)
            self._lat_max = np.zeros(n, f64)
        self._views = _FleetViews(self)

    # ---- engine surface --------------------------------------------------
    def views(self) -> _FleetViews:
        return self._views

    def effective_rate(self, clients: np.ndarray) -> np.ndarray:
        """Per-client `edge_sampling_rate`: the last *delivered* ASR rate
        where one exists, the server-side rate otherwise."""
        er = self.edge_rate[clients]
        return np.where(np.isnan(er), self.sampling_rate[clients], er)

    @property
    def any_link_traces(self) -> bool:
        return self._n_traced > 0

    # ---- mIoU telemetry --------------------------------------------------
    def record_mious(self, clients: np.ndarray, values: np.ndarray) -> None:
        if self.telemetry == "full":
            self._miou_c.append(np.asarray(clients, np.int64).copy())
            self._miou_v.append(np.asarray(values, np.float64).copy())
            self._miou_sorted = None
        else:
            np.add.at(self._m_n, clients, 1)
            np.add.at(self._m_sum, clients, values)

    def record_miou(self, i: int, v: float) -> None:
        if self.telemetry == "full":
            self._miou_c.append(np.array([i], np.int64))
            self._miou_v.append(np.array([v], np.float64))
            self._miou_sorted = None
        else:
            self._m_n[i] += 1
            self._m_sum[i] += v

    def _mious_by_client(self) -> tuple[np.ndarray, np.ndarray]:
        if self._miou_sorted is None:
            if self._miou_c:
                cc = np.concatenate(self._miou_c)
                vv = np.concatenate(self._miou_v)
                order = np.argsort(cc, kind="stable")  # keeps time order
                self._miou_sorted = (cc[order], vv[order])
            else:
                self._miou_sorted = (np.empty(0, np.int64),
                                     np.empty(0, np.float64))
        return self._miou_sorted

    def miou_values(self, i: int) -> np.ndarray:
        if self.telemetry != "full":
            raise ValueError(
                "per-eval mIoU samples are not kept under telemetry="
                "'moments'; use miou_mean_of or telemetry='full'")
        cc, vv = self._mious_by_client()
        lo, hi = np.searchsorted(cc, [i, i + 1])
        return vv[lo:hi]

    def miou_mean_of(self, i: int) -> float:
        if self.telemetry == "full":
            vals = self.miou_values(i)
            return float(np.mean(vals)) if len(vals) else float("nan")
        n = int(self._m_n[i])
        return float(self._m_sum[i] / n) if n else float("nan")

    # ---- delta-latency telemetry ----------------------------------------
    def record_latency(self, i: int, lat: float) -> None:
        if self.telemetry == "full":
            self._lat.setdefault(i, []).append(lat)
        else:
            self._lat_n[i] += 1
            self._lat_sum[i] += lat
            if lat > self._lat_max[i]:
                self._lat_max[i] = lat

    def latency_values_of(self, i: int):
        if self.telemetry == "full":
            return self._lat.get(i, [])
        return None  # moments mode: samples are folded, not kept

    def latency_summary_of(self, i: int) -> tuple[int, float, float]:
        if self.telemetry == "full":
            vals = self._lat.get(i, [])
            return (len(vals), float(sum(vals)),
                    float(max(vals)) if vals else 0.0)
        return (int(self._lat_n[i]), float(self._lat_sum[i]),
                float(self._lat_max[i]))
