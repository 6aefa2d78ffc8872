"""Pooled GPU resources: per-device *stream* clocks, cost models, residency.

The server's accelerators are a pool of per-device clocks, and each device
clock splits into named **execution streams** — the AMS server concurrently runs a
heavy teacher for labeling and continual student training (paper §4), and a
single clock forces the cross-client labeling batch to serialize against the
fused train launch it feeds:

* `StreamModel` — how the two streams of one device interact: ``serialized``
  (mutual exclusion; with preemption off this is the single-clock
  default) or ``overlap`` (concurrent execution, each launch stretched by a
  bounded ``slowdown`` factor while the other stream is busy). ``preempt``
  makes labeling launches splittable at frame-batch boundaries: a
  higher-priority train grant cuts the in-flight launch, the remainder
  requeues, and ``preempt_cost_s`` is charged on the label stream.
* `GPUDevice` — one accelerator: the grant flag the event loop toggles, a
  `GPUCostModel` (devices may be heterogeneous), and per-stream occupancy
  records (`label` / `train`).
* `MigrationModel` — what it costs to move one session's server-side state
  (student weights + optimizer moments + the horizon replay buffer) onto a
  device it is not resident on.
* `GPUPool` — the devices plus *residency tracking*: each session's training
  state lives on exactly one device (its "home"); granting a session to a
  foreign device pays the migration transfer **on that device's train
  stream** and re-homes it. An optional per-device `residency_cap` models
  finite HBM: past it the least-recently-granted session spills to host.

First touch is free: an admitted session's state is staged onto its first
device before the run starts (admission-time prefetch), so a 1-GPU pool
reproduces the single-flag engine exactly — there is nowhere to
migrate to and nothing is ever evicted.

Time model of a stream charge: each stream executes its launches serially;
`charge` places a work item at ``max(now, stream free time)`` (and, when the
model serializes the streams, after the *other* stream too). In overlap mode
the item's duration is stretched while the other stream is occupied — the
contention snapshot is taken at launch time, so work arriving later does not
retroactively slow an in-flight launch (the later arrival bears the
contention cost). Preemption may truncate the **latest** charges of the
label stream; earlier history is immutable.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.scheduler import GPUCostModel

STREAMS = ("label", "train")


@dataclass(frozen=True)
class StreamModel:
    """How one device's label and train streams share the silicon.

    ``serialized`` + ``preempt=False`` is exactly the single-clock
    behavior (the engine keeps its legacy fast path for it, bit-for-bit).
    ``serialized`` + ``preempt=True`` still mutually excludes the streams but
    lets a train grant split an in-flight labeling launch at a frame-batch
    boundary. ``overlap`` runs the streams concurrently: while both are
    occupied each launch progresses at ``1/slowdown`` of its solo rate
    (``slowdown=1`` is full overlap, larger values model SM/memory-bandwidth
    contention; the serialized limit is ``slowdown -> inf``)."""

    mode: str = "serialized"  # "serialized" | "overlap"
    slowdown: float = 1.0  # overlap: duration stretch while both streams busy
    preempt: bool = False  # label launches splittable at frame-batch bounds
    preempt_cost_s: float = 0.0  # label-stream charge per real preemption
    # priority aging: a frame batch requeued this many times becomes
    # uncuttable — repeated preemption cannot push one victim's labels back
    # forever, so label staleness is bounded by ~max_seg_preempts launches
    max_seg_preempts: int = 2

    def __post_init__(self):
        if self.mode not in ("serialized", "overlap"):
            raise ValueError(
                f"stream mode must be 'serialized' or 'overlap', "
                f"got {self.mode!r}")
        if self.slowdown < 1.0:
            raise ValueError(
                f"slowdown is a stretch factor >= 1.0, got {self.slowdown}")
        if self.preempt_cost_s < 0.0:
            raise ValueError("preempt_cost_s must be >= 0")
        if self.max_seg_preempts < 1:
            raise ValueError(
                f"max_seg_preempts must be >= 1, got {self.max_seg_preempts}")

    @property
    def legacy(self) -> bool:
        """True when this model is indistinguishable from the single
        busy clock — the engine then takes its bit-identical legacy path."""
        return self.mode == "serialized" and not self.preempt

    @property
    def overlapped(self) -> bool:
        return self.mode == "overlap"

    # ---- piecewise time math -------------------------------------------
    def finish_time(self, start: float, work_s: float,
                    other_until: float) -> float:
        """When ``work_s`` seconds of solo-rate work started at ``start``
        completes, given the other stream is occupied until ``other_until``
        (overlap mode: contended progress accrues at ``1/slowdown``)."""
        if work_s <= 0.0:
            return start
        if (not self.overlapped or self.slowdown <= 1.0
                or other_until <= start):
            return start + work_s
        contended_capacity = (other_until - start) / self.slowdown
        if work_s <= contended_capacity:
            return start + work_s * self.slowdown
        return other_until + (work_s - contended_capacity)

    def stream_demand_s(self, label_s: float, train_s: float) -> float:
        """Steady-state device-seconds one update period of labeling plus
        training occupies under this model (admission projection):
        serialized is the plain sum; overlap interpolates between the
        busier stream (full overlap) and the sum (slowdown -> inf)."""
        if not self.overlapped:
            return label_s + train_s
        lo, hi = min(label_s, train_s), max(label_s, train_s)
        return hi + lo * (self.slowdown - 1.0) / max(self.slowdown, 1.0)


@dataclass(frozen=True)
class MigrationModel:
    """Cost of re-homing one session's training state onto another device.

    ``setup_s`` is the fixed charge (context/stream setup, allocator growth,
    kernel autotune re-warm); ``gbps`` the effective interconnect rate for
    the state bytes themselves (PCIe/NVLink staging, conservatively low
    because real moves serialize through host checkpointing)."""

    gbps: float = 2.0
    setup_s: float = 0.1

    def transfer_s(self, nbytes: int) -> float:
        if self.gbps <= 0:  # unmodeled interconnect: instantaneous
            return 0.0
        return self.setup_s + nbytes * 8.0 / (self.gbps * 1e9)


@dataclass
class _Charge:
    """One stream occupancy record: [start, end) plus the contention
    snapshot taken at launch (the other stream's free time then) — kept so
    truncation can recompute overlap without replaying history."""

    start: float
    end: float
    other_snap: float  # other stream's busy-until at launch time
    span: object = None  # flight-recorder span, when a tracer is attached

    @property
    def overlap_s(self) -> float:
        return max(0.0, min(self.end, self.other_snap) - self.start)


def _clipped_total(charges: list[_Charge], horizon_s: float) -> float:
    return sum(max(0.0, min(c.end, horizon_s) - max(c.start, 0.0))
               for c in charges)


def _union_total(intervals: list[tuple[float, float]],
                 horizon_s: float) -> float:
    """Measure of the union of intervals clipped to [0, horizon]."""
    spans = sorted((max(a, 0.0), min(b, horizon_s)) for a, b in intervals
                   if min(b, horizon_s) > max(a, 0.0))
    total, cur_a, cur_b = 0.0, None, None
    for a, b in spans:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


@dataclass
class GPUDevice:
    """One accelerator in the pool: grant flag + cost model + telemetry.

    ``busy``/``busy_s``/``grants`` keep their single-clock semantics (the legacy
    single-clock path reads and writes them unchanged). The dual-stream
    engine path records occupancy as per-stream `_Charge` lists instead and
    leaves ``busy_s`` untouched; `label_s`/`train_s` attribute busy seconds
    to streams in *both* paths (in the legacy path the engine splits each
    grant's in-window seconds into its label and train components)."""

    gid: int
    cost: GPUCostModel = field(default_factory=GPUCostModel)
    # the torch.device this pool slot executes on (device_backend="torch");
    # None under the default modeled backend — the math then runs on the
    # device of each session's own tensors and only the *clocks* are
    # per-device
    torch_device: object = None
    busy: bool = False
    crashed: bool = False  # fault injection: dead devices take no grants
    busy_s: float = 0.0
    grants: int = 0
    label_s: float = 0.0  # legacy-path stream attribution (in-window seconds)
    train_s: float = 0.0
    stream_until: dict = field(
        default_factory=lambda: {s: 0.0 for s in STREAMS})
    charges: dict = field(
        default_factory=lambda: {s: [] for s in STREAMS})
    # frame-batch completion boundaries of scheduled labeling launches —
    # the points a preemption could cut the label stream at (`label_bounds`
    # records them; `truncate_label` drops the ones a cut removed)
    label_cuts: list = field(default_factory=list)

    # ---- stream telemetry ----------------------------------------------
    def stream_busy_s(self, stream: str, horizon_s: float) -> float:
        if self.charges[stream]:
            return _clipped_total(self.charges[stream], horizon_s)
        return self.label_s if stream == "label" else self.train_s

    def union_busy_s(self, horizon_s: float) -> float:
        """Wall-clock seconds this device had *any* stream occupied (the
        dual-stream analogue of ``busy_s``; equal to it when charges exist
        on one stream only)."""
        if not any(self.charges[s] for s in STREAMS):
            return self.busy_s
        return _union_total([(c.start, c.end) for s in STREAMS
                             for c in self.charges[s]], horizon_s)

    def overlap_s(self) -> float:
        """Seconds both streams were concurrently busy (each charge counts
        its own concurrency against the other stream's schedule at launch,
        so an overlapping pair is counted once — by the later charge)."""
        return sum(c.overlap_s for s in STREAMS for c in self.charges[s])


class GPUPool:
    """Per-device stream clocks + session-state residency for the engine.

    The pool is pure bookkeeping — it never decides *who* runs (that is the
    `SchedulingPolicy`) or *when* (the event loop). It answers: which devices
    are free, what would running session c on device g cost in migration
    time, when could each stream accept work, and it enforces that no device
    is ever double-granted."""

    def __init__(self, n_gpus: int = 1, cost: GPUCostModel | None = None,
                 costs: list[GPUCostModel] | None = None,
                 migration: MigrationModel | None = None,
                 residency_cap: int | None = None,
                 streams: StreamModel | None = None,
                 device_backend: str = "modeled"):
        if residency_cap is not None and residency_cap < 1:
            raise ValueError(
                f"residency_cap must be >= 1 (or None for unbounded HBM), "
                f"got {residency_cap}")
        if device_backend not in ("modeled", "torch"):
            raise ValueError(
                f"device_backend must be 'modeled' or 'torch', "
                f"got {device_backend!r}")
        if costs is None:
            costs = [cost or GPUCostModel()] * max(n_gpus, 1)
        self.devices = [GPUDevice(gid=g, cost=c) for g, c in enumerate(costs)]
        # device_backend="torch": bind every pool slot to a CUDA card,
        # ``torch.device("cuda", gid % device_count)``, so a fused grant's
        # lifecycle runs on the granted slot's card. Round-robin when the
        # pool is wider than the host — the clocks stay per-slot either
        # way, but `distinct_torch_devices` tells how much real
        # parallelism is available. There is no CPU binding: without CUDA
        # this raises. "modeled" (the default) binds nothing and imports
        # nothing: no placement at all.
        self.device_backend = device_backend
        if device_backend == "torch":
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device_backend='torch' binds pool slots to CUDA cards, "
                    "but CUDA is not available (use 'modeled' for a "
                    "placement-free pool)")
            n_live = torch.cuda.device_count()
            for d in self.devices:
                d.torch_device = torch.device("cuda", d.gid % n_live)
        self.migration = migration or MigrationModel()
        self.streams = streams or StreamModel()
        self.tracer = None  # flight recorder (serving.obs.Tracer), optional
        self.residency_cap = residency_cap
        self._home: dict[int, int] = {}  # client -> device holding its state
        self._last_grant: dict[int, dict[int, float]] = {
            d.gid: {} for d in self.devices}  # gid -> {client: t of last grant}
        self._spilled: set[int] = set()  # evicted to host; next grant restages
        # telemetry
        self.migrations = 0
        self.migration_s_total = 0.0
        self.evictions = 0
        self.rider_grants = 0  # sessions co-trained via fused coalescing
        self.preemptions = 0  # in-flight labeling launches split by a grant
        self.preempted_frames = 0  # frames requeued by those splits
        self.preempt_s_total = 0.0  # modeled preemption cost paid
        self.crashes = 0  # injected device crashes
        self.crash_spills = 0  # sessions whose residency a crash destroyed

    # ---- capacity ------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.devices)

    def device(self, gid: int) -> GPUDevice:
        return self.devices[gid]

    def torch_devices(self) -> list:
        """Per-slot torch.device bindings (list of None under "modeled")."""
        return [d.torch_device for d in self.devices]

    @property
    def distinct_torch_devices(self) -> int:
        """How many *different* real devices back the pool (0 = modeled).

        A 4-slot pool on a 1-card host binds 4 slots to the same card:
        correctness holds but the slots' launches are physically serial."""
        return len({d.torch_device for d in self.devices
                    if d.torch_device is not None})

    def free_ids(self) -> list[int]:
        return [d.gid for d in self.devices
                if not d.busy and not d.crashed]

    def has_free(self) -> bool:
        return any(not d.busy and not d.crashed for d in self.devices)

    def n_alive(self) -> int:
        return sum(1 for d in self.devices if not d.crashed)

    # ---- fault injection ------------------------------------------------
    def crash(self, gid: int, t: float) -> int:
        """Device ``gid`` dies at ``t``: it takes no further grants and all
        session state resident on it is lost — those sessions spill to host
        and their next grant pays a full restage on whichever surviving
        device the policy picks (the normal migration machinery rebuilds
        residency). The engine handles any grant in flight (watchdog +
        requeue); here we only flip the flag and drop residency. Returns
        how many residents were spilled."""
        dev = self.devices[gid]
        dev.crashed = True
        victims = list(self._last_grant[gid])
        for c in victims:
            del self._last_grant[gid][c]
            self._home.pop(c, None)
            self._spilled.add(c)
        self.crashes += 1
        self.crash_spills += len(victims)
        return len(victims)

    def recover(self, gid: int) -> None:
        """Device ``gid`` rejoins the pool (empty: its HBM was lost)."""
        self.devices[gid].crashed = False

    # ---- residency -----------------------------------------------------
    def home_of(self, client: int) -> int | None:
        return self._home.get(client)

    def is_resident(self, client: int, gid: int) -> bool:
        return self._home.get(client) == gid and client not in self._spilled

    def migration_s(self, client: int, gid: int, state_bytes: int) -> float:
        """Time device ``gid`` would spend staging ``client``'s state before
        it can train there. Zero when already resident; zero on first touch
        (admission-time prefetch); a full restage after a host spill."""
        home = self._home.get(client)
        if client in self._spilled:
            return self.migration.transfer_s(state_bytes)
        if home is None or home == gid:
            return 0.0
        return self.migration.transfer_s(state_bytes)

    # ---- stream clocks (dual-stream engine path) -----------------------
    def stream_free_at(self, gid: int, stream: str) -> float:
        return self.devices[gid].stream_until[stream]

    def train_ready_wait_s(self, gid: int, t: float) -> float:
        """Seconds after ``t`` before a train launch could begin on ``gid``
        under this stream model (policies use it for placement). Serialized
        streams wait for both clocks; overlapped only for the train stream.

        With ``preempt=True`` the label stream's contribution is bounded by
        the next frame-batch boundary plus the preemption charge — a grant
        would cut the in-flight labeling launch there rather than wait out
        its tail — so preemptible devices are no longer taxed by the
        no-preempt upper bound (`AffinityAware` reads this). The estimate is
        deliberately optimistic about cuttability: the engine's disruption
        guard and segment aging can refuse a specific cut, which placement
        cannot know in advance."""
        dev = self.devices[gid]
        until = dev.stream_until["train"]
        if not self.streams.overlapped:
            label_until = dev.stream_until["label"]
            if self.streams.preempt and label_until > t:
                dev.label_cuts = [b for b in dev.label_cuts if b > t]
                if dev.label_cuts:
                    label_until = min(
                        label_until,
                        min(dev.label_cuts) + self.streams.preempt_cost_s)
            until = max(until, label_until)
        return max(0.0, until - t)

    def charge(self, gid: int, stream: str, t: float, work_s: float,
               name: str | None = None,
               args: dict | None = None) -> tuple[float, float]:
        """Occupy ``stream`` on ``gid`` for ``work_s`` seconds of solo-rate
        work, starting no earlier than ``t``: the item queues behind the
        stream (and, when serialized, behind the other stream too) and is
        stretched by the overlap model while the other stream is busy.
        Returns the placed ``(start, end)``. With a tracer attached and a
        ``name`` given, the charge carries a flight-recorder span (later
        truncation edits the span with the schedule)."""
        dev = self.devices[gid]
        other = "train" if stream == "label" else "label"
        start = max(t, dev.stream_until[stream])
        if not self.streams.overlapped:
            start = max(start, dev.stream_until[other])
        snap = dev.stream_until[other]
        end = self.streams.finish_time(start, work_s, snap)
        c = _Charge(start=start, end=end, other_snap=snap)
        if self.tracer is not None and name is not None:
            c.span = self.tracer.gpu_span(gid, stream, name, start, end, args)
        dev.charges[stream].append(c)
        dev.stream_until[stream] = end
        return start, end

    def label_bounds(self, gid: int, t: float, cum_works: list[float],
                     name: str | None = None,
                     args: dict | None = None) -> tuple[float, list[float]]:
        """Charge one labeling launch whose frame batches complete at the
        cumulative solo-rate work marks ``cum_works`` (monotone, last =
        total). Returns ``(start, [absolute boundary times])`` — the points
        the launch may later be preempted at."""
        dev = self.devices[gid]
        start, _ = self.charge(gid, "label", t, cum_works[-1],
                               name=name, args=args)
        snap = dev.charges["label"][-1].other_snap
        bounds = [self.streams.finish_time(start, w, snap) for w in cum_works]
        if self.streams.preempt and not self.streams.overlapped:
            # where a later grant could cut in — recorded only for the
            # serialized+preempt model, the one config whose wait estimate
            # reads them. Pruning happens HERE (drop bounds already past
            # this launch's start), not only in the read path: a pool run
            # under a policy that never queries the wait estimate must not
            # accumulate the whole run's launch history
            dev.label_cuts = ([b for b in dev.label_cuts if b > start]
                              + bounds)
        return start, bounds

    def truncate_label(self, gid: int, new_end: float, *,
                       preempted_frames: int, cancel: bool = False) -> float:
        """Preemption bookkeeping: cut the label stream's LATEST charge to
        ``new_end`` (the frame-batch boundary) and charge the model's
        preemption cost after it. ``cancel=True`` removes a launch that had
        not started yet (free reordering — no cost, not a preemption).
        Returns when the label stream is free again."""
        dev = self.devices[gid]
        dev.label_cuts = [b for b in dev.label_cuts if b <= new_end]
        last = dev.charges["label"][-1]
        if cancel:
            dev.charges["label"].pop()
            if last.span is not None:
                last.span.cancelled = True
        else:
            last.end = new_end
            if last.span is not None:
                # a preemption is a schedule edit, so it is a span edit
                last.span.end = new_end
                if last.span.args is not None:
                    last.span.args = dict(last.span.args, preempted=True)
            self.preemptions += 1
            self.preempted_frames += preempted_frames
            if self.tracer is not None:
                self.tracer.gpu_instant(gid, "label", "preempt", new_end,
                                        {"frames": int(preempted_frames)})
            cost = self.streams.preempt_cost_s
            if cost > 0.0:
                self.preempt_s_total += cost
                c = _Charge(start=new_end, end=new_end + cost,
                            other_snap=dev.stream_until["train"])
                if self.tracer is not None:
                    c.span = self.tracer.gpu_span(
                        gid, "label", "preempt_cost", new_end,
                        new_end + cost, {"frames": int(preempted_frames)})
                dev.charges["label"].append(c)
                new_end = new_end + cost
        dev.stream_until["label"] = (dev.charges["label"][-1].end
                                     if dev.charges["label"] else 0.0)
        return dev.stream_until["label"]

    # ---- grant / release ----------------------------------------------
    def grant(self, gid: int, client: int, t: float, dur_s: float,
              horizon_s: float, mig_s: float = 0.0,
              label_s: float = 0.0) -> None:
        """Legacy single-clock grant: occupy ``gid`` for ``dur_s`` (which
        already includes ``mig_s`` and ``label_s``) and re-home ``client``
        there. Raises on double-booking — the policy layer must only hand
        out free devices. ``label_s`` is the labeling component of the
        grant, attributed to the label stream for telemetry (it runs
        ``mig_s`` after the grant start); the rest is train-stream time."""
        dev = self.devices[gid]
        if dev.busy:
            raise RuntimeError(
                f"device {gid} double-booked at t={t:.3f} (client {client})")
        dev.busy = True
        dev.grants += 1
        # phases granted near the horizon spill past it; only the in-window
        # part counts toward utilization (keeps busy_s <= horizon per device)
        in_window = min(dur_s, max(horizon_s - t, 0.0))
        dev.busy_s += in_window
        label_in = max(0.0, min(t + mig_s + label_s, horizon_s)
                       - min(t + mig_s, horizon_s))
        dev.label_s += label_in
        dev.train_s += in_window - label_in
        if mig_s > 0.0:
            self.migrations += 1
            self.migration_s_total += mig_s
        self._note_residency(gid, client, t)

    def grant_streams(self, gid: int, client: int, t: float) -> None:
        """Dual-stream grant: flag the device as granted and re-home
        ``client``; the actual time is charged per work item via `charge`
        (migration/training on the train stream, labeling via
        `label_bounds`)."""
        dev = self.devices[gid]
        if dev.busy:
            raise RuntimeError(
                f"device {gid} double-booked at t={t:.3f} (client {client})")
        dev.busy = True
        dev.grants += 1
        self._note_residency(gid, client, t)

    def note_migration(self, mig_s: float) -> None:
        if mig_s > 0.0:
            self.migrations += 1
            self.migration_s_total += mig_s

    def attach(self, gid: int, client: int, t: float,
               mig_s: float = 0.0) -> None:
        """Residency bookkeeping for a fused *rider*: a session co-trained on
        an already-granted device (`engine` coalescing). A cost-aware
        `coalesce` may take a rider whose staging is cheaper than the fused
        stack discount — its ``mig_s`` is counted here (the engine charges
        the time to the granting device); the device's busy state is
        untouched, but the session is (re-)homed and its LRU slot refreshed
        like any grant."""
        self.rider_grants += 1
        self.note_migration(mig_s)
        self._note_residency(gid, client, t)

    def _note_residency(self, gid: int, client: int, t: float) -> None:
        prev = self._home.get(client)
        if prev is not None and prev != gid:
            self._last_grant[prev].pop(client, None)
        self._home[client] = gid
        self._last_grant[gid][client] = t
        self._spilled.discard(client)
        cap = self.residency_cap
        if cap is not None and len(self._last_grant[gid]) > cap:
            lru = self._last_grant[gid]
            victim = min((c for c in lru if c != client),
                         key=lambda c: (lru[c], c))
            del lru[victim]
            del self._home[victim]
            self._spilled.add(victim)
            self.evictions += 1

    def extend_busy(self, gid: int, t: float, extra_s: float,
                    horizon_s: float) -> None:
        """Keep a granted device busy past its phase (delta compression) —
        legacy-path accounting, attributed to the train stream."""
        dev = self.devices[gid]
        in_window = min(extra_s, max(horizon_s - t, 0.0))
        dev.busy_s += in_window
        dev.train_s += in_window

    def release(self, gid: int) -> None:
        self.devices[gid].busy = False

    # ---- telemetry -----------------------------------------------------
    def utilization(self, horizon_s: float) -> list[float]:
        return [d.union_busy_s(horizon_s) / max(horizon_s, 1e-9)
                for d in self.devices]

    def stream_utilization(self, horizon_s: float) -> dict[str, list[float]]:
        return {s: [d.stream_busy_s(s, horizon_s) / max(horizon_s, 1e-9)
                    for d in self.devices] for s in STREAMS}

    def overlap_s_total(self) -> float:
        return sum(d.overlap_s() for d in self.devices)
