"""Flight recorder for the serving engine: span tracing, metrics, drift audit.

Three instruments, one module:

* `Tracer` — records spans in **simulated** time for every engine event
  (grants, migration, labeling launches, preemption cuts, the fused
  train→select→encode pipeline stages, per-client uplink/downlink
  transfers) and exports deterministic Chrome trace-event JSON: one
  process per GPU with one thread per device stream (plus a grants track),
  one process per client with uplink/downlink threads, and counter tracks
  for queue depth / backlog / per-stream utilization. Open the file at
  https://ui.perfetto.dev ("Open trace file") or chrome://tracing.
* `MetricsRegistry` — typed counters/gauges/histograms with dotted names;
  the engine's results dict is assembled from it (`as_results`).
* `drift_report` — folds the wall-clock stage stats from `core.timing`
  (first-call vs steady split) against a `GPUCostModel`'s per-stage
  pricing: modeled vs measured seconds per pipeline stage, the audit that
  says how far the modeled clock can be trusted on the device at hand.

Determinism: timestamps are simulated seconds (microsecond-quantized),
span/flow ids are sequential creation ids, events are emitted sorted by
``(ts, id)``, and the JSON is dumped with sorted keys — two identical runs
produce byte-identical trace files (same discipline as the gzip ``mtime=0``
wire-format fix).
"""
from __future__ import annotations

import json

import numpy as np

# ---------------------------------------------------------------------------
# trace-event layout: pids / tids
# ---------------------------------------------------------------------------

PID_SERVER = 0
GPU_PID_BASE = 1  # gpu g -> pid GPU_PID_BASE + g
TID_LABEL, TID_TRAIN, TID_GRANT = 1, 2, 3
TID_FAULT = 4  # injected crash windows (chaos runs only)
STREAM_TIDS = {"label": TID_LABEL, "train": TID_TRAIN}
TID_UP, TID_DOWN = 1, 2
TID_CLIENT_FAULT = 3  # injected link outages (chaos runs only)


def _us(t: float) -> int:
    # round() is monotone, so interval orderings placed in float seconds
    # survive quantization: a charge placed after another stays after it
    return int(round(t * 1e6))


class Span:
    """One open or closed trace span. Mutable until export: preemption
    edits ``end`` (schedule truncation), cancellation drops it entirely —
    a cut is a schedule edit in the simulator, so it is one in the trace."""

    __slots__ = ("pid", "tid", "name", "cat", "start", "end", "args", "seq",
                 "cancelled")

    def __init__(self, pid, tid, name, start, end, cat, args, seq):
        self.pid = pid
        self.tid = tid
        self.name = name
        self.cat = cat
        self.start = start
        self.end = end
        self.args = args
        self.seq = seq
        self.cancelled = False


class Tracer:
    """Deterministic Chrome-trace recorder for one engine run."""

    def __init__(self, max_clients: int = 1000,
                 sample_clients: int | None = None):
        # per-client span volume scales linearly with the fleet: tracing a
        # 10⁵-client fleet would emit a multi-GB, unopenable trace, so the
        # recorder refuses past this cap (raise it explicitly to insist).
        # sample_clients instead traces a deterministic evenly-spaced
        # subset of that size when the fleet exceeds the cap: server/GPU
        # tracks stay complete, per-client transfer tracks exist only for
        # the sampled clients (the schedule itself is untouched — sampling
        # drops spans, never events)
        if sample_clients is not None and sample_clients < 1:
            raise ValueError(
                f"sample_clients must be >= 1 (or None to refuse big "
                f"fleets), got {sample_clients}")
        self.max_clients = max_clients
        self.sample_clients = sample_clients
        self._sampled: frozenset | None = None  # None = trace every client
        self._spans: list[Span] = []
        self._counters: list = []   # (seq, t, pid, name, values)
        self._instants: list = []   # (seq, t, pid, tid, name, args)
        self._flows: list = []      # (flow_id, src Span, dst Span)
        self._procs: dict[int, str] = {}
        self._threads: dict[tuple[int, int], str] = {}
        self._seq = 0
        self._flow_seq = 0
        self.meta: dict = {}
        self._client_base = 1001

    # ---- registration ---------------------------------------------------
    def _next(self) -> int:
        self._seq += 1
        return self._seq

    def process(self, pid: int, name: str) -> None:
        self._procs.setdefault(pid, name)

    def thread(self, pid: int, tid: int, name: str) -> None:
        self._threads.setdefault((pid, tid), name)

    def setup_engine(self, pool, sessions, cfg) -> None:
        """Register the run's processes/threads and the trace metadata the
        schema validator reads (stream mode, pool/fleet size)."""
        n_fleet = len(sessions)
        if n_fleet > self.max_clients:
            if self.sample_clients is None:
                raise ValueError(
                    f"refusing to trace {n_fleet} clients (cap "
                    f"{self.max_clients}): per-client transfer spans would "
                    f"make the trace unopenably large. Trace a small fleet "
                    f"(the schedule is deterministic, so a subsample "
                    f"reproduces), pass Tracer(sample_clients=k) for a "
                    f"deterministic k-client subset, or "
                    f"Tracer(max_clients=...) to insist on everything.")
            # deterministic, stable, evenly spaced over the sorted client
            # ids: the same fleet always samples the same clients, and the
            # subset spans the id range (ids often encode admission order)
            ids = sorted(s.idx for s in sessions)
            k = min(self.sample_clients, n_fleet)
            self._sampled = frozenset(ids[(j * n_fleet) // k]
                                      for j in range(k))
        self.meta = {
            "n_gpus": pool.n,
            "n_clients": len(sessions),
            "stream_mode": pool.streams.mode,
            "preempt": pool.streams.preempt,
            "fuse_train": cfg.fuse_train,
            "fuse_updates": cfg.fuse_updates,
        }
        self._client_base = max(1001, GPU_PID_BASE + pool.n + 1)
        # fault tracks appear only in chaos runs, so fault-free traces stay
        # byte-identical to the pre-chaos recorder
        chaos = getattr(getattr(cfg, "faults", None), "active", False)
        self.process(PID_SERVER, "serving-engine")
        self.thread(PID_SERVER, 0, "events")
        for d in pool.devices:
            pid = self.gpu_pid(d.gid)
            self.process(pid, f"gpu{d.gid}")
            self.thread(pid, TID_LABEL, "stream:label")
            self.thread(pid, TID_TRAIN, "stream:train")
            self.thread(pid, TID_GRANT, "grants")
            if chaos:
                self.thread(pid, TID_FAULT, "faults")
        if self._sampled is not None:
            self.meta["sampled_clients"] = len(self._sampled)
        for s in sessions:
            if not self.traces_client(s.idx):
                continue
            pid = self.client_pid(s.idx)
            self.process(pid, f"client{s.idx}")
            self.thread(pid, TID_UP, "uplink")
            self.thread(pid, TID_DOWN, "downlink")
            if chaos:
                self.thread(pid, TID_CLIENT_FAULT, "faults")

    def traces_client(self, client: int) -> bool:
        """Whether per-client spans for ``client`` are recorded (always
        True unless a ``sample_clients`` subset is active)."""
        return self._sampled is None or client in self._sampled

    def gpu_pid(self, gid: int) -> int:
        return GPU_PID_BASE + gid

    def client_pid(self, client: int) -> int:
        return self._client_base + client

    # ---- recording ------------------------------------------------------
    def span(self, pid: int, tid: int, name: str, start: float,
             end: float | None = None, *, cat: str = "span",
             args: dict | None = None) -> Span:
        s = Span(pid, tid, name, start, end, cat, args, self._next())
        self._spans.append(s)
        return s

    def gpu_span(self, gid: int, stream: str, name: str, start: float,
                 end: float, args: dict | None = None) -> Span:
        return self.span(self.gpu_pid(gid), STREAM_TIDS[stream], name,
                         start, end, cat=f"stream:{stream}", args=args)

    def grant_span(self, gid: int, name: str, start: float,
                   args: dict | None = None) -> Span:
        """Open-ended device-grant span; the engine sets ``end`` when the
        grant's device time is fully charged (gpu_done)."""
        return self.span(self.gpu_pid(gid), TID_GRANT, name, start, None,
                         cat="grant", args=args)

    def client_span(self, client: int, direction: str, name: str,
                    start: float, end: float,
                    args: dict | None = None) -> Span | None:
        if not self.traces_client(client):
            return None  # unsampled client: schedule unchanged, span dropped
        tid = TID_UP if direction == "up" else TID_DOWN
        return self.span(self.client_pid(client), tid, name, start, end,
                         cat=f"net:{direction}", args=args)

    def gpu_fault_span(self, gid: int, name: str, start: float, end: float,
                       args: dict | None = None) -> Span:
        """A crash window on a device's fault track (chaos runs)."""
        return self.span(self.gpu_pid(gid), TID_FAULT, name, start, end,
                         cat="fault", args=args)

    def client_fault_span(self, client: int, name: str, start: float,
                          end: float, args: dict | None = None) -> Span | None:
        """A link-outage window on a client's fault track (chaos runs)."""
        if not self.traces_client(client):
            return None
        return self.span(self.client_pid(client), TID_CLIENT_FAULT, name,
                         start, end, cat="fault", args=args)

    def counter(self, pid: int, name: str, t: float, values: dict) -> None:
        self._counters.append((self._next(), t, pid, name, values))

    def instant(self, pid: int, tid: int, name: str, t: float,
                args: dict | None = None) -> None:
        self._instants.append((self._next(), t, pid, tid, name, args))

    def gpu_instant(self, gid: int, stream: str, name: str, t: float,
                    args: dict | None = None) -> None:
        self.instant(self.gpu_pid(gid), STREAM_TIDS[stream], name, t, args)

    def flow(self, src: Span, dst: Span, name: str = "delta") -> int:
        """Causal arrow between two spans (e.g. device grant -> downlink
        delta transfer). Materialized at export from the span endpoints, so
        a later schedule edit moves the arrow with the span."""
        self._flow_seq += 1
        self._flows.append((self._flow_seq, src, dst, name))
        return self._flow_seq

    # ---- export ---------------------------------------------------------
    def to_events(self) -> list[dict]:
        events: list[dict] = []
        for pid in sorted(self._procs):
            events.append({"ph": "M", "pid": pid, "tid": 0,
                           "name": "process_name",
                           "args": {"name": self._procs[pid]}})
            events.append({"ph": "M", "pid": pid, "tid": 0,
                           "name": "process_sort_index",
                           "args": {"sort_index": pid}})
        for (pid, tid) in sorted(self._threads):
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": self._threads[(pid, tid)]}})
        timed: list[tuple[int, int, dict]] = []
        for s in self._spans:
            if s.cancelled:
                continue
            end = s.start if s.end is None else s.end
            e = {"ph": "X", "pid": s.pid, "tid": s.tid, "name": s.name,
                 "cat": s.cat, "ts": _us(s.start),
                 "dur": max(_us(end) - _us(s.start), 0)}
            if s.args:
                e["args"] = s.args
            timed.append((e["ts"], s.seq, e))
        for seq, t, pid, name, values in self._counters:
            timed.append((_us(t), seq,
                          {"ph": "C", "pid": pid, "tid": 0, "name": name,
                           "ts": _us(t), "args": values}))
        for seq, t, pid, tid, name, args in self._instants:
            e = {"ph": "i", "s": "t", "pid": pid, "tid": tid, "name": name,
                 "ts": _us(t)}
            if args:
                e["args"] = args
            timed.append((_us(t), seq, e))
        for fid, src, dst, name in self._flows:
            if src.cancelled or dst.cancelled:
                continue
            src_end = src.start if src.end is None else src.end
            timed.append((_us(src_end), src.seq,
                          {"ph": "s", "id": fid, "name": name, "cat": "flow",
                           "pid": src.pid, "tid": src.tid,
                           "ts": _us(src_end)}))
            timed.append((_us(dst.start), dst.seq,
                          {"ph": "f", "bp": "e", "id": fid, "name": name,
                           "cat": "flow", "pid": dst.pid, "tid": dst.tid,
                           "ts": _us(dst.start)}))
        timed.sort(key=lambda x: (x[0], x[1]))
        events.extend(e for _, _, e in timed)
        return events

    def to_json(self) -> str:
        doc = {"traceEvents": self.to_events(),
               "displayTimeUnit": "ms",
               "otherData": dict(self.meta)}
        return json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n"

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


# ---------------------------------------------------------------------------
# schema / invariant validation (CI gate for emitted traces)
# ---------------------------------------------------------------------------

REQUIRED_COUNTERS = ("queue_depth", "backlog_frames", "stream_util")


def validate_trace(trace: dict,
                   require_counters=REQUIRED_COUNTERS) -> list[str]:
    """Structural + invariant checks on a parsed Chrome trace. Returns a
    list of problems (empty = valid):

    * every complete span has a non-negative duration;
    * the required counter tracks exist;
    * per device stream, spans never overlap (each stream executes its
      launches serially — preemption truncates, it does not double-book);
    * per client link track (uplink/downlink), spans never overlap — link
      occupancy is serial, so a ``retry`` span may not overlap its link's
      live transfer (the chaos retry path waits for the link);
    * under a ``serialized`` stream model the two streams of one device
      are mutually exclusive, so per-device span concurrency is <= 1
      (<= 2 under ``overlap``);
    * every span tagged with a grant id nests inside that grant's span
      (the fused train/select/encode stages belong to their device grant);
    * fault vocabulary: ``cat="fault"`` spans are named ``outage``/
      ``crash`` and live on a fault track (client/device respectively),
      ``retry`` spans live on a ``net:*`` link track, and ``supersede``
      instants live on client processes.
    """
    problems: list[str] = []
    evs = trace.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    gpu_pids = {e["pid"] for e in evs
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and str(e.get("args", {}).get("name", "")).startswith("gpu")}
    client_pids = {e["pid"] for e in evs
                   if e.get("ph") == "M" and e.get("name") == "process_name"
                   and str(e.get("args", {}).get("name", ""))
                   .startswith("client")}
    counters = {e.get("name") for e in evs if e.get("ph") == "C"}
    for name in require_counters:
        if name not in counters:
            problems.append(f"missing counter track {name!r}")
    spans = [e for e in evs if e.get("ph") == "X"]
    for e in spans:
        for fld in ("pid", "tid", "ts", "dur", "name"):
            if fld not in e:
                problems.append(f"span missing {fld!r}: {e}")
        if e.get("dur", 0) < 0:
            problems.append(f"negative duration: {e}")
    # per-stream serial execution; client links are serial too — retries
    # queue behind the link like any transfer (fault tracks are exempt:
    # a client's up and down outage windows may legitimately overlap)
    by_track: dict = {}
    for e in spans:
        by_track.setdefault((e["pid"], e["tid"]), []).append(e)
    for (pid, tid), track in by_track.items():
        if not (pid in gpu_pids
                or (pid in client_pids and tid in (TID_UP, TID_DOWN))):
            continue
        track.sort(key=lambda e: (e["ts"], e["ts"] + e["dur"]))
        for a, b in zip(track, track[1:]):
            if b["ts"] < a["ts"] + a["dur"]:
                problems.append(
                    f"overlapping spans on pid={pid} tid={tid}: "
                    f"{a['name']}@{a['ts']} and {b['name']}@{b['ts']}")
    # cross-stream concurrency per device
    serialized = trace.get("otherData", {}).get("stream_mode") == "serialized"
    limit = 1 if serialized else 2
    for pid in gpu_pids:
        marks = []
        for tid in (TID_LABEL, TID_TRAIN):
            for e in by_track.get((pid, tid), []):
                if e["dur"] > 0:
                    marks.append((e["ts"], 1))
                    marks.append((e["ts"] + e["dur"], -1))
        marks.sort()
        depth = peak = 0
        for _, d in marks:
            depth += d
            peak = max(peak, depth)
        if peak > limit:
            problems.append(
                f"device pid={pid} ran {peak} concurrent stream spans "
                f"(limit {limit} for "
                f"{'serialized' if serialized else 'overlap'} streams)")
    # grant nesting
    grants = {e["args"]["seq"]: e for e in spans
              if e.get("cat") == "grant" and "seq" in e.get("args", {})}
    for e in spans:
        g = e.get("args", {}).get("grant")
        if g is None or g not in grants:
            continue
        ge = grants[g]
        if e["ts"] < ge["ts"] or e["ts"] + e["dur"] > ge["ts"] + ge["dur"]:
            problems.append(
                f"span {e['name']}@{e['ts']} escapes grant {g} "
                f"[{ge['ts']}, {ge['ts'] + ge['dur']}]")
    # fault vocabulary (chaos runs)
    for e in spans:
        if e.get("cat") == "fault":
            if e["name"] == "outage":
                if not (e["pid"] in client_pids
                        and e["tid"] == TID_CLIENT_FAULT):
                    problems.append(
                        f"outage span off a client fault track: {e}")
            elif e["name"] == "crash":
                if not (e["pid"] in gpu_pids and e["tid"] == TID_FAULT):
                    problems.append(
                        f"crash span off a device fault track: {e}")
            else:
                problems.append(
                    f"unknown fault span name {e['name']!r}: {e}")
        elif e.get("name") == "retry":
            if not str(e.get("cat", "")).startswith("net:"):
                problems.append(f"retry span off a network link track: {e}")
    for e in evs:
        if e.get("ph") == "i" and e.get("name") == "supersede":
            if e.get("pid") not in client_pids:
                problems.append(f"supersede instant off a client: {e}")
    return problems


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic-ish accumulator (preemption bookkeeping may decrement)."""

    __slots__ = ("value",)

    def __init__(self, value=0):
        self.value = value

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins value; `set_max` keeps a running maximum."""

    __slots__ = ("value",)

    def __init__(self, value=None):
        self.value = value

    def set(self, v) -> None:
        self.value = v

    def set_max(self, v) -> None:
        if self.value is None or v > self.value:
            self.value = v


class Histogram:
    """Sample accumulator; summary stats match the engine's historical
    ``np.mean``/``np.max`` math exactly (pairwise summation and all)."""

    __slots__ = ("values",)

    def __init__(self):
        self.values: list[float] = []

    def record(self, v: float) -> None:
        self.values.append(v)

    def extend(self, vs) -> None:
        self.values.extend(vs)

    @property
    def count(self) -> int:
        return len(self.values)

    def mean(self) -> float:
        return float(np.mean(self.values)) if self.values else 0.0

    def max(self) -> float:
        return float(np.max(self.values)) if self.values else 0.0

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean(), "max": self.max()}


class MetricsRegistry:
    """Named metrics with dotted paths; `as_results` builds the nested
    results dict (``"update_pipeline.update_s_charged"`` lands under
    ``results["update_pipeline"]``). One registry per engine — the single
    source the results dict is assembled from."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get_or_create(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(*args)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str, value=0) -> Counter:
        return self._get_or_create(name, Counter, value)

    def gauge(self, name: str, value=None) -> Gauge:
        return self._get_or_create(name, Gauge, value)

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, Histogram)

    def set(self, name: str, value) -> None:
        self.gauge(name).set(value)

    def __getitem__(self, name: str):
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def as_results(self) -> dict:
        """Nested dict of every counter/gauge value. Histograms are raw
        sample stores for derived stats; callers export the summaries they
        want under explicit gauge names, so histograms are skipped here."""
        out: dict = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                continue
            node = out
            parts = name.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = m.value
        return out


# ---------------------------------------------------------------------------
# modeled-vs-measured cost-model drift audit
# ---------------------------------------------------------------------------


def _modeled_stage_s(cost, stage: str, key: tuple, nbytes: int,
                     calls: int) -> float | None:
    """Modeled device-seconds for ``calls`` invocations of one pipeline
    stage under ``cost``, from the pricing inputs the timing hooks recorded
    in ``key``/``nbytes``. Returns None for stages the model has no price
    for (they still appear in measured totals, just not in the ratio)."""
    if stage == "train_fused":
        b, k = key
        return calls * cost.train_batch_s(b, k)
    if stage == "train_solo":
        (k,) = key
        return calls * k * cost.train_iter_s
    if stage == "select_stacked":
        (b,) = key
        # the stacked selection's share of `update_batch_s`: setup + the
        # primary's select + discounted rider selects
        return calls * (cost.update_setup_s
                        + cost.select_s * (1 + cost.update_discount
                                           * (b - 1)))
    if stage == "select_solo":
        return calls * cost.select_s
    if stage == "encode_stacked":
        (b,) = key
        blend = (1 + cost.update_discount * (b - 1)) / b
        return cost.delta_comp_s(nbytes) * blend
    if stage == "encode_solo":
        return cost.delta_comp_s(nbytes)
    if stage == "sharded_device":
        # one pool slot's lifecycle in a sharded batch
        # (core.batched.train_phases_sharded), measured until this card's
        # own completion: the stacked selection's share plus the fused
        # train launch
        _slot, b, k = key
        return calls * (cost.update_setup_s
                        + cost.select_s * (1 + cost.update_discount
                                           * (b - 1))
                        + cost.train_batch_s(b, k))
    if stage == "train_sharded":
        # the whole batch: D uniform lifecycles running at once are priced
        # at ONE lifecycle, which the measured time approaches only on D
        # distinct cards. A batch of unequal groups (key (D,)) is covered
        # by its per-device stages instead.
        if len(key) != 3:
            return None
        _d, b, k = key
        return calls * (cost.update_setup_s
                        + cost.select_s * (1 + cost.update_discount
                                           * (b - 1))
                        + cost.train_batch_s(b, k))
    return None


def drift_report(cost, stats: dict | None = None) -> dict:
    """Per-stage modeled vs measured seconds from `core.timing` stats.

    For each stage: measured steady-state wall-clock, compile (first
    launch) wall-clock, and the cost model's price for the *steady* calls
    (first calls are excluded from both sides of the ratio — the model
    prices execution, not one-time set-up). ``drift_ratio`` > 1 means the
    real math is slower than modeled; None means the model prices the
    stage at zero (itself a finding: the stage costs real time the engine
    charges nothing for).

    Sharded batches (`core.batched.train_phases_sharded`) also get a
    per-device comparison: the ``sharded_device`` entry carries a
    ``per_device`` dict keyed by pool slot, each with its own measured and
    modeled steady seconds and drift ratio: the audit that tells a pool of
    real cards from modeled clocks ticking over one."""
    from repro_torch.core import timing as _timing

    stats = _timing.snapshot() if stats is None else stats
    out: dict = {}
    for (stage, key), v in sorted(stats.items(),
                                  key=lambda kv: (kv[0][0], str(kv[0][1]))):
        modeled = _modeled_stage_s(cost, stage, key, v["nbytes"], v["calls"])
        if modeled is None:
            continue
        e = out.setdefault(stage, {
            "calls": 0, "steady_calls": 0, "compile_s": 0.0,
            "measured_steady_s": 0.0, "modeled_steady_s": 0.0, "nbytes": 0})
        steady = v["calls"] - v["first_calls"]
        e["calls"] += v["calls"]
        e["steady_calls"] += steady
        e["compile_s"] += v["first_s"]
        e["measured_steady_s"] += v["steady_s"]
        modeled_steady = (modeled * steady / v["calls"] if v["calls"] else 0.0)
        e["modeled_steady_s"] += modeled_steady
        e["nbytes"] += v["nbytes"]
        if stage == "sharded_device":
            d = e.setdefault("per_device", {}).setdefault(int(key[0]), {
                "calls": 0, "steady_calls": 0,
                "measured_steady_s": 0.0, "modeled_steady_s": 0.0})
            d["calls"] += v["calls"]
            d["steady_calls"] += steady
            d["measured_steady_s"] += v["steady_s"]
            d["modeled_steady_s"] += modeled_steady
    for e in out.values():
        for d in (*e.get("per_device", {}).values(), e):
            meas, mod = d["measured_steady_s"], d["modeled_steady_s"]
            d["drift_ratio"] = (meas / mod) if mod > 0 else None
            d["measured_per_call_s"] = (meas / d["steady_calls"]
                                        if d["steady_calls"] else 0.0)
    return out


# ---------------------------------------------------------------------------
# unified introspection
# ---------------------------------------------------------------------------


def debug_snapshot() -> dict:
    """One call answering "what got fused, what was cached and what did it
    cost": the fused phase's runner cache and its auto exec-shape
    decisions (`core.batched.cache_info`, `auto_mode_info`; keys as
    ``"<backend>:<8-digit key hash>"``, as in the JAX package), the fused
    update pipeline's counters (`update_pipeline_info`), the sharded
    batches' counters (`sharded_info`) and the stage timing totals
    (`core.timing`). The JAX package's ``kernel_dispatch``,
    ``stacked_select_cache`` and ``stacked_encode_cache`` have no
    counterpart here: a CUDA tensor always takes its kernel, and selection
    and encode build nothing per key."""
    from repro_torch.core import batched, timing

    return {
        "fused_train_cache": batched.cache_info(),
        "auto_exec_modes": {f"{backend}:{abs(hash(base)) % 10**8:08d}": mode
                            for (backend, base), mode
                            in batched.auto_mode_info().items()},
        "update_pipeline": batched.update_pipeline_info(),
        "sharded": batched.sharded_info(),
        "stage_timings": timing.totals(),
    }
