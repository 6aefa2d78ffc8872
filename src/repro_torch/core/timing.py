"""Wall-clock stage timing for the fused hot path (observability layer).

The serving engine charges *modeled* device-seconds (`GPUCostModel`); the
fused train, select and encode stages in `core.batched` / `core.selection`
/ `core.delta` spend *real* wall-clock. This shim is the bridge: the
hot-path call sites record per-stage wall-clock here — the first call with
a given key in the process (where cuDNN picks its algorithms and the CUDA
sources build) attributed separately from steady-state — and
`serving.obs.drift_report` folds the accumulated stats against the cost
model's per-stage pricing.

Stats are process-global (like the first-call sets at the call sites) and
keyed by ``(stage, key)`` where ``key`` carries the pricing inputs the cost
model needs — e.g. ``("train_fused", (B, K))``. Callers that want per-run
numbers bracket with `snapshot()` / `delta(snap)`. Single-threaded by
construction, like the engine. `set_enabled(False)` turns every `record`
into a no-op (the perf_counter reads at the call sites are guarded by
`enabled()`, so the disabled overhead is one module-attr check per stage).

It is also the port's span recorder. `span(name, **attrs)` marks a layer
boundary of the served path (`launch.serve`, the encoder, the decode
attention, the recurrent scans); `spans()` records them for a ``with``
block and hands the records over when it ends. Spans are off unless a
`spans()` block is open, under their own switch: the stage stats' switch
does not touch them. Off, `span` returns one shared object whose
``with`` does nothing: no clock read, no event, no record; the call
still builds its keyword arguments, so a call site passes only what it
has at hand (``serve.call``'s counts, once a call). On, a span
records its name, its host start and end in `time.time_ns()` (the
clock `torch.profiler` stamps the device's operations with), its parent
and its call, and, where the process has initialised CUDA, a CUDA event
pair at its edges, read after one synchronise when the block ends.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch

_ENABLED = True

# (stage, key) -> {"calls", "first_calls", "first_s", "steady_s", "nbytes"}
_STATS: dict = {}

_FIELDS = ("calls", "first_calls", "first_s", "steady_s", "nbytes")


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def reset() -> None:
    _STATS.clear()


def record(stage: str, seconds: float, *, first: bool = False,
           key: tuple = (), nbytes: int = 0) -> None:
    """Attribute ``seconds`` of wall-clock to ``stage``. ``first=True``
    marks the first call with this key in the process (algorithm choice,
    kernel build, warm-up) — kept out of the steady-state bucket so short
    runs don't report one-time set-up as throughput. ``key`` carries the cost-model pricing inputs (e.g. (B, K)
    for a fused train launch); ``nbytes`` accumulates wire bytes for the
    byte-priced encode stages."""
    if not _ENABLED:
        return
    k = (stage, tuple(key))
    e = _STATS.get(k)
    if e is None:
        e = _STATS[k] = {"calls": 0, "first_calls": 0,
                         "first_s": 0.0, "steady_s": 0.0, "nbytes": 0}
    e["calls"] += 1
    if first:
        e["first_calls"] += 1
        e["first_s"] += seconds
    else:
        e["steady_s"] += seconds
    e["nbytes"] += int(nbytes)


def snapshot() -> dict:
    """Copy of the global stats — pair with `delta` to scope a run."""
    return {k: dict(v) for k, v in _STATS.items()}


def delta(snap: dict | None) -> dict:
    """Stats accumulated since ``snap`` (a `snapshot()` return); entries
    with no new calls are dropped."""
    snap = snap or {}
    out = {}
    for k, v in _STATS.items():
        base = snap.get(k)
        d = dict(v) if base is None else {f: v[f] - base[f] for f in _FIELDS}
        if d["calls"]:
            out[k] = d
    return out


def totals(stats: dict | None = None) -> dict:
    """Aggregate ``(stage, key)`` stats down to per-stage totals."""
    stats = _STATS if stats is None else stats
    out: dict = {}
    for (stage, _key), v in sorted(stats.items(),
                                   key=lambda kv: (kv[0][0], str(kv[0][1]))):
        e = out.setdefault(stage, {f: 0 for f in _FIELDS})
        for f in _FIELDS:
            e[f] += v[f]
    return out


def compile_s(stats: dict | None = None) -> float:
    """Total first-call (set-up + warm) seconds across all stages."""
    stats = _STATS if stats is None else stats
    return sum(v["first_s"] for v in stats.values())


def block(tree) -> None:
    """Synchronize: wait for the devices of every CUDA tensor in ``tree``
    before reading the clock, so a stage's recorded time covers its
    execution, not just its launch. CPU tensors run synchronously, so a
    tree with none on the card waits for nothing."""
    from repro_torch import tree as _tree

    devices = {leaf.device for leaf in _tree.leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


@dataclass(slots=True)
class Span:
    """One recorded span. ``start_ns``, ``end_ns``: the host's
    `time.time_ns()` on entering and leaving it. ``parent``: the index in
    the records of the span open when it began (None for an outermost
    span). ``call``: the index of the outermost span it lies in, its own
    for an outermost one, so that the spans of one `serve` call share it.
    ``device_ms``: the time between the CUDA events recorded at its edges
    on the current stream (None where no events were recorded)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    call: int
    attrs: dict
    device_ms: float | None = None


class _NoSpan:
    """What `span` returns while spans are off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Recording:
    """The records of one `spans()` block, the open spans' indices, and
    each record's CUDA event pair (where ``cuda``)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.records: list[Span] = []
        self.events: list[tuple] = []
        self.stack: list[int] = []

    def open(self, name: str, attrs: dict) -> int:
        i = len(self.records)
        parent = self.stack[-1] if self.stack else None
        call = i if parent is None else self.records[parent].call
        self.records.append(Span(name, time.time_ns(), 0, parent, call, attrs))
        if self.cuda:
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            pair[0].record()
            self.events.append(pair)
        self.stack.append(i)
        return i

    def close(self, i: int) -> None:
        if self.cuda:
            self.events[i][1].record()
        self.records[i].end_ns = time.time_ns()
        self.stack.pop()

    def finish(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            for rec, (start, end) in zip(self.records, self.events):
                rec.device_ms = start.elapsed_time(end)
            self.events.clear()


class _OpenSpan:
    __slots__ = ("rec", "name", "attrs", "index")

    def __init__(self, rec: _Recording, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.index = self.rec.open(self.name, self.attrs)
        return None

    def __exit__(self, *exc):
        self.rec.close(self.index)
        return False


_RECORDING: _Recording | None = None


def span(name: str, **attrs):
    """A context manager marking one layer boundary: recorded as a `Span`
    inside a `spans()` block, the shared no-op object outside one."""
    rec = _RECORDING
    if rec is None:
        return _NO_SPAN
    return _OpenSpan(rec, name, attrs)


@contextlib.contextmanager
def spans():
    """Turn spans on for the ``with`` block and yield the list their
    records go into, in the order they began. When the block ends, spans
    are off again and, where CUDA events were recorded, each record's
    ``device_ms`` is filled after one synchronise. One block at a time."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError("spans are already being recorded")
    rec = _RECORDING = _Recording(torch.cuda.is_initialized())
    try:
        yield rec.records
    finally:
        _RECORDING = None
        rec.finish()
