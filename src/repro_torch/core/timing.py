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
"""
from __future__ import annotations

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
