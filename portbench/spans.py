#!/usr/bin/env python3
"""The port's own spans (`repro_torch.core.timing.span`) as the metrics
read them.

The harness's measured window and its own trace run with spans off, so
that no metric read there sees them. After both, whole `serve` calls
run again with spans on, in segments of `harness.TRACE_SECONDS` until
they hold `PASS_CALLS` calls or their calls have run `PASS_SECONDS`,
twice at most: `span_times` without the profiler, for the spans' device
milliseconds (`device_ms`; the profiler's work on each launch would
slow the host-paced code in them), and `span_pass` with each segment
under its own CUDA-only `torch.profiler`, as the harness's trace (one
RWKV-6 prefill is as much as the tracer's buffers keep whole), for each
interval in which the device sat idle put down to the host's innermost
open span at each instant (`idle_by_span`): the time the device waited
on the code in that span, not on the code below it. Each runs only
where a metric of the cell reads it.

    python3 portbench/spans.py --workload <cell> --seed <n>

runs one cell's set-up, its warm-up call and a span pass on the card and
prints the pass as one JSON line: the device's busy and window seconds
and its idle seconds by span name, ``outside`` holding the idle time
while the host was in no span (between calls), and by span name with
the spans inside each counted in (``idle_under_s``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

_TIMES, _PASS = "span_times", "span_pass"  # run.extra[...]: each, once run
OUTSIDE = "outside"
PASS_CALLS = 3  # the pass ends once it holds this many calls...
PASS_SECONDS = 12.0  # ...or its calls have run this long: 3 prefill_8k, 2 transcribe_b64 calls


def device_ms(p: dict | None, name: str) -> list[float]:
    """The device milliseconds of the spans called ``name`` in ``p`` (a
    `trace_pass`), in the order they began; empty where there is no
    ``p`` or no such span."""
    return [r.device_ms for r in (p or {}).get("records", ()) if r.name == name]


def idle_intervals(intervals: list[tuple[str, int, int]]) -> list[tuple[int, int]]:
    """(start ns, end ns) of each gap in the union of the device's
    operations (``tracing.device_intervals``), from the first operation's
    start to the last one's end, in order."""
    gaps = []
    ivs = sorted((start, end) for _, start, end in intervals)
    cur = ivs[0][1] if ivs else 0
    for start, end in ivs:
        if start > cur:
            gaps.append((cur, start))
        cur = max(cur, end)
    return gaps


def host_segments(records: list) -> list[tuple[int, int, int]]:
    """(start ns, end ns, index) pieces of the host's time, in order, each
    labelled by the index of the innermost span open over it; the time
    outside every span is left out."""
    edges = sorted([(r.start_ns, 1, i) for i, r in enumerate(records)]
                   + [(r.end_ns, 0, i) for i, r in enumerate(records)])
    out, stack, prev = [], [], None
    for t, opens, i in edges:
        if stack and t > prev:
            out.append((prev, t, stack[-1]))
        prev = t
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    return out


def idle_by_span(intervals: list[tuple[str, int, int]], records: list) -> dict:
    """The device's idle nanoseconds put down to the host's innermost
    open span at each instant: {span index: ns}, and {None: ns} for the
    idle time while the host was in no span. The values sum to the idle
    time of the device's window."""
    segs = host_segments(records)
    out = defaultdict(int)
    j = 0
    for a, b in idle_intervals(intervals):
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] += hi - lo
                covered += hi - lo
            k += 1
        if b - a > covered:
            out[None] += b - a - covered
    return dict(out)


def by_name(idle: dict, records: list) -> dict:
    """`idle_by_span`'s nanoseconds summed by span name into seconds,
    the time in no span under `OUTSIDE`."""
    out = defaultdict(float)
    for i, ns in idle.items():
        out[OUTSIDE if i is None else records[i].name] += ns / 1e9
    return dict(out)


def idle_under(idle: dict, records: list, name: str) -> float | None:
    """Seconds of `idle_by_span`'s time while the host's innermost span
    was one called ``name`` or lay inside one; None where no span has
    that name."""
    under = []
    for r in records:  # a parent comes before its children
        under.append(r.name == name or (r.parent is not None and under[r.parent]))
    if not any(under):
        return None
    return sum(ns for i, ns in idle.items() if i is not None and under[i]) / 1e9


def trace_calls(session, seconds: float, profiled: bool = True) -> dict:
    """Whole `serve` calls on one call's inputs (drawn before the trace),
    back to back until one ends ``seconds`` or more after the first began,
    with spans on, no logits kept, under `torch.profiler` (the device's
    activity only) where ``profiled``. Returns {"trace": `tracing.summarize`
    of the device's operations, "intervals": them, "records": the spans,
    "idle": `idle_by_span`, "calls", "host_s"}; without the profiler no
    trace, no intervals and nothing idle."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import tracing
    from repro_torch.core import timing

    tracer = (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext())

    prompt, memory = session.traffic.inputs(-2)  # no call of the window draws -2

    def call(_):
        return session.serve(session.cfg, session.params, prompt, session.traffic.new_tokens,
                             session.device, memory=memory)

    rows, session.keep.rows = session.keep.rows, None
    try:
        with timing.spans() as records:
            with tracer as prof:
                calls, host_s = session.traffic.drive(call, seconds)
    finally:
        session.keep.rows = rows
    intervals = tracing.device_intervals(prof) if profiled else []
    return {"trace": tracing.summarize(intervals), "intervals": intervals, "records": records,
            "idle": idle_by_span(intervals, records), "calls": len(calls), "host_s": host_s}


def merge(parts: list[dict]) -> dict:
    """`trace_calls`' results as one pass: the records in order, each
    index in them (a record's parent and call, `idle`'s keys) moved past
    the earlier parts' records; the device's busy and window seconds,
    the calls and the host seconds summed over the parts (the time
    between two parts lies in no window)."""
    records, idle = [], defaultdict(int)
    out = {"busy_s": 0.0, "window_s": 0.0, "calls": 0, "host_s": 0.0, "segments": len(parts)}
    for p in parts:
        off = len(records)
        records += [dataclasses.replace(r, call=r.call + off,
                                        parent=None if r.parent is None else r.parent + off)
                    for r in p["records"]]
        for i, ns in p["idle"].items():
            idle[None if i is None else i + off] += ns
        if p["trace"]:
            out["busy_s"] += p["trace"]["busy_s"]
            out["window_s"] += p["trace"]["window_s"]
        out["calls"] += p["calls"]
        out["host_s"] += p["host_s"]
    out.update(records=records, idle=dict(idle))
    return out


def trace_pass(session, segment: float, calls: int = PASS_CALLS,
               seconds: float = PASS_SECONDS, profiled: bool = True) -> dict:
    """`trace_calls` segments of ``segment`` seconds, each under its own
    profiler where ``profiled``, until they hold ``calls`` calls or their
    calls have run ``seconds`` on the host's clock (the profiler's own
    work between segments left out), `merge`d into one pass."""
    parts = []
    while True:
        parts.append(trace_calls(session, segment, profiled))
        if (sum(p["calls"] for p in parts) >= calls
                or sum(p["host_s"] for p in parts) >= seconds):
            return merge(parts)


def _once(run, key: str, profiled: bool) -> dict | None:
    from portbench import harness
    from repro_torch.core import timing

    if not run.trace or not hasattr(timing, "spans"):
        return None
    if key not in run.extra:
        run.extra[key] = trace_pass(run.session, harness.TRACE_SECONDS, profiled=profiled)
    return run.extra[key]


def span_times(run) -> dict | None:
    """`trace_pass` without the profiler, in segments of
    `harness.TRACE_SECONDS`, run once a run, after the harness's own
    trace (so no other metric reads it); None where the run has no such
    trace (no card) or the port has no spans."""
    return _once(run, _TIMES, profiled=False)


def span_pass(run) -> dict | None:
    """`trace_pass` under the profiler, as `span_times` otherwise; None
    also where the pass's traces hold no device operation."""
    p = _once(run, _PASS, profiled=True)
    return p if p is not None and p["window_s"] > 0 else None


def idle_share_under(run, name: str) -> float | None:
    """The span pass's idle time while the host's innermost span is
    ``name`` or one inside it, over the pass's windows, in percent."""
    p = span_pass(run)
    idle = None if p is None else idle_under(p["idle"], p["records"], name)
    return None if idle is None else 100.0 * idle / p["window_s"]


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    from pathlib import Path

    import torch

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    session = harness.Session(harness.Bench(Path(__file__).resolve().parents[1]), args.workload,
                              args.seed, "cuda")
    try:
        session.call(-1)  # warm-up
        p = trace_pass(session, harness.TRACE_SECONDS)
    finally:
        session.close()
    if not p["window_s"]:
        print("portbench.spans: the trace holds no device operation", file=sys.stderr)
        return 1
    idle = by_name(p["idle"], p["records"])
    names = sorted({r.name for r in p["records"]})
    print(json.dumps({"workload": args.workload, "seed": args.seed, "calls": p["calls"],
                      "segments": p["segments"], "busy_s": p["busy_s"],
                      "window_s": p["window_s"],
                      "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
                      "idle_under_s": {n: idle_under(p["idle"], p["records"], n) for n in names},
                      "device": torch.cuda.get_device_name(0),
                      "power_limit": harness.power_limit()}))
    return 0


if __name__ == "__main__":
    import sys
    from pathlib import Path

    _root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_root), str(_root / "src")]
    sys.exit(main())
