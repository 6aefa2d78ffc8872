"""The benchmark's reading of the port's spans (`portbench/spans.py` and
the metrics that read it), on the CPU: the idle attribution on synthetic
intervals against a nanosecond-by-nanosecond count, the readers'
arithmetic on a synthetic span pass, their None where a run has no
spans, and the span passes' calls, segments and merge."""
from __future__ import annotations

import random
from types import SimpleNamespace

import pytest
from portbench_scratch import REPO, scratch_root, smoke_cells

from portbench import harness, spans
from repro_torch.core import timing

NEW = ["encoder_ms.prefill", "wkv_share.prefill", "decode_attn_share.decode",
       "decode_step_p95_ms", "step_idle_share.prefill", "scan_idle_share.prefill"]


def _span(name, start, end, parent=None, device_ms=None):
    return timing.Span(name, start, end, parent, 0, {}, device_ms)


def test_idle_attribution_innermost_wins_and_sums_to_the_idle_time():
    # device busy [0, 10], [20, 30], [50, 60]: idle (10, 20) and (30, 50)
    ops = [("k", 0, 10), ("k", 20, 30), ("k", 50, 60)]
    records = [_span("A", 0, 35), _span("B", 12, 18, parent=0), _span("C", 40, 70)]
    idle = spans.idle_by_span(ops, records)
    assert idle == {0: 9, 1: 6, None: 5, 2: 10}
    assert sum(idle.values()) == 30
    assert spans.by_name(idle, records) == pytest.approx(
        {"A": 9e-9, "B": 6e-9, "C": 10e-9, spans.OUTSIDE: 5e-9})
    assert spans.idle_under(idle, records, "A") == pytest.approx(15e-9)  # A and B inside it
    assert spans.idle_under(idle, records, "B") == pytest.approx(6e-9)
    assert spans.idle_under(idle, records, "D") is None
    assert spans.idle_intervals(ops) == [(10, 20), (30, 50)]
    assert spans.idle_by_span([("k", 0, 5)], records) == {}  # no gap, nothing idle


def _nested(rng, lo, hi, parent, out, depth=0):
    """Random properly nested spans over [lo, hi), as one host thread opens them."""
    t = lo
    while t < hi - 2 and rng.random() < 0.7:
        a = rng.randrange(t, hi - 1)
        b = rng.randrange(a + 1, hi)
        out.append(_span(f"s{depth}", a, b, parent))
        if depth < 3:
            _nested(rng, a, b, len(out) - 1, out, depth + 1)
        t = b


@pytest.mark.parametrize("seed", range(20))
def test_idle_attribution_matches_a_count_by_the_nanosecond(seed):
    rng = random.Random(seed)
    T = 200
    records = []
    _nested(rng, 0, T, None, records)
    ops = []
    for _ in range(rng.randrange(1, 12)):
        a = rng.randrange(0, T - 1)
        ops.append(("k", a, rng.randrange(a + 1, min(T, a + 30) + 1)))
    first, last = min(s for _, s, _ in ops), max(e for _, _, e in ops)
    want = {}
    for t in range(first, last):
        if any(s <= t < e for _, s, e in ops):
            continue
        open_ = [i for i, r in enumerate(records) if r.start_ns <= t < r.end_ns]
        key = max(open_) if open_ else None  # nested: the last begun is the innermost
        want[key] = want.get(key, 0) + 1
    got = spans.idle_by_span(ops, records)
    assert got == want
    busy = sum(1 for t in range(first, last) if any(s <= t < e for _, s, e in ops))
    assert sum(got.values()) == last - first - busy


def _run(records=None, idle=None, window_s=1.0):
    """A traced run whose span times and span pass hold ``records``
    (none: neither has run)."""
    extra = {}
    if records is not None:
        extra[spans._PASS] = {"records": records, "idle": idle or {}, "window_s": window_s}
        extra[spans._TIMES] = extra[spans._PASS]
    return SimpleNamespace(extra=extra, trace={"calls": 1}, calls=[], session=None)


def _reader(name):
    return harness.Bench(REPO).module("metrics", name)


@pytest.mark.parametrize("metric", NEW)
def test_reader_is_none_without_spans(metric):
    read = _reader(metric).read
    assert read(_run(records=[])) is None
    assert read(_run(records=[], window_s=0.0)) is None
    assert read(SimpleNamespace(extra=None, trace=None, calls=[], session=None)) is None


def test_window_readers_on_synthetic_records():
    steps = [_span("serve.decode_step", 0, 1, device_ms=10.0 + i) for i in range(40)]
    records = [_span("serve.prefill", 0, 1, device_ms=100.0),
               _span("transformer.encode", 0, 1, device_ms=80.0),
               _span("rwkv6.wkv_chunked", 0, 1, device_ms=45.0),
               _span("rwkv6.wkv_chunked", 0, 1, device_ms=45.0),
               _span("serve.prefill", 0, 1, device_ms=100.0),
               _span("transformer.encode", 0, 1, device_ms=70.0),
               _span("attention.decode_self", 0, 1, device_ms=200.0),
               _span("attention.decode_cross", 0, 1, device_ms=100.0)] + steps
    run = _run(records)
    assert _reader("encoder_ms.prefill").read(run) == pytest.approx(75.0)
    assert _reader("wkv_share.prefill").read(run) == pytest.approx(45.0)
    step_ms = sum(s.device_ms for s in steps)
    assert _reader("decode_attn_share.decode").read(run) == pytest.approx(100 * 300 / step_ms)
    # inclusive 95th percentile of 10..49: 10 + 0.95 * 39
    assert _reader("decode_step_p95_ms").read(run) == pytest.approx(10 + 0.95 * 39)


def test_pass_readers_on_a_synthetic_pass():
    records = [_span("serve.call", 0, 100), _span("serve.prefill", 10, 90, parent=0),
               _span("rwkv6.wkv_chunked", 20, 60, parent=1)]
    ops = [("k", 0, 5), ("k", 30, 40), ("k", 95, 100)]
    run = _run(records, spans.idle_by_span(ops, records), window_s=100e-9)
    p = run.extra[spans._PASS]
    # idle (5, 30) and (40, 95): in the prefill (10-30, 40-90) 70, in the scan (20-30, 40-60) 30
    assert _reader("step_idle_share.prefill").read(run) == pytest.approx(70.0)
    assert _reader("scan_idle_share.prefill").read(run) == pytest.approx(30.0)
    assert sum(p["idle"].values()) == 80  # the pass's whole idle time: 80% of its window


def test_merge_moves_each_segments_indices_past_the_earlier_ones():
    ops = [("k", 0, 5), ("k", 30, 40), ("k", 95, 100)]
    parts = []
    for _ in range(2):
        records = [_span("serve.call", 0, 100), _span("serve.prefill", 10, 90, parent=0),
                   _span("rwkv6.wkv_chunked", 20, 60, parent=1)]
        parts.append({"trace": {"busy_s": 20e-9, "window_s": 100e-9}, "records": records,
                      "idle": spans.idle_by_span(ops, records), "calls": 1, "host_s": 1.0})
    parts.append({"trace": None, "records": [], "idle": {}, "calls": 0, "host_s": 0.5})
    p = spans.merge(parts)
    assert [(r.parent, r.call) for r in p["records"]] == [(None, 0), (0, 0), (1, 0),
                                                          (None, 3), (3, 3), (4, 3)]
    assert p["idle"] == {0: 10, 1: 40, 2: 30, 3: 10, 4: 40, 5: 30}
    assert (p["calls"], p["segments"], p["host_s"]) == (2, 3, 2.5)
    assert p["busy_s"] == pytest.approx(40e-9) and p["window_s"] == pytest.approx(200e-9)
    assert spans.idle_under(p["idle"], p["records"], "serve.prefill") == pytest.approx(140e-9)
    run = _run(p["records"], p["idle"], p["window_s"])
    assert _reader("step_idle_share.prefill").read(run) == pytest.approx(70.0)
    assert _reader("scan_idle_share.prefill").read(run) == pytest.approx(30.0)
    assert parts[0]["records"][0].call == 0 and parts[1]["records"][1].parent == 0  # untouched


@pytest.mark.parametrize("cell", ["whisper-smoke.transcribe_tiny", "rwkv6-smoke.prefill_tiny"])
def test_cpu_traced_run_reports_no_span_metric(smoke_root, cell):
    """On the CPU there is no trace and so no span pass: the six readers
    return None and the line leaves them out."""
    bench = harness.Bench(smoke_root)
    assert set(NEW) & {m["name"] for m in bench.metrics(cell, True)}
    r = harness.run_cell(bench, cell, 2**31 + 11, 0.05, True, "cpu")
    assert r["correct"] and not set(NEW) & set(r["metrics"])


def test_span_pass_runs_whole_serve_calls(tmp_path, monkeypatch):
    """The span pass's control flow on the CPU, the profiler stubbed (it
    traces nothing without a card): whole `serve` calls on one call's
    inputs, each a tree under its own ``serve.call``, no logits kept and
    the session's kept rows given back."""
    import contextlib

    import torch.profiler

    from portbench import tracing

    monkeypatch.setattr(torch.profiler, "profile", lambda **k: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "device_intervals", lambda prof: [])
    bench = harness.Bench(scratch_root(tmp_path, smoke_cells()))
    session = harness.Session(bench, "whisper-smoke.transcribe_tiny", 3, "cpu")
    try:
        session.call(-1)
        rows, kept = session.keep.rows, list(session.keep.kept)
        p = spans.trace_calls(session, 0.05)
        assert session.keep.rows is rows and len(session.keep.kept) == len(kept)
    finally:
        session.close()
    assert p["trace"] is None and p["idle"] == {} and p["calls"] >= 1
    calls = [r for r in p["records"] if r.name == "serve.call"]
    assert len(calls) == p["calls"]
    assert [r.call for r in p["records"] if r.parent is None] == [
        i for i, r in enumerate(p["records"]) if r.parent is None]
    assert calls[0].attrs["batch"] == session.traffic.batch


def test_span_times_run_without_the_profiler(tmp_path, monkeypatch):
    """`span_times`' calls: spans on, the profiler never entered, whole
    calls until the pass holds its calls."""
    import torch.profiler

    def no_profiler(**k):
        raise AssertionError("profiled")

    monkeypatch.setattr(torch.profiler, "profile", no_profiler)
    bench = harness.Bench(scratch_root(tmp_path, smoke_cells()))
    session = harness.Session(bench, "rwkv6-smoke.prefill_tiny", 5, "cpu")
    try:
        session.call(-1)
        p = spans.trace_pass(session, 0.01, calls=2, seconds=60.0, profiled=False)
    finally:
        session.close()
    assert p["calls"] >= 2 and p["window_s"] == 0 and p["idle"] == {}
    assert len(spans.device_ms(p, "serve.call")) == p["calls"]
    assert len(spans.device_ms(p, "rwkv6.wkv_chunked")) == p["calls"] * session.cfg.num_layers


def test_each_pass_runs_once_and_only_for_its_readers(monkeypatch):
    ran = []

    def fake(session, segment, calls=3, seconds=12.0, profiled=True):
        ran.append(profiled)
        return {"records": [], "idle": {}, "window_s": 1.0 if profiled else 0.0, "calls": 1}

    monkeypatch.setattr(spans, "trace_pass", fake)
    run = SimpleNamespace(extra={}, trace={"calls": 1}, calls=[], session=None)
    for metric in ["encoder_ms.prefill", "wkv_share.prefill"]:
        assert _reader(metric).read(run) is None
    assert ran == [False] and set(run.extra) == {spans._TIMES}
    for metric in ["step_idle_share.prefill", "scan_idle_share.prefill"]:
        assert _reader(metric).read(run) is None
    assert ran == [False, True] and set(run.extra) == {spans._TIMES, spans._PASS}


@pytest.mark.parametrize("per_segment,calls,seconds,segments", [
    (1, 3, 60.0, 3),  # one long call a segment: three segments
    (11, 3, 60.0, 1),  # short calls: one segment holds them
    (1, 3, 0.0, 1),  # out of time after the first
])
def test_trace_pass_runs_segments_until_it_holds_its_calls(monkeypatch, per_segment, calls,
                                                           seconds, segments):
    seen = []

    def fake(session, segment, profiled=True):
        seen.append(segment)
        return {"trace": {"busy_s": 1.0, "window_s": 2.0}, "records": [], "idle": {},
                "calls": per_segment, "host_s": 2.0}

    monkeypatch.setattr(spans, "trace_calls", fake)
    p = spans.trace_pass(None, 0.25, calls, seconds)
    assert seen == [0.25] * segments and p["segments"] == segments
    assert p["calls"] == per_segment * segments and p["window_s"] == 2.0 * segments


def test_a_port_without_spans_reads_none(monkeypatch):
    """Laid over a port that has no spans (the parent of the change that
    added them), the span pass does not run and every reader returns
    None without raising."""
    monkeypatch.delattr(timing, "spans")
    run = SimpleNamespace(extra={}, trace={"calls": 1}, calls=[], session=None)
    assert spans.span_pass(run) is None and spans.span_times(run) is None and run.extra == {}
    for metric in NEW:
        assert _reader(metric).read(run) is None
