"""On the card: the port's spans as the benchmark reads them. A smoke
cell's span pass shares the profiler's clock, the smoke cells report the
span metrics, and each ``rwkv6.wkv_chunked`` span encloses what
`scan_share.prefill` times. Skips on a host without one; on the card
host run

    PYTHONPATH=src python -m pytest -q -m cuda portbench/tests
"""
from __future__ import annotations

import pytest
import torch

from portbench_scratch import WHISPER_SMOKE, scratch_root, smoke_cells

from portbench import harness

pytestmark = pytest.mark.cuda
# K4 takes head dims 64, 112, 128 and 256: the card's smoke Whisper has 64
CARD_WHISPER = dict(WHISPER_SMOKE, d_model=128, num_heads=2, num_kv_heads=2, head_dim=64)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


SLACK_NS = 50_000  # 50 us


@pytest.mark.parametrize("cell", ["whisper-smoke.transcribe_tiny", "rwkv6-smoke.prefill_tiny"])
def test_span_pass_shares_the_profilers_clock(tmp_path, dev, cell):
    """Every device operation of a span pass lies inside some ``serve.call``
    span's [start, end] within 50 us: the spans' host clock and the
    profiler's device clock agree. The prefill's idle share is no greater
    than the pass's whole idle share."""
    import bisect

    from portbench import spans

    cells = smoke_cells()
    w = cells["whisper-smoke.transcribe_tiny"]
    cells["whisper-smoke.transcribe_tiny"] = w[:3] + (CARD_WHISPER,) + w[4:]
    session = harness.Session(harness.Bench(scratch_root(tmp_path, cells)), cell, 11, dev)
    try:
        session.call(-1)
        p = spans.trace_calls(session, 0.5)
    finally:
        session.close()
    calls = sorted((r.start_ns, r.end_ns) for r in p["records"] if r.name == "serve.call")
    assert p["intervals"] and len(calls) == p["calls"] >= 2
    starts = [a for a, _ in calls]
    outside = []
    for name, start, end in p["intervals"]:
        i = bisect.bisect_right(starts, start + SLACK_NS) - 1
        if i < 0 or end > calls[i][1] + SLACK_NS:
            outside.append((name, start - (calls[i][0] if i >= 0 else 0), end))
    assert not outside, outside[:5]
    assert all(r.device_ms is not None and r.device_ms >= 0 for r in p["records"])
    idle = spans.idle_under(p["idle"], p["records"], "serve.prefill")
    trace = p["trace"]
    assert 0 <= idle <= trace["window_s"] - trace["busy_s"] + 1e-9
    assert sum(p["idle"].values()) / 1e9 == pytest.approx(trace["window_s"] - trace["busy_s"],
                                                         abs=1e-6)


@pytest.mark.parametrize("cell,metrics", [
    ("whisper-smoke.transcribe_tiny", ["encoder_ms.prefill", "decode_attn_share.decode",
                                       "decode_step_p95_ms", "step_idle_share.prefill"]),
    ("rwkv6-smoke.prefill_tiny", ["wkv_share.prefill", "step_idle_share.prefill",
                                  "scan_idle_share.prefill", "scan_share.prefill"])])
def test_smoke_cell_reports_the_span_metrics(tmp_path, dev, cell, metrics):
    cells = smoke_cells()
    w = cells["whisper-smoke.transcribe_tiny"]
    cells["whisper-smoke.transcribe_tiny"] = w[:3] + (CARD_WHISPER,) + w[4:]
    r = harness.run_cell(harness.Bench(scratch_root(tmp_path, cells)), cell, 13, 0.5, True, dev)
    assert r["correct"], r["checks"]
    assert set(metrics) <= set(r["metrics"]), r["metrics"]
    if cell.startswith("rwkv6"):
        # the window (scan_share) and the span pass (wkv_share) are different calls
        assert 0 < r["metrics"]["wkv_share.prefill"]["value"] <= 100


def test_wkv_span_encloses_what_scan_share_times(tmp_path, dev):
    """In one span pass with `scan_share.prefill`'s wrapper on as well,
    each ``rwkv6.wkv_chunked`` span times one wrapped call and encloses
    its CUDA events: the span reads what the metric it succeeds read."""
    from portbench import spans

    bench = harness.Bench(scratch_root(tmp_path, smoke_cells()))
    scan_share = bench.module("metrics", "scan_share.prefill")
    session = harness.Session(bench, "rwkv6-smoke.prefill_tiny", 17, dev)
    extra = {}
    try:
        session.call(-1)
        with scan_share.instrument(extra):
            p = spans.trace_calls(session, 0.5)
    finally:
        session.close()
    wrapped = [a.elapsed_time(b) for a, b in extra[scan_share.KEY]]
    ms = spans.device_ms(p, "rwkv6.wkv_chunked")
    assert len(ms) == len(wrapped) == p["calls"] * session.cfg.num_layers > 0
    assert all(s >= w - 2e-3 for s, w in zip(ms, wrapped)), list(zip(ms, wrapped))[:5]
