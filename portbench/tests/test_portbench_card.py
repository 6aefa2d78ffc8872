"""On the card: the smoke cells run through the harness (kernels built,
the bf16 routes on the card's kernels), traced, with a result line's
keys. Skips on a host without one; on the card host run

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


@pytest.mark.parametrize("cell", ["whisper-smoke.transcribe_tiny", "rwkv6-smoke.prefill_tiny"])
def test_smoke_cell_on_card(tmp_path, dev, cell):
    cells = smoke_cells()
    w = cells["whisper-smoke.transcribe_tiny"]
    cells["whisper-smoke.transcribe_tiny"] = w[:3] + (CARD_WHISPER,) + w[4:]
    r = harness.run_cell(harness.Bench(scratch_root(tmp_path, cells)), cell, 7, 0.5, True, dev)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0 and r["device"]["memory_peak_bytes"] > 0
    assert list(r)[-1] == "checks" and r["breakdown"]["device_ops"]
