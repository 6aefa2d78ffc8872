"""The references against the port's plain path at smoke size in
float32 (whole runs of the harness on the CPU), the chunked wkv against
the recurrence step by step, and the control: the reference in float8
put in the port's place reads far above the bfloat16 port."""
from __future__ import annotations

import pytest
import torch
from portbench_scratch import RWKV_SMOKE, WHISPER_SMOKE, scratch_root, smoke_cells

from portbench import compare, harness
from portbench.reference import rwkv6
from portbench.reference.common import Precision

CELLS = list(smoke_cells())


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_port_float32(smoke_root, cell):
    r = harness.run_cell(harness.Bench(smoke_root), cell, 2**31 + 99, 0.05, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["checks"]["logits_rel"]["value"] < 1e-5
    assert r["checks"]["token_excess"]["value"] <= 0.0 and r["notes"]["token_gap"] == 0.0
    assert r["failed"] == 0 and r["attempted"] >= 4


def test_wkv_chunks_equal_recurrence():
    g = torch.Generator().manual_seed(0)
    R, T, H, P = 2, 150, 3, 4  # 150: two whole chunks and a partial one
    r, k, v = (torch.randn(R, T, H, P, generator=g) for _ in range(3))
    logw = -torch.exp(torch.randn(R, T, H, P, generator=g) - 1.0)
    u = torch.randn(H, P, generator=g)
    torch.testing.assert_close(rwkv6.wkv(r, k, v, logw, u), rwkv6.wkv_steps(r, k, v, logw, u),
                               rtol=1e-4, atol=1e-4)  # float32 sums over 150 steps


def test_fp8_cast_rounds():
    x = torch.linspace(-3, 3, 101)
    y = Precision("fp8").cast(x)
    assert not torch.equal(x, y) and float((x - y).abs().max()) < 3 * 2**-3
    assert torch.equal(Precision().cast(x), x)
    with pytest.raises(ValueError):
        Precision("int4")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_port_passes(tmp_path, cell):
    """At smoke size in bfloat16 the control's logits read 3x the port's
    or more, on three seeds."""
    bf16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
    cells = {name: c[:3] + (dict(c[3], **bf16),) + c[4:] for name, c in smoke_cells().items()}
    bench = harness.Bench(scratch_root(tmp_path, cells))
    for seed in (1, 2, 3):
        s = harness.Session(bench, cell, seed, "cpu", rows_per_call=4)
        try:
            got = compare.readings(s, [s.call(0), s.call(1)], 8, 4, control=True)
        finally:
            s.close()
        assert got["control_logits_rel"] >= 3 * got["logits_rel"], got


def test_calibrate_reads_port_and_control(smoke_root, capsys):
    """The script that reads the limits' readings on the card, on the CPU:
    one line a seed, the control's beside the port's on the first."""
    import json

    from portbench import calibrate

    assert calibrate.main(["--workload", CELLS[0], "--seeds", "4,5", "--control", "1"],
                          root=smoke_root, device="cpu") == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines] == [4, 5] and all(x["finite"] for x in lines)
    assert "control_logits_rel" in lines[0] and "control_logits_rel" not in lines[1]
    assert lines[0]["control_logits_rel"] > 100 * lines[0]["logits_rel"]  # float32 port


def test_smoke_configs_are_the_ports_smoke_widths():
    from repro_torch.configs import get_smoke

    w, r = get_smoke("whisper-large-v3"), get_smoke("rwkv6-3b")
    assert WHISPER_SMOKE["pattern"] == list(w.pattern) and RWKV_SMOKE["pattern"] == list(r.pattern)
