"""The benchmark's files: BENCHMARK.json against the contract's shapes,
every file it names there and resolvable by name, each metric reader's
declarations equal to its entry, and a cell added as new files alone."""
from __future__ import annotations

import json
import math
import re

import pytest
from portbench_scratch import REPO, scratch_root, smoke_cells

from portbench import harness

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_spec_shapes():
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names) and len(set(CELLS)) == len(CELLS)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in names
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in SPEC["end_to_end"]]
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in [(v["config"], v["traffic"])
                                                   for v in SPEC["workloads"] if v is not w]
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_it_must(cell):
    """Each cell: setup_s, another end-to-end metric, a per-layer one, and
    every per-layer metric's end-to-end metric beside it."""
    bench = harness.Bench(REPO)
    e2e = {m["name"] for m in bench.metrics(cell, False)}
    layer = bench.metrics(cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_resolves(metric):
    spec = next(m for m in METRICS if m["name"] == metric)
    mod = harness.Bench(REPO).module("metrics", metric)
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (spec["unit"], spec["better"], spec["source"])
    if "layer" in spec:
        assert (mod.LAYER, mod.MOVES) == (spec["layer"], spec["moves"])
    assert callable(mod.read)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    """The cell's config, mix, driver, workload, reference and counts by
    name; the config's sizes are the port's config as run, and the weight
    table has the port's parameter tree (shapes only: nothing drawn)."""
    from repro_torch.models.registry import build

    bench = harness.Bench(REPO)
    entry = bench.cell(cell)
    config = bench.data("configs", entry["config"])
    conf_entry = next(c for c in SPEC["configs"] if c["name"] == entry["config"])
    assert conf_entry["file"] == f"portbench/configs/{entry['config']}.json"
    assert config["reduced"] == conf_entry["reduced"]
    mix = bench.data("traffic", entry["traffic"])
    work = bench.data("workloads", cell)
    assert (work["config"], work["traffic"]) == (entry["config"], entry["traffic"])
    assert set(work["check"]["limits"]) == {"logits_rel", "token_excess"}
    assert work["check"]["limits"]["token_excess"] == 0.0  # exact by construction
    cfg = harness.port_config(config)
    for key, value in config["model"].items():
        assert getattr(cfg, key) == (tuple(value) if isinstance(value, list) else value)
    assert bench.module("traffic", mix["driver"]).Traffic
    ref = bench.module("reference", config["arch"])
    table = {p: tuple(s["shape"]) for p, s in harness.walk(ref.weights(config["model"]))}
    metas = {p: tuple(m.shape) for p, m in harness.walk(build(cfg).metas())}
    assert table == metas
    flops = bench.module("flops", config["arch"])
    assert flops.prefill(config["model"], mix["batch"], mix["prompt_tokens"],
                         mix["memory_positions"])["flops"] > 0


def test_published_sizes():
    """The two configurations hold their published widths and depths."""
    bench = harness.Bench(REPO)
    w = bench.data("configs", "whisper-large-v3")["model"]
    assert (w["num_layers"], w["encoder_layers"], w["d_model"], w["num_heads"], w["head_dim"],
            w["d_ff"], w["vocab_size"], w["num_xattn_tokens"]) == (32, 32, 1280, 20, 64, 5120,
                                                                    51866, 1500)
    r = bench.data("configs", "rwkv6-3b")["model"]
    assert (r["num_layers"], r["d_model"], r["ssm_head_dim"], r["d_ff"],
            r["vocab_size"]) == (32, 2560, 64, 8960, 65536)
    weights = harness.Bench(REPO).module("reference", "whisper").weights(w)
    assert sum(math.prod(s["shape"]) for _, s in harness.walk(weights)) == 1_534_602_240


def test_scratch_cell_is_files_alone(tmp_path):
    """A cell, configuration and per-layer metric added as new files in a
    copy of the folder are found by name, with no file edited."""
    root = scratch_root(tmp_path, smoke_cells())
    (root / "portbench" / "metrics" / "calls_in_window.py").write_text(
        'UNIT, BETTER, SOURCE = "1", "higher", "host_clock"\n'
        'LAYER, MOVES = "launch.serve (host)", "prefill_tok_per_s"\n'
        "def read(run):\n    return len(run.calls)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "calls_in_window", "unit": "1", "better": "higher",
                              "source": "host_clock", "layer": "launch.serve (host)",
                              "moves": "prefill_tok_per_s",
                              "workloads": ["rwkv6-smoke.prefill_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(root)
    assert "calls_in_window" in [m["name"] for m in bench.metrics("rwkv6-smoke.prefill_tiny",
                                                                  True)]
    r = harness.run_cell(bench, "rwkv6-smoke.prefill_tiny", 5, 0.05, True, "cpu")
    assert r["metrics"]["calls_in_window"]["value"] >= 1 and r["correct"]
    for path in (REPO / "portbench").rglob("*"):
        if path.is_file() and "tests" not in path.parts and "__pycache__" not in path.parts:
            assert (root / path.relative_to(REPO)).read_bytes() == path.read_bytes()
