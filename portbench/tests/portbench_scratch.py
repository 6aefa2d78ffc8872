"""Scratch benchmarks for the CPU tests: the real folder's files copied
into a temporary root, with smoke-size configurations, mixes and cells
added as files beside them, as a later change would add its own."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

WHISPER_SMOKE = {
    "num_layers": 2, "encoder_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
    "head_dim": 16, "d_ff": 128, "vocab_size": 256, "num_xattn_tokens": 24,
    "pattern": ["attn_xattn"], "norm": "layer", "mlp_act": "gelu", "pos": "sinusoidal",
    "param_dtype": "float32", "compute_dtype": "float32"}
RWKV_SMOKE = {
    "num_layers": 2, "d_model": 64, "ssm_head_dim": 16, "d_ff": 128, "vocab_size": 256,
    "pattern": ["rwkv"], "norm": "layer", "pos": "none",
    "param_dtype": "float32", "compute_dtype": "float32"}
# float32 on both sides: the readings are float32 round-off, far under these
SMOKE_LIMITS = {"logits_rel": 1e-4, "token_excess": 0.0}



def scratch_root(tmp: Path, cells: dict) -> Path:
    """A root holding a copy of the benchmark's folder (its tests left
    out) and a BENCHMARK.json of its own, with each of ``cells`` (name ->
    (config name, arch, port arch, model dict, mix dict, check dict))
    added as new files."""
    root = tmp / "root"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for cell, (config, arch, port_arch, model, mix, check) in cells.items():
        traffic = cell.split(".", 1)[1]
        (root / "portbench" / "configs" / f"{config}.json").write_text(json.dumps(
            {"name": config, "arch": arch, "port_arch": port_arch, "model": model}))
        (root / "portbench" / "traffic" / f"{traffic}.json").write_text(json.dumps(
            dict(mix, driver="closed_loop")))
        (root / "portbench" / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": config, "traffic": traffic, "check": check}))
        spec["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                  "chips": 1, "why": "a scratch cell"})
        for metric in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in metric and any(w.startswith(port_arch) for w in metric["workloads"]):
                metric["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def smoke_cells(decode_tokens: int = 3, limits=None) -> dict:
    check = {"requests": 4, "rows_per_call": 2, "ref_batch": 2,
             "limits": dict(limits or SMOKE_LIMITS)}
    return {
        "whisper-smoke.transcribe_tiny": (
            "whisper-smoke", "whisper", "whisper-large-v3", WHISPER_SMOKE,
            {"batch": 4, "prompt_tokens": 6, "memory_positions": 24,
             "new_tokens": decode_tokens}, check),
        "rwkv6-smoke.prefill_tiny": (
            "rwkv6-smoke", "rwkv6", "rwkv6-3b", RWKV_SMOKE,
            {"batch": 4, "prompt_tokens": 96, "memory_positions": 0, "new_tokens": 0}, check),
    }
