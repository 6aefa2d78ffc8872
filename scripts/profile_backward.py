#!/usr/bin/env python3
"""Where the time of the two backward kernels goes, on one CUDA card.

    PYTHONPATH=src python3 scripts/profile_backward.py

K4-bwd (`kernels/flash_attention/ops.flash_attention_bwd`) at the Gemma
2B trainer's shape (2, 2048, 1, 8, 256), causal, bf16, with q, k and v
as strided views of one projection as in the model; and K3-bwd
(`kernels/rmsnorm/ops.rms_norm_bwd`) at the trainer's (4096, 2048) bf16.
Inputs are N(0, 1), drawn on the card from seed 0. Each wrapper is called
once untraced, then `CALLS` times under `torch.profiler` (CUDA activity
only). The trace is padded with small launches and a pause, as
chip_smoke pads its traces: the tracer drops the records at the end of a
trace that stops right after the work. It prints, per wrapper, the
device ms per call of each kernel it launches and their sum. It needs a
card and exits non-zero without one, or when a trace holds none of the
wrapper's kernels.
"""
from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as norm_ops  # noqa: E402

CALLS, PAD_LAUNCHES, PAUSE_S = 5, 512, 0.2


def split(label: str, fn) -> None:
    """Print the device ms per call of each kernel that ``fn`` launches."""
    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        for _ in range(PAD_LAUNCHES):
            pad.add_(1)
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
    ms = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and "elementwise" not in ev.name:
            # "void (anonymous namespace)::name<256>(args)" -> "name<256>"
            name = ev.name.replace("(anonymous namespace)::", "").split("(")[0]
            ms[name.removeprefix("void ")] += ev.time_range.elapsed_us() / 1e3 / CALLS
    if not ms:
        sys.exit(f"profile_backward: the trace of {label} holds none of its kernels")
    print(f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f"; in all {sum(ms.values()):.4f} ms a call")


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_backward: CUDA is not available; this needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0])
    build.build_all()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, KV, G, hd = 2, 2048, 1, 8, 256
    qkv = torch.randn(B, S, KV, G + 2, hd, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, :, :G], qkv[:, :, :, G], qkv[:, :, :, G + 1]
    o, lse = attn_ops._forward(q, k, v, True, 0, 0.0, want_lse=True)
    do = torch.randn(o.shape, generator=g, device=dev).to(torch.bfloat16)
    split(f"K4-bwd {(B, S, KV, G, hd)} causal bf16 ({attn_ops.BWD_ROUTES[q.dtype][0]})",
          lambda: attn_ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True))
    x = torch.randn(4096, 2048, generator=g, device=dev).to(torch.bfloat16)
    w = (0.1 * torch.randn(2048, generator=g, device=dev)).to(torch.bfloat16)
    dy = torch.randn(4096, 2048, generator=g, device=dev).to(torch.bfloat16)
    split(f"K3-bwd (4096, 2048) bf16 ({norm_ops.bwd_variant(x, w, dy)})",
          lambda: norm_ops.rms_norm_bwd(x, w, dy))


if __name__ == "__main__":
    main()
