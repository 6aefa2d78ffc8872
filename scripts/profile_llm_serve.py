#!/usr/bin/env python3
"""Where the time of the port's LLM serving paths goes, on one CUDA card.

    PYTHONPATH=src python3 scripts/profile_llm_serve.py

The six full-size paths of `repro_torch.launch.serve`, one after the
other: the main path
(`main_path_inputs`, `MAIN_DECODE`: Gemma-2 9B), the MoE path
(`moe_path_inputs`, `MOE_DECODE`: Moonlight-16B-A3B), the hybrid path
(`hybrid_path_inputs`, `HYBRID_DECODE`: Zamba2-7B), the recurrent path
(`recurrent_path_inputs`, `RECURRENT_DECODE`: RWKV6-3B), each at full
width and depth with a batch of 2 random prompts of 8,000 tokens, the
encoder-decoder path (`encdec_path_inputs`, `ENCDEC_DECODE`: Whisper
large-v3, 16 stub audio windows of 1,500 frames, 64-token prompts) and
the vision-language path (`vlm_path_inputs`, `VLM_DECODE`:
Llama-3.2-Vision at full width and 20 layers, 2 prompts of 8,000 tokens
over 1,601 patch embeddings); random bf16 weights drawn on the card from
seed 0, one prefill (the encoder included) into a cache of the prompt
and 64 more positions, then 64 greedy decode steps, through
`make_prefill_step` and `make_serve_step`. A path's weights are freed
before the next is drawn. The prefill and the decode steps are each run
once untraced as a warm-up and once more untraced for their wall times,
then traced with `torch.profiler` (CUDA activity only, which keeps the
tracer's own host work small). It prints, per traced phase and per
decode step: the wall time (the tracer's host overhead included), the
device time summed over kernels, their ratio (the device's busy share;
kernels do not overlap on one stream), the number of kernel launches,
the device time grouped into the port's own kernels, matrix products
(cuBLAS), copies and casts, indexing (the MoE dispatch's gathers and
scatters), and the rest, and the kernels with the most device time. For
the recurrent paths it also runs the prefill and the decode steps once
more untraced, with the port's spans on (`core.timing.spans`), and
prints the scans' share of each phase on the device's clock: the device
milliseconds of the spans around the Mamba2 SSD chunk loop and its
one-token step and the RWKV6 wkv chunk loop and its step (their
launches' waits for the host included). It needs a card and exits
non-zero without one.
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

from repro_torch.core import timing  # noqa: E402
from repro_torch.launch.serve import (ENCDEC_DECODE, HYBRID_DECODE,  # noqa: E402
                                      MAIN_DECODE, MOE_DECODE, RECURRENT_DECODE,
                                      VLM_DECODE, encdec_path_inputs,
                                      hybrid_path_inputs, main_path_inputs,
                                      moe_path_inputs, recurrent_path_inputs,
                                      vlm_path_inputs)
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402
from repro_torch.models.transformer import RECURRENT_KINDS  # noqa: E402

TOP = 15  # kernels listed per phase
SCANS = ("mamba2.ssd_chunked", "mamba2.ssd_step", "rwkv6.wkv_chunked", "rwkv6.wkv_step")


def kernel_times(prof):
    """{kernel name: (device us, launches)} over CUDA kernels only."""
    out = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.name][0] += ev.time_range.elapsed_us()
            out[ev.name][1] += 1
    return out


def group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_" in name:  # flash_fwd_wgmma_kernel (bf16), flash_fwd_f32_kernel
        return "K4 flash attention"
    if "rms_norm_kernel" in name:
        return "K3 RMSNorm"
    if any(k in low for k in ("nvjet", "gemm", "gemv", "xmma", "cutlass")):
        return "matrix products"
    if "direct_copy" in name:
        return "copies and casts"
    if any(k in low for k in ("index", "scatter", "gather")):
        return "indexing"
    return "other"


def report(label: str, prof, wall_ms: float, steps: int = 1):
    """Per step: wall and device ms, launches; device ms by group and by
    kernel."""
    ks = kernel_times(prof)
    dev_ms = sum(t for t, _ in ks.values()) / 1e3
    n = sum(c for _, c in ks.values())
    if not n:
        sys.exit(f"profile_llm_serve: the trace of the {label} holds no kernel")
    print(f"{label}, per step: wall {wall_ms / steps:.2f} ms, device kernels "
          f"{dev_ms / steps:.2f} ms ({n / steps:.0f} launches), busy share "
          f"{dev_ms / wall_ms:.3f}")
    groups = defaultdict(lambda: [0.0, 0])
    for name, (t, c) in ks.items():
        groups[group(name)][0] += t / 1e3
        groups[group(name)][1] += c
    for g, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:20s} {t / steps:10.2f} ms  {100 * t / max(dev_ms, 1e-9):5.1f}%  "
              f"{c / steps:.0f} launches")
    for name, (t, c) in sorted(ks.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"    {t / 1e3 / steps:10.3f} ms  {c / steps:8.1f}x  {name[:110]}")


def scan_ms(records) -> float:
    """Device milliseconds of the recurrent blocks' scan spans."""
    return sum(r.device_ms for r in records if r.name in SCANS)


def profile_path(path_inputs, n_decode: int):
    dev = torch.device("cuda", 0)
    cfg, params, prompt, memory = path_inputs(dev)
    model = build(cfg)
    B, S = prompt.shape
    prefill_step = make_prefill_step(model, S + n_decode)
    serve_step = make_serve_step(model)
    batch = {"tokens": prompt} if memory is None else {"tokens": prompt, "memory": memory}
    print(f"{cfg.name}: {model.num_params():,} params in {cfg.param_dtype} ({cfg.num_layers} "
          f"layers{'' if memory is None else f'; memory {tuple(memory.shape)}'})")

    def prefill():
        return prefill_step(params, batch)

    def decode(caches, tok):
        for i in range(n_decode):
            tok, caches, _ = serve_step(params, caches, {"tokens": tok, "pos": S + i})
        return tok

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    for run in ("warm-up", "untraced"):
        (logits, caches), pre_ms = timed(prefill)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        _, dec_ms = timed(decode, caches, tok)
        del logits, caches
        print(f"{run}: prefill {pre_ms:.1f} ms, decode {dec_ms / n_decode:.2f} "
              f"ms per step (host clock around synchronised calls)")
    if any(kind in RECURRENT_KINDS for kind in cfg.pattern):
        with timing.spans() as records:
            (logits, caches), pre_ms = timed(prefill)
        pre_scan = scan_ms(records)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        with timing.spans() as records:
            _, dec_ms = timed(decode, caches, tok)
        dec_scan = scan_ms(records)
        del logits, caches
        print(f"scans (the port's spans, CUDA events): prefill {pre_scan:.1f} of "
              f"{pre_ms:.1f} ms ({pre_scan / pre_ms:.1%}), decode {dec_scan / n_decode:.2f} of "
              f"{dec_ms / n_decode:.2f} ms per step ({dec_scan / dec_ms:.1%})")
    acts = [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        (logits, caches), wall = timed(prefill)
    report(f"prefill (batch {B} x {S} tokens)", prof, wall)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    with profile(activities=acts) as prof:
        _, wall = timed(decode, caches, tok)
    report(f"decode ({n_decode} steps, cache {S + n_decode})", prof, wall, n_decode)


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_llm_serve: CUDA is not available; this needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0])
    for path_inputs, n_decode in ((main_path_inputs, MAIN_DECODE),
                                  (moe_path_inputs, MOE_DECODE),
                                  (hybrid_path_inputs, HYBRID_DECODE),
                                  (recurrent_path_inputs, RECURRENT_DECODE),
                                  (encdec_path_inputs, ENCDEC_DECODE),
                                  (vlm_path_inputs, VLM_DECODE)):
        profile_path(path_inputs, n_decode)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
