#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU, and hold its
hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA card; it imports
the port from ``src/`` and nothing of JAX. Phases, each printing lines of
its own:

1. environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, TF32 switched off for matmuls and convolutions, and the
   kernels' build (``nvcc`` into ``build/kernels/``, one process per
   source, all started together), and the count of ``HGMMA`` (wgmma) and
   ``UTMALDG`` (TMA load) instructions in the bf16 flash-attention
   kernel's SASS (``cuobjdump --dump-sass``), which must not be 0;
2. K1, the fused masked-Adam kernel, against its plain version at the main
   path's shape (8 sessions x 334,405 float32 coordinates, sessions at
   different step counts) and on two mixed-dtype stacks: p, m, v and u
   must be equal bit for bit; then its time, the plain version's and the
   bound;
3. K2, the top-k threshold kernel (a radix select over many blocks per
   session; the grid is printed and must hold more than one block per
   session), against its plain version at the main path's shape, at 3
   sessions, at 2 sessions above 4M coordinates, and on the JAX package's
   edge cases (mixed signs, all negative, ties, subnormals, zeros) plus
   NaN and infinities: threshold bits exact, masks byte-identical (also
   to a sort's threshold); then its time, the plain version's,
   ``torch.kthvalue``'s and the bound;
4. the main path. First one eager fused iteration of its shape (8
   sessions x 8 frames of 256x256) traced with ``torch.profiler``: the
   device's busy share, the kernel launches, device time by kernel group.
   Then 8 AMS sessions of the width-4.0 segmentation student on 8 seeded
   synthetic videos at 256x256, batch 8, K=20, gamma=0.05, through 3
   fused phases (the first with random masks, then two gradient-guided)
   under the ``auto`` execution shape: the first phase races the CUDA
   graph of the K loop against the eager loop (one warm and two timed
   runs of each; winner and times printed), the other two hit the cache.
   Deltas are encoded, applied by each edge client and scored by mIoU on
   held-out frames. The kernels' launch counts are set to 0 just before
   and read just after, and K1's must be exactly K per eager loop and per
   graph replay plus one per warm-up before a capture (the race's runs
   included), K2's one per gradient-guided phase. Afterwards both kernels
   are held against their plain versions again on the run's real updates
   and gradients; the flat-layout optimizer loop against the tree steps
   it replaced (bit for bit); one phase through the eager loop twice and
   the graph twice, with the distances between them; and each stage of a
   phase is timed on its own, the flat-layout Adam step beside the tree
   step;
5. the streaming schemes (``sim/runner.run_scheme``, the paper's Table 1):
   the width-4.0 student pretrained on the card (``pretrain_student``,
   ``PRETRAIN_STEPS`` steps from seed 42 on 256x256 videos), then all
   five schemes on one 90 s, 256x256, 4 fps video with the oracle teacher,
   then ``ams`` and ``no_custom`` again under a learned teacher
   (``train_teacher``, ``TEACHER_STEPS`` steps). Each run prints its mean
   mIoU, uplink and downlink Kbps, updates, wall time and K1/K2 launches,
   counted from 0 just before it; the counts must be exactly what the
   scheme asks for (K1 once per Adam step, K2 once per gradient-guided
   selection). Then K1 and K2 at B = 1 are held against their plain
   versions on the ``ams`` run's last update and a real gradient, K2 is
   timed at B = 1, and one sequential ``ams`` phase is split by stage;
6. the serving engine (``sim/multiclient.run_multiclient``, the paper's
   Appendix E): 8 clients of the schemes phase's pretrained width-4.0
   student on 256x256, 4 fps videos for 60 s, one GPU slot bound to the
   card (``device_backend="torch"``), the fair policy, up to 8 sessions per
   fused group, the schemes phase's ``AMSConfig``. K1 and K2 are counted
   from 0 and must equal what the engine's and the update pipeline's own
   counters imply (K1: K per trained group, fused or singleton; K2: one
   per gradient-guided selection, stacked or solo); at least one fused
   group of B >= 2 must train. Each new (B, K) key races the two shapes,
   and the race's runs count too. Prints the auto decisions and race
   times, the groups by B, mIoU (mean and per
   client), phases served, deferred and dropped, mean up/down Kbps, mean
   and max delta latency, events, wall time, and the engine's drift
   report: per stage the measured steady seconds on the card against
   ``GPUCostModel``'s modeled seconds, and its `serving_stage_report`
   (model efficiency, HBM roofline fraction, bottleneck);
7. the LLM serving path, after ``batched.cache_clear()`` has released the
   fused phase's graphs and their memory: Gemma-2 9B at full width and depth (42 layers,
   d_model 3584, random bf16 weights drawn on the card from seed 0), a
   batch of 2 random prompts of 8,000 tokens, prefill, then 64 greedy
   decode steps through ``launch.serve.serve``, once cold and once timed
   (times of both printed; the timed run's tokens must equal the cold
   run's). For the timed run the RMSNorm (K3) and
   flash-attention (K4) launch counts are set to 0 just before and read
   just after, and must be 169 and 42 for the prefill and 169 per token
   and 0 for decode, all 42 K4 launches on its bf16 (tensor-core) route;
   every logit must be finite. Then K3 and K4 are held against their plain
   versions on synthetic inputs (K4 in bf16 at head dims 64, 128 and 256
   and in float32) and on the run's own data (layer 0's norm input; layer
   0's local and layer 1's global q, k, v; for K3 also its last position,
   a decode step's shape), and timed at those shapes beside their bounds
   (K4's TFLOP/s and share of its bound printed), their plain versions and
   a PyTorch call (``F.rms_norm``; for K4 at softcap 0,
   ``scaled_dot_product_attention``); K3 must take its warp-per-row
   variant at the prefill's shape and its split-row one at the decode's.
   The run's prefill and decode times are divided by
   ``roofline.analytic``'s FLOPs and bytes at the card's data-sheet peaks
   (``launch/mesh.py``): prefill MFU and bound share, decode HBM share;
8. the MoE serving path, after Gemma-2's weights are freed (the device's
   allocated memory must drop by their size): Moonlight-16B-A3B at full
   width and depth (48 layers, 64 routed experts top-6 and 2 shared,
   28,552,923,136 random bf16 parameters drawn on the card from seed 0),
   the same batch, prompts and decode steps, once cold and once timed
   (tokens equal), peak memory under the card's; K3 97 launches in
   prefill and 97 per decode step, K4 48 in prefill, all bf16, and 0 in
   decode. K3 held against its plain version on the run's layer-0 input;
   K4 at the run's shape (2, 8000, 16, 1, 128) on N(0, 1) inputs (its
   plain version one batch row at a time), and on the run's layer-0 q,
   k, v, where the softmax is nearly a hard max and the outputs cancel,
   against attention in float64, as often within one bf16 ulp of it as
   its plain version is; both timed, K4 beside its bound and
   ``scaled_dot_product_attention(is_causal=True)``, which computes the
   same function there; the shares of the analytic bound as for Gemma-2;
9. the hybrid serving path, after Moonlight's weights are freed: Zamba2-7B
   at full width and depth (81 Mamba2 layers in 27 groups of 3, one shared
   attention + SwiGLU block before each group, 32 heads of 112;
   6,635,851,856 random bf16 parameters drawn on the card from seed 0),
   the same batch, prompts and decode steps, once cold and once timed
   (tokens equal): K3 217 launches per prefill and per decode step (2 per
   Mamba2 layer, 2 per shared block, the final norm), K4 27 per prefill,
   all bf16, 0 in decode. The prefill's hand-off to decode: each of group
   0's blocks (the shared block and 3 Mamba2 blocks) decoding position
   8,000 from its prefill caches against the block over 8,001 positions,
   on the run's own inputs, within ``HANDOFF_BLOCK_BOUND``; the logits of
   the first decode step against ``forward``'s over the same 8,001 tokens,
   printed (the random init's attention is a hard max, see
   ``HANDOFF_LOGITS_BOUND``). The weights are dropped (their bytes checked
   freed); the shares of the analytic bound; K3 on the run's first Mamba2
   inner norm input (2, 8000, 7168) and its last position (its split-row
   variant at both), and K4 at head dim 112 (2, 8000, 32, 1, 112) on
   N(0, 1) inputs within one bf16 ulp of its plain version and on the
   run's own q, k, v against float64 as for Moonlight, timed beside its
   bound and ``scaled_dot_product_attention(is_causal=True)``; then the
   hand-off again with the same draws in float32 (the blocks within
   1e-4);
10. the recurrent serving path: RWKV6-3B at full width and depth (32
   layers, d_model 2,560, 40 wkv heads of 64; 2,690,501,120 random bf16
   parameters), the same batch, prompts and decode steps: K3 32 launches
   per prefill and per decode step (``ln_x``; the block norms are
   LayerNorm), K4 none; the hand-off as for Zamba2, the logits held
   within ``HANDOFF_LOGITS_BOUND`` too; the weights freed; the shares of
   the analytic bound; K3 on the run's layer-0 ``ln_x`` input (2, 8000,
   2560) (warp per row) and its last position (split row);
11. the encoder-decoder serving path: Whisper large-v3 at full size (32
   encoder and 32 decoder layers, d_model 1,280, 20 heads of 64, LayerNorm,
   sinusoidal positions, the plain-gelu MLP; 1,534,602,240 random bf16
   parameters), 16 stub audio windows of 1,500 N(0, 1) frame embeddings,
   64-token prompts and 64 decode steps, once cold and once timed (tokens
   equal): K4 96 launches per prefill (32 non-causal over the frames in
   the encoder, 32 causal self-attention and 32 cross-attention of 64
   queries over 1,500 frames in the decoder), all bf16, none in decode;
   K3 none (LayerNorm). The hand-off as for Zamba2, with the encoded
   frames, each block's cross cache from its prefill read in its decode;
   the logits printed (the init's G = 1 attention is a hard max). The
   weights freed; the shares of the analytic bound; K4 on the run's
   encoder layer-0 q, k, v (16, 1500, 20, 1, 64) and decoder layer-0
   cross-attention q (16, 64, 20, 1, 64) over k, v (16, 1500, 20, 64):
   within one bf16 ulp of the plain version on N(0, 1) inputs, and on the
   run's own against float64 as for Moonlight (the line says whether one
   ulp of the plain version holds there too), timed beside the bound and
   ``scaled_dot_product_attention(is_causal=False)``;
12. the vision-language serving path: Llama-3.2-Vision 90B at full width
   (d_model 8,192, 64 heads of 128 over 8 KV heads, d_ff 28,672) cut to
   20 layers (4 groups of 4 self-attention blocks and a gated
   cross-attention block; 18,163,769,348 random bf16 parameters, every
   gate set to 1.0), batch 2, 8,000-token prompts over 1,601 N(0, 1) patch
   embeddings, 64 decode steps: K3 41 per prefill and per decode step, K4
   20 per prefill (16 causal, 4 non-causal over the patches), all bf16;
   the hand-off (its 4 self-attention blocks and the cross-attention
   block) and logits printed; the weights freed; the shares of the
   analytic bound; K3 on the run's layer-0 input (2, 8000, 8192) and its
   last position (split row at both); K4 on the cross-attention block's
   own q (2, 8000, 8, 8, 128) over k, v (2, 1601, 8, 128), as for
   Whisper's, beside ``scaled_dot_product_attention(is_causal=False,
   enable_gqa=True)``;
13. the training path (`launch/train.train`, the LLM distillation
   trainer): Gemma 2B at full size (18 layers, d_model 2,048, 8 q heads
   of 256 over 1 KV head, GeGLU d_ff 16,384, vocab 256,000, remat;
   2,506,172,416 random bf16 parameters drawn on the card from seed 0),
   2 phases of K = 4 steps at 2 x 2,048 tokens (gamma 0.05, lr 1e-3, clip
   1.0), the first on a random mask drawn on the card, the second
   gradient-guided; the delta encoded at each phase's end and applied to
   the edge's copy of the init. Per step: the loss (finite), the kernel
   launches (exactly `train_expected_launches`: K3 73, K3-bwd 37, K4 36,
   K4-bwd 18, K1 1), the stages' times; at step 1 every leaf's gradient
   finite and not all zero; the peak memory beside its prediction, the
   step's MFU against `roofline.analytic`, the downlink per phase; the
   edge's params equal the trained ones through fp16 where a mask
   selected. Then K4-bwd and K3-bwd on the run's layer-0 tensors and on
   N(0, 1) inputs, within 2x the bf16 plain backward's error from
   float64, K4-bwd on an option grid against its plain backward, both
   timed beside their bounds, plain versions and autograd through SDPA
   and ``F.rms_norm``;
14. one JSON line ``{"kernels": [...]}`` with every kernel's launches (K3's
   and K4's on all six LLM paths and the trainer), error against its
   plain version, times and bound;
15. the last line, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result; it does so too without CUDA, and when ``src/`` is missing (the
imports fail).
"""
from __future__ import annotations

import contextlib
import gzip
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the port, from src/ beside this file; the import fails (non-zero exit,
# no result) in a directory that holds nothing else of the repo
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import batched, selection, timing  # noqa: E402
from repro_torch.core.batched import stack_trees, train_phases_fused  # noqa: E402
from repro_torch.core.client import EdgeClient  # noqa: E402
from repro_torch.core.delta import apply_delta, encode_delta, encode_delta_stack  # noqa: E402
from repro_torch.core.masked_adam import init_state, masked_adam_update  # noqa: E402
from repro_torch.core.server import AMSConfig, AMSSession, Task  # noqa: E402
from repro_torch.data.tokens import StreamConfig, TokenStream  # noqa: E402
from repro_torch.data.video import VideoConfig  # noqa: E402
from repro_torch.device import host_to_device  # noqa: E402
from repro_torch.kernels import build, stacking  # noqa: E402
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as attn_ref  # noqa: E402
from repro_torch.kernels.masked_adam import ops as adam_ops  # noqa: E402
from repro_torch.kernels.masked_adam import ref as adam_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as norm_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as norm_ref  # noqa: E402
from repro_torch.kernels.topk_mask import ops as topk_ops  # noqa: E402
from repro_torch.kernels.topk_mask import ref as topk_ref  # noqa: E402
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16  # noqa: E402
from repro_torch.launch.serve import (ENCDEC_BATCH, ENCDEC_DECODE,  # noqa: E402
                                      ENCDEC_PROMPT, HYBRID_BATCH, HYBRID_DECODE,
                                      HYBRID_PROMPT, MAIN_BATCH, MAIN_DECODE,
                                      MAIN_PROMPT, MOE_BATCH, MOE_DECODE, MOE_PROMPT,
                                      RECURRENT_BATCH, RECURRENT_DECODE,
                                      RECURRENT_PROMPT, VLM_BATCH, VLM_DECODE,
                                      VLM_PROMPT, encdec_path_inputs,
                                      hybrid_path_inputs, main_path_inputs,
                                      moe_path_inputs, recurrent_path_inputs, serve,
                                      vlm_path_inputs)
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.metrics.miou import miou  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.ssm import mamba2, rwkv6  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models.attention import _proj_qkv  # noqa: E402
from repro_torch.models.layers import apply_norm, embed_apply  # noqa: E402
from repro_torch.models.registry import build as build_model  # noqa: E402
from repro_torch.models.seg.student import SegConfig, make_student, seg_param_count  # noqa: E402
from repro_torch.models.seg.teacher import train_teacher  # noqa: E402
from repro_torch.roofline.analysis import roofline_terms, serving_stage_report  # noqa: E402
from repro_torch.roofline.analytic import ShapeSpec, analytic_cost  # noqa: E402
from repro_torch.serving import ServingConfig, debug_snapshot  # noqa: E402
from repro_torch.sim import runner  # noqa: E402
from repro_torch.sim.multiclient import run_multiclient  # noqa: E402
from repro_torch.sim.seg_world import SegWorld, phi_pixel_loss, pretrain_student  # noqa: E402

# data-sheet peaks per card, matched on the name nvidia-smi reports:
# (substring, device memory bytes/s, float32 FLOP/s outside tensor cores,
#  dense bf16 tensor-core FLOP/s)
PEAKS = (("H200", 4.8e12, 67e12, 989e12), ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100 PCIe", 2.0e12, 51e12, 756e12), ("H100", 3.35e12, 67e12, 989e12))
# special-function (tanh, exp) rate assumed for the attention's second
# bound: 16 per SM per clock (the Hopper white paper's SM: 4 SFUs in each
# of 4 partitions), 132 SMs, 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9

B, N_PARAMS = 8, 334_405            # main path: sessions, width-4.0 student
WIDTH, HW = 4.0, 256                # student width, frame height and width
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)
FRAC = 0.05
# the streaming schemes: the benchmarks' AMS settings (benchmarks/common.py
# default_ams), a 90 s video, One-Time training after 30 s. Just-In-Time
# trains while the edge's pixel accuracy on the sampled frame is below its
# threshold: at the default 0.60 the pretrained width-4.0 student stays
# above it on every frame of this video and JIT never trains, so the smoke
# takes 0.90, the top of the benchmarks' threshold sweep (fig4_bw_sweep.py)
SCHEME_VIDEO = dict(height=HW, width=HW, fps=4.0, seed=11, drift_period=240.0,
                    duration=90.0)
SCHEME_AMS = dict(t_update=10.0, t_horizon=40.0, k_iters=25, batch_size=8, gamma=FRAC,
                  lr=2e-3, phi_target=0.15, asr_eta=1.0, atr_gamma0=0.45,
                  atr_gamma1=0.60)
SCHEME_SIM = dict(eval_stride=4, one_time_window=30.0, one_time_iters=100,
                  jit_threshold=0.90)
PRETRAIN_STEPS, TEACHER_STEPS = 120, 150
# the serving engine: 8 clients on 256x256, 4 fps videos for 60 s, one GPU
# slot bound to the card, fair policy, up to 8 sessions per fused group;
# everything else (stationary_frac 0.3, eval_stride 6, LinkSpec()) default
SERVE_CLIENTS, SERVE_S, SERVE_FUSE = 8, 60.0, 8
# what follows a traced replay inside its trace (exec_shape_check)
PAD_LAUNCHES, TRACE_PAUSE_S = 512, 0.2


def peaks(name: str):
    for key, *rates in PEAKS:
        if key in name:
            return rates
    raise RuntimeError(f"no data-sheet peaks known for {name!r}")


def time_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of one call, started with the device idle:
    what a caller waits for, the wrapper's host work included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Median device time of one call, from ``n`` calls queued back to back
    behind a spin kernel that keeps the device busy while the host
    enqueues them, so the host's per-call work hides behind it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(1_000_000)
    b.record()
    b.synchronize()
    cycles_per_ms = 1_000_000 / a.elapsed_time(b)
    spin = int(cycles_per_ms * 2e3 * host_s) + 1
    times = []
    for _ in range(reps):
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def sass_counts(kernel: str = "flash_fwd_wgmma_kernel",
                library: str = "flash_attention") -> dict:
    """wgmma (HGMMA), TMA load (UTMALDG) and TMA store (UTMASTG)
    instructions in the SASS of ``kernel``'s instantiations, from
    ``cuobjdump --dump-sass`` of the built library of ``csrc/<library>.cu``."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin", "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(build.lib_path(library))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {"functions": 0, "HGMMA": 0, "UTMALDG": 0, "UTMASTG": 0}
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            counts["functions"] += inside
        elif inside:
            for op in ("HGMMA", "UTMALDG", "UTMASTG"):
                counts[op] += op in line
    return counts


# ---------------------------------------------------------------------------
# K1: fused masked Adam
# ---------------------------------------------------------------------------


def k1_compare(bufs, bc) -> float:
    """Kernel vs plain on the same buffers; bit-for-bit or raise."""
    out_k = adam_ops.masked_adam_3d(*bufs, bc, **ADAM)
    out_r = adam_ref.masked_adam_ref(*bufs, bc, **ADAM)
    torch.cuda.synchronize()
    err = 0.0
    for name, k, r in zip(("p", "m", "v", "u"), out_k, out_r):
        check(k.dtype == r.dtype and k.shape == r.shape, f"K1 {name} dtype/shape")
        check(torch.equal(k.view(torch.uint8), r.view(torch.uint8)),
              f"K1 {name} differs from its plain version bit for bit")
        err = max(err, float((k.float() - r.float()).abs().max()))
    return err


def k1_phase(dev, bw, flops):
    g = torch.Generator(device=dev).manual_seed(11)
    rows = -(-N_PARAMS // stacking.LANES)
    shape = (B, rows, stacking.LANES)
    counts = torch.tensor((0, 1, 5, 19, 20, 39, 40, 100)[:B],
                          dtype=torch.int32, device=dev)
    _, bc = adam_ops.bias_correction(counts, lr=1e-3, b1=0.9, b2=0.999)
    err = 0.0
    main = None
    for dts in ((torch.float32,) * 4,
                (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32),
                (torch.float16, torch.float32, torch.float16, torch.float16)):
        p = torch.randn(shape, generator=g, device=dev).to(dts[0])
        grad = (torch.randn(shape, generator=g, device=dev) * 1e-2).to(dts[1])
        m = (torch.randn(shape, generator=g, device=dev) * 1e-3).to(dts[2])
        v = (torch.rand(shape, generator=g, device=dev) * 1e-4).to(dts[3])
        mask = torch.rand(shape, generator=g, device=dev) < FRAC
        bufs = (p, grad, m, v, mask)
        err = max(err, k1_compare(bufs, bc))
        print(f"K1 bitwise equal to plain: dtypes {[str(d)[6:] for d in dts]}")
        if main is None:
            main = bufs
    ms = device_ms(lambda: adam_ops.masked_adam_3d(*main, bc, **ADAM))
    call_ms = time_ms(lambda: adam_ops.masked_adam_3d(*main, bc, **ADAM))
    plain_ms = device_ms(lambda: adam_ref.masked_adam_ref(*main, bc, **ADAM))
    numel = main[0].numel()
    nbytes = numel * (4 * 4 + 1 + 4 * 4) + bc.numel() * 4
    bound_ms = 1e3 * max(nbytes / bw, 13 * numel / flops)
    print(f"K1 masked_adam_3d {tuple(shape)}: kernel {ms:.4f} ms on the device "
          f"({call_ms:.4f} ms per call from idle, wrapper included), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB)")
    # B=1, the sequential path's launch (the JAX package's masked_adam_2d)
    one = tuple(t[:1].contiguous() for t in main)
    bc1 = bc[:1].contiguous()
    err = max(err, k1_compare(one, bc1))
    b1_ms = device_ms(lambda: adam_ops.masked_adam_3d(*one, bc1, **ADAM))
    b1_plain_ms = device_ms(lambda: adam_ref.masked_adam_ref(*one, bc1, **ADAM))
    b1_bytes = one[0].numel() * (4 * 4 + 1 + 4 * 4) + 4
    b1_bound_ms = 1e3 * max(b1_bytes / bw, 13 * one[0].numel() / flops)
    print(f"K1 masked_adam_3d at B=1 {tuple(one[0].shape)}: bitwise equal to plain; "
          f"kernel {b1_ms:.4f} ms, plain {b1_plain_ms:.4f} ms, bound "
          f"{b1_bound_ms:.4f} ms ({b1_bytes / 1e6:.1f} MB)")
    return dict(err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, b1_ms=b1_ms, b1_plain_ms=b1_plain_ms,
                b1_bound_ms=b1_bound_ms)


# ---------------------------------------------------------------------------
# K2: top-k threshold bits
# ---------------------------------------------------------------------------


def u_case(case: str, rng, b=3):
    """The JAX package's top-k edge cases (tests/test_kernel_dispatch.py),
    plus NaN and infinities."""
    def leaf(shape):
        n = int(np.prod(shape))
        if case == "mixed":
            x = rng.normal(size=n)
        elif case == "negatives":
            x = -np.abs(rng.normal(size=n)) - 0.1
        elif case == "ties":
            x = rng.choice([0.5, -0.5, 2.0, -2.0, 0.0], size=n)
        elif case == "denormals":
            x = rng.normal(size=n) * 1e-41
        elif case == "zeros":
            x = np.zeros(n)
        elif case == "nan":
            x = rng.normal(size=n)
            x[rng.integers(0, n, size=5)] = np.nan
        else:  # inf
            x = rng.normal(size=n)
            x[rng.integers(0, n, size=3)] = np.inf
            x[rng.integers(0, n, size=3)] = -np.inf
        return x.reshape(shape).astype(np.float32)

    return {"a": np.stack([leaf((57, 7)) for _ in range(b)]),
            "b": np.stack([leaf((301,)) for _ in range(b)])}


def k2_compare(u_stacked, frac) -> float:
    """Kernel vs plain threshold bits (exact) and masks (byte-identical,
    also to each session's solo selection and to a sort's threshold)."""
    bits, n = topk_ops.abs_bits_buffer(u_stacked)
    k = topk_ops.selection_count(n, frac)
    thr_k = topk_ops.topk_threshold_bits(bits, k)
    thr_r = topk_ref.topk_threshold_bits_ref(bits, k)
    check(torch.equal(thr_k, thr_r), "K2 threshold bits differ from plain")
    m_k = selection.stacked_gradient_guided_masks(u_stacked, frac)
    m_r = topk_ops.masks_from_threshold(u_stacked, thr_r)
    u_cpu = tree.tree_map(lambda l: l.cpu(), u_stacked)
    m_cpu = selection.stacked_gradient_guided_masks(u_cpu, frac)
    for a, b, c in zip(tree.leaves(m_k), tree.leaves(m_r), tree.leaves(m_cpu)):
        check(torch.equal(a, b), "K2 masks differ from the plain version's")
        check(torch.equal(a.cpu(), c), "K2 masks differ from the CPU path's")
    for i in range(thr_k.shape[0]):
        solo = selection.gradient_guided_mask(
            tree.tree_map(lambda l: l[i], u_stacked), frac)
        leaves_i = [l[i] for l in tree.leaves(u_cpu)]
        thr_s = topk_ref.topk_threshold_sort_ref(leaves_i, k)
        for a, s, l in zip(tree.leaves(m_k), tree.leaves(solo), leaves_i):
            check(torch.equal(a[i], s), "K2 solo mask differs from the stacked one")
            check(torch.equal(a[i].cpu(), l.abs() >= thr_s),
                  "K2 mask differs from the sort's threshold")
    tk, tr = thr_k.view(torch.float32), thr_r.view(torch.float32)
    return float(torch.nan_to_num((tk - tr).abs(), nan=0.0).max())


def k2_phase(dev, bw, flops):
    err = 0.0
    rng = np.random.default_rng(5)
    for case in ("mixed", "negatives", "ties", "denormals", "zeros", "nan", "inf"):
        u = {k: torch.from_numpy(v).to(dev) for k, v in u_case(case, rng).items()}
        err = max(err, k2_compare(u, 0.07))
        print(f"K2 exact against plain and sort: case {case}")
    g = torch.Generator(device=dev).manual_seed(12)
    # 3 sessions at the student's size; 2 sessions above 4M coordinates
    for u in ({"w": torch.randn(3, N_PARAMS, generator=g, device=dev) * 1e-3},
              {"a": torch.randn(2, 3_000_001, generator=g, device=dev),
               "b": torch.randn(2, 1_700, 1_000, generator=g, device=dev)}):
        err = max(err, k2_compare(u, FRAC))
        bits, n = topk_ops.abs_bits_buffer(u)
        print(f"K2 exact against plain and sort: {bits.shape[0]} sessions of {n} "
              f"coordinates, {topk_ops.blocks_per_session(bits)} blocks per session")
    u = {"w": torch.randn(B, N_PARAMS, generator=g, device=dev) * 1e-3}
    err = max(err, k2_compare(u, FRAC))
    bits, n = topk_ops.abs_bits_buffer(u)
    bps = topk_ops.blocks_per_session(bits)
    check(bps > 1, f"K2 runs on more than one block per session ({bps})")
    print(f"K2 exact against plain and sort: main shape ({B}, {N_PARAMS}); grid of "
          f"{bps} blocks per session x {B} sessions = {bps * B} blocks, "
          f"{len(topk_ops.DIGIT_BITS)} digit passes {topk_ops.DIGIT_BITS}")
    k = topk_ops.selection_count(n, FRAC)
    ms = device_ms(lambda: topk_ops.topk_threshold_bits(bits, k))
    call_ms = time_ms(lambda: topk_ops.topk_threshold_bits(bits, k))
    plain_ms = device_ms(lambda: topk_ref.topk_threshold_bits_ref(bits, k), n=5)
    absu = u["w"].abs()
    library_ms = device_ms(lambda: torch.kthvalue(absu, n - k + 1, dim=1), n=5)
    check(torch.equal(torch.kthvalue(absu, n - k + 1, dim=1).values.view(torch.int32),
                      topk_ops.topk_threshold_bits(bits, k)),
          "K2 threshold differs from torch.kthvalue")
    nbytes = bits.numel() * 4 + B * 4
    bound_ms = 1e3 * max(nbytes / bw, bits.numel() / flops)
    print(f"K2 topk_threshold_bits {tuple(bits.shape)} k={k}: kernel {ms:.4f} ms "
          f"on the device ({call_ms:.4f} ms per call from idle), plain "
          f"{plain_ms:.4f} ms, torch.kthvalue {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB)")
    return dict(err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, blocks=bps * B)


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def race_label(key) -> str:
    """``(B, K)`` of a fused phase's compile key (its struct's first leaf
    carries B; K follows the struct)."""
    struct = key[1]
    return f"({struct[1][0][0][0]}, {key[2]})"


def ams_iteration_trace(dev):
    """One eager fused iteration of the main path's shape (8 sessions of
    the width-4.0 student, 8 frames of 256x256 each, the flat-layout step)
    traced with `torch.profiler` after two untraced runs: the device's
    busy share (kernel time over the host clock around the synchronised
    call), the kernel launches and the device time by kernel group."""
    seg = SegConfig(n_classes=5, width=WIDTH)
    lg = SegWorld(video=None, teacher=None, seg_cfg=seg).loss_and_grad
    params = stack_trees([make_student(seg, seed=i, device=dev) for i in range(B)])
    opt = stack_trees([init_state(make_student(seg, seed=i, device=dev)) for i in range(B)])
    g = torch.Generator(device=dev).manual_seed(21)
    mask = tree.tree_map(lambda l: torch.rand(l.shape, generator=g, device=dev) < FRAC,
                         params)
    frames = torch.rand((1, B, 8, HW, HW, 3), generator=g, device=dev)
    labels = torch.randint(0, 5, (1, B, 8, HW, HW), generator=g, device=dev,
                           dtype=torch.int32)
    args = (params, opt, mask, frames, labels)
    batched.set_exec_mode("loop")
    try:
        step = batched.fused_phase_fn(lg, struct=tree.struct(args), k_iters=1,
                                      optimizer="adam", lr=2e-3, b1=0.9, b2=0.999,
                                      eps=1e-8, momentum=0.9, device=dev)
    finally:
        batched.set_exec_mode("auto")
    for _ in range(2):
        step(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups: dict = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        name, low = ev.name, ev.name.lower()
        if "masked_adam" in name:
            grp = "K1 masked Adam"
        elif any(k in low for k in ("conv", "cudnn", "implicit", "wgrad", "dgrad",
                                    "xmma", "sm90_", "gemm", "nvjet")):
            grp = "convolutions and matrix products"
        elif any(k in low for k in ("copy", "cat", "fill")):
            grp = "copies, concats and fills"
        else:
            grp = "other elementwise and reductions"
        e = groups.setdefault(grp, [0.0, 0])
        e[0] += ev.time_range.elapsed_us() / 1e3
        e[1] += 1
    dev_ms = sum(t for t, _ in groups.values())
    n = sum(c for _, c in groups.values())
    check(n > 0 and dev_ms > 0, "the profiler recorded device kernels")
    busy_us, end = 0.0, float("-inf")  # the union of the kernels' intervals
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / 1e3 / wall_ms
    print(f"AMS iteration trace ({B} sessions x 8 frames of {HW}x{HW}, eager, flat "
          f"layout): wall {wall_ms:.2f} ms, device busy {busy_us / 1e3:.2f} ms (union of "
          f"the kernels' intervals; their sum {dev_ms:.2f} ms, so kernels overlap), busy "
          f"share {busy:.3f}, {n} kernel launches")
    for grp, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {grp:34s} {t:9.3f} ms {100 * t / dev_ms:5.1f}%  {c} launches")
    batched.cache_clear()
    return dict(wall_ms=wall_ms, busy_ms=busy_us / 1e3, kernel_sum_ms=dev_ms,
                busy_share=busy, launches=n, groups={k: v[0] for k, v in groups.items()})


def main_path(dev):
    seg = SegConfig(n_classes=5, width=WIDTH)
    check(seg_param_count(seg) == N_PARAMS, "student size")
    ams = AMSConfig(batch_size=8, k_iters=20, gamma=FRAC)
    worlds = [SegWorld.make(VideoConfig(height=HW, width=HW, seed=s), seg)
              for s in range(B)]
    p0 = make_student(seg, seed=0, device=dev)
    sessions = [AMSSession(Task(loss_and_grad=w.loss_and_grad, teacher=None,
                                    phi_loss=phi_pixel_loss), ams, p0, seed=i)
                for i, w in enumerate(worlds)]
    clients = [EdgeClient(w.predict, p0) for w in worlds]
    fps = worlds[0].video.cfg.fps

    def feed(phase):  # 1 frame/s for 10 s, labelled by the oracle teacher
        idx = [int((10 * phase + j) * fps) for j in range(10)]
        for s, w in zip(sessions, worlds):
            f = np.stack([w.video.frame(i)[0] for i in idx])
            lab = np.stack([w.teacher.label(i) for i in idx])
            s.receive_labeled(f, lab, 10.0 * phase + 9.0)

    held_out = [int(t * fps) for t in (31.0, 32.5, 34.0, 35.5)]
    eval_frames = [(host_to_device(np.stack([w.video.frame(i)[0] for i in held_out]), dev),
                    [w.teacher.label(i) for i in held_out]) for w in worlds]

    def edge_miou():
        scores = []
        for c, w, (x, labs) in zip(clients, worlds, eval_frames):
            pred = c.infer(x).cpu().numpy()
            scores += [miou(p, lab, 5) for p, lab in zip(pred, labs)]
        return float(np.mean(scores))

    print(f"main path: {B} sessions x width-{WIDTH} student ({N_PARAMS} params), "
          f"{HW}x{HW} frames, batch {ams.batch_size}, K={ams.k_iters}, "
          f"gamma={ams.gamma}; mIoU before training {edge_miou():.4f}")
    batched.cache_clear()
    batched.set_exec_mode("auto")
    exec0 = batched.exec_info()
    adam_ops.launches = 0
    topk_ops.launches = 0
    for phase in range(3):
        feed(phase)
        t_now = 10.0 * (phase + 1)
        before = [tree.leaves(c.active) for c in clients]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        deltas = train_phases_fused(sessions, t_now)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        losses = [s.history[-1]["loss"] for s in sessions]
        check(all(d is not None for d in deltas), "every session trained")
        check(all(math.isfinite(x) for x in losses), f"finite losses {losses}")
        for s, c, d, old in zip(sessions, clients, deltas, before):
            c.apply_update(d)
            check_delta(s, c, d, old, phase)
        score = edge_miou()
        check(math.isfinite(score) and 0.0 <= score <= 1.0, f"mIoU {score}")
        print(f"phase {phase}: {start.elapsed_time(end):.1f} ms on the device "
              f"clock, {wall:.3f} s wall; losses {[round(x, 4) for x in losses]}; "
              f"delta bytes {[d.total_bytes for d in deltas]}; "
              f"selected {[int(d.values.size) for d in deltas]}; edge mIoU {score:.4f}")
    launches = {"masked_adam_3d": adam_ops.launches,
                "topk_threshold_bits": topk_ops.launches}
    ran = {k: v - exec0[k] for k, v in batched.exec_info().items()}
    ((_, race),) = batched.race_info().items()
    # K per eager loop and per graph replay, 1 per warm-up before a capture;
    # the first phase was the race: 1 warm + 2 timed runs of each shape
    want_k1 = ams.k_iters * (ran["loop_runs"] + ran["graph_replays"]) + ran["warm_iters"]
    print(f"main path launches: {launches}, want K1 {want_k1} (runs {ran}); auto race "
          f"at ({B}, {ams.k_iters}) (the first phase): winner {race['winner']}, best of 2 graph "
          f"{race['graph_s']:.4f} s, loop {race['loop_s']:.4f} s; cache "
          f"{batched.cache_info()}")
    check(launches["masked_adam_3d"] == want_k1, "K1 launches exact on the main path")
    check(ran["loop_runs"] + ran["graph_replays"] == 3 + 5
          and ran["graph_captures"] == ran["warm_iters"] == 1,
          f"one race (6 runs) and two cached phases: {ran}")
    check(batched.cache_info() == {"size": 1, "hits": 2, "misses": 1},
          f"the fused phase cache: {batched.cache_info()}")
    check(launches["topk_threshold_bits"] == 2, "K2 once per gradient-guided phase")
    return sessions, launches, dict(race=race, runs=ran, want_k1=want_k1)


def check_delta(s, c, d, old, phase):
    """The edge holds the server's params, fp16-rounded, where the mask
    is set, and its previous params elsewhere."""
    flat_m = np.unpackbits(np.frombuffer(gzip.decompress(d.packed_mask),
                                         np.uint8))[:d.n_total].astype(bool)
    check(d.n_total == N_PARAMS, "delta size")
    sel = int(flat_m.sum())
    check(sel == d.values.size, "delta values match the mask")
    if phase > 0:
        check(sel >= topk_ops.selection_count(N_PARAMS, FRAC), f"top-k selected {sel}")
    server = np.concatenate([l.detach().cpu().numpy().ravel() for l in tree.leaves(s.params)])
    edge = np.concatenate([l.cpu().numpy().ravel() for l in tree.leaves(c.active)])
    prev = np.concatenate([l.cpu().numpy().ravel() for l in old])
    want = np.where(flat_m, server.astype(np.float16).astype(np.float32), prev)
    check(np.array_equal(edge, want), "edge params after the delta")


def recheck_on_run(dev, sessions):
    """Both kernels against their plain versions on the run's real data."""
    u = stack_trees([s.u_prev for s in sessions])
    err2 = k2_compare(u, FRAC)
    mask = selection.stacked_gradient_guided_masks(u, FRAC)
    params = stack_trees([s.params for s in sessions])
    opt = stack_trees([s.opt_state for s in sessions])
    rng = np.random.default_rng(0)
    batches = [s.buffer.sample(rng, s.cfg.batch_size, 30.0) for s in sessions]
    frames = host_to_device(np.stack([b[0] for b in batches]), dev)
    labels = host_to_device(np.stack([b[1] for b in batches]), dev)
    _, grads = torch.func.vmap(sessions[0].task.loss_and_grad)(params, frames, labels)
    cfg = sessions[0].cfg
    _, bc = adam_ops.bias_correction(opt.count, lr=cfg.lr, b1=cfg.b1, b2=cfg.b2)
    plan = stacking.stack_plan(params)
    err1 = 0.0
    for group in plan.groups:
        bufs = [stacking.flatten_group(tree.leaves(t), group, plan.b)
                for t in (params, grads, opt.m, opt.v, mask)]
        err1 = max(err1, k1_compare(bufs, bc))
    print("re-check on the run's real u and gradients: K1 bitwise equal, "
          "K2 exact")
    return err1, err2


def exec_shape_check(dev, sessions):
    """The flat-layout K loop against the tree steps it replaced, and the
    graph shape against the eager loop, on the run's own state.

    * K1's optimizer loop on 3 real stacked gradients: flattened once and
      stepped by `masked_adam_flat`, against 3 calls of the tree step
      `masked_adam_stacked`; every output bit for bit.
    * One whole phase (K=20 replay batches from a separate RNG) through
      the eager loop twice and the CUDA graph twice: whether two eager runs
      agree bit for bit, and the graph's distance from the loop (params'
      fp16 ULPs, and the next phase's top-k masks of u), held to 3x the
      run-to-run spread. The second replay is traced with `torch.profiler`:
      its masked_adam_kernel launches must be K, the count K1's counter
      adds per replay."""
    cfg = sessions[0].cfg
    params = stack_trees([s.params for s in sessions])
    opt = stack_trees([s.opt_state for s in sessions])
    mask = selection.stacked_gradient_guided_masks(
        stack_trees([s.u_prev for s in sessions]), FRAC)
    rng = np.random.default_rng(4)
    batches = [[s.buffer.sample(rng, cfg.batch_size, 30.0) for _ in range(cfg.k_iters)]
               for s in sessions]
    frames = host_to_device(np.stack([np.stack([b[0] for b in bs])
                                      for bs in batches], axis=1), dev)
    labels = host_to_device(np.stack([np.stack([b[1] for b in bs])
                                      for bs in batches], axis=1), dev)
    vgrad = torch.func.vmap(sessions[0].task.loss_and_grad)
    grads = [vgrad(params, frames[k], labels[k])[1] for k in range(3)]
    again = vgrad(params, frames[0], labels[0])[1]
    grad_leaves_differing = sum(not torch.equal(a, b) for a, b in
                                zip(tree.leaves(grads[0]), tree.leaves(again)))
    print(f"vmapped loss/grad twice on the same inputs: {grad_leaves_differing} of "
          f"{len(tree.leaves(again))} gradient leaves differ")
    del again
    hp = dict(lr=cfg.lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps)
    p_t, s_t, u_t = params, opt, None
    for gr in grads:
        p_t, s_t, u_t = adam_ops.masked_adam_stacked(p_t, gr, s_t, mask, **hp)
    plan = stacking.stack_plan(params)
    p, m, v, msk = (stacking.flatten_tree(t, plan) for t in (params, opt.m, opt.v, mask))
    count = opt.count
    for gr in grads:
        p, m, v, u, count = adam_ops.masked_adam_flat(p, gr, m, v, msk, count, plan, **hp)
    flat = [stacking.unflatten_tree(x, plan) for x in (p, m, v, u)]
    torch.cuda.synchronize()
    check(torch.equal(count, s_t.count) and all(
        torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        for a, b in zip(tree.leaves((p_t, s_t.m, s_t.v, u_t)), tree.leaves(flat))),
        "the flat-layout K loop differs from the tree steps")
    print("flat-layout K loop (3 real gradients at B=8): bitwise equal to the tree "
          "steps masked_adam_stacked")
    del grads, p_t, s_t, u_t, flat
    args = (params, opt, mask, frames, labels)
    runners = {}
    for mode in ("loop", "graph"):
        batched.set_exec_mode(mode)
        try:
            runners[mode] = batched.fused_phase_fn(
                sessions[0].task.loss_and_grad, struct=tree.struct(args),
                k_iters=cfg.k_iters, optimizer=cfg.optimizer, momentum=cfg.momentum,
                device=dev, **hp)
        finally:
            batched.set_exec_mode("auto")
    outs = {}
    for run in ("loop", "loop2", "graph"):
        outs[run] = runners[run.rstrip("2")](*args)
    torch.cuda.synchronize()
    # K1's counter adds the captured launches at each replay; trace one
    # replay to see that many masked_adam_kernel launches on the device.
    # The tracer drops records from the end of a trace that stops right
    # after the work (on an H100: up to 623 of ~33,000 kernel records, the
    # last iteration's K1 among them in 6 of 40 traced replays; after a
    # 0.2 s pause at most 5, and K1's in none of 20). So the replay is
    # followed, inside the trace, by PAD_LAUNCHES small launches and that
    # pause.
    n0 = adam_ops.launches
    pad = torch.zeros(1, device=dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        outs["graph2"] = runners["graph"](*args)
        torch.cuda.synchronize()
        for _ in range(PAD_LAUNCHES):
            pad.add_(1)
        torch.cuda.synchronize()
        time.sleep(TRACE_PAUSE_S)
    kernels = [ev.name for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    traced = sum("masked_adam_kernel" in k for k in kernels)
    counted = adam_ops.launches - n0
    print(f"one graph replay traced: {traced} masked_adam_kernel launches on the device, "
          f"{counted} added to K1's counter, K={cfg.k_iters} ({len(kernels)} kernel "
          f"records, {PAD_LAUNCHES} padding launches after the replay)")
    check(traced == counted == cfg.k_iters,
          f"K1 under replay: traced {traced}, counted {counted}, want {cfg.k_iters}")

    def same(a, b):
        return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                   for x, y in zip(tree.leaves(a), tree.leaves(b)))

    def ulps(a, b):  # per coordinate, in fp16 units (the wire's type)
        def key(x):
            i = x.to(torch.float16).view(torch.int16).to(torch.int32)
            return torch.where(i < 0, -32768 - i, i)
        return torch.cat([(key(x) - key(y)).abs().reshape(-1)
                          for x, y in zip(tree.leaves(a), tree.leaves(b))])

    def distance(x, y):
        """Params' fp16 ULPs (max, share over 1) and the next phase's
        selection: the share of coordinates the top-k masks of u disagree on."""
        d = ulps(outs[x][0], outs[y][0])
        m_x, m_y = (torch.cat([l.reshape(-1) for l in tree.leaves(
            selection.stacked_gradient_guided_masks(outs[r][2], FRAC))]) for r in (x, y))
        return dict(bitwise=same(outs[x], outs[y]), params_max_ulps=int(d.max()),
                    params_share_over_1_ulp=float((d > 1).float().mean()),
                    next_mask_share_differing=float((m_x != m_y).float().mean()))

    res = {f"{x}_vs_{y}": distance(x, y)
           for x, y in (("loop2", "loop"), ("graph", "loop"), ("graph2", "graph"))}
    res["grad_leaves_differing_run_to_run"] = grad_leaves_differing
    res["k1_kernels_per_replay_traced"] = traced
    print(f"graph vs loop, one phase at ({B}, {cfg.k_iters}) on the run's state: "
          f"{json.dumps(res)}")
    e, r, g = res["loop2_vs_loop"], res["graph2_vs_graph"], res["graph_vs_loop"]
    check(g["bitwise"] or not e["bitwise"],
          "the eager loop is deterministic but the graph differs from it")
    # where the eager loop is not deterministic, the graph must stay within
    # 3x the larger run-to-run spread, two eager runs' or two replays'
    # (PERF.md §6: within 1.2x of the eager one on the H100)
    for x in ("params_share_over_1_ulp", "next_mask_share_differing"):
        check(g[x] <= 3 * max(e[x], r[x]),
              f"graph vs loop {x} {g[x]} beyond 3x the run-to-run spread "
              f"(eager {e[x]}, replays {r[x]})")
    return res


def phase_breakdown(dev, sessions):
    """Where a fused phase's time goes: each stage of the phase timed on
    its own, on the run's own state (replay batches drawn from a separate
    RNG, so no session is disturbed)."""
    cfg = sessions[0].cfg
    params = stack_trees([s.params for s in sessions])
    opt = stack_trees([s.opt_state for s in sessions])
    u = stack_trees([s.u_prev for s in sessions])
    mask = selection.stacked_gradient_guided_masks(u, FRAC)
    rng = np.random.default_rng(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = [[s.buffer.sample(rng, cfg.batch_size, 30.0)
                for _ in range(cfg.k_iters)] for s in sessions]
    frames = host_to_device(np.stack([np.stack([b[0] for b in bs])
                                      for bs in batches], axis=1), dev)
    labels = host_to_device(np.stack([np.stack([b[1] for b in bs])
                                      for bs in batches], axis=1), dev)
    torch.cuda.synchronize()
    prepare_ms = 1e3 * (time.perf_counter() - t0)
    vgrad = torch.func.vmap(sessions[0].task.loss_and_grad)
    grad_ms = time_ms(lambda: vgrad(params, frames[0], labels[0]), reps=5)
    _, grads = vgrad(params, frames[0], labels[0])
    hp = dict(lr=cfg.lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps)
    tree_ms = time_ms(lambda: adam_ops.masked_adam_stacked(params, grads, opt, mask, **hp))
    tree_dev_ms = device_ms(lambda: adam_ops.masked_adam_stacked(params, grads, opt, mask,
                                                                 **hp))
    plan = stacking.stack_plan(params)
    flat = [stacking.flatten_tree(t, plan) for t in (params, opt.m, opt.v, mask)]

    def flat_step():  # the K loop's step: grads concat + K1 + the next params' views
        out = adam_ops.masked_adam_flat(flat[0], grads, flat[1], flat[2], flat[3],
                                        opt.count, plan, **hp)
        return stacking.unflatten_tree(out[0], plan)

    adam_ms = time_ms(flat_step)
    adam_dev_ms = device_ms(flat_step)
    select_ms = time_ms(lambda: selection.stacked_gradient_guided_masks(u, FRAC))
    encode_ms = time_ms(lambda: encode_delta_stack(params, mask, B), reps=3)
    k = cfg.k_iters
    total = prepare_ms + k * (grad_ms + adam_ms) + select_ms + encode_ms
    print(f"phase breakdown (ms, each stage timed alone): prepare+H2D "
          f"{prepare_ms:.1f}; {k} x vmapped loss/grad {grad_ms:.2f} = "
          f"{k * grad_ms:.1f}; {k} x flat-layout masked Adam (grads concat + K1 + "
          f"param views) {adam_ms:.3f} (device {adam_dev_ms:.4f}) = {k * adam_ms:.2f}; "
          f"stacked selection {select_ms:.3f}; encode {encode_ms:.1f}; sum {total:.1f}; "
          f"beside it the tree step masked_adam_stacked (5 trees flattened, one cat "
          f"each + K1 + views) {tree_ms:.3f} (device {tree_dev_ms:.4f})")
    return dict(prepare_ms=prepare_ms, grad_ms=grad_ms, adam_ms=adam_ms,
                adam_device_ms=adam_dev_ms, tree_step_ms=tree_ms,
                tree_step_device_ms=tree_dev_ms, select_ms=select_ms,
                encode_ms=encode_ms, sum_ms=total)


# ---------------------------------------------------------------------------
# the streaming schemes (sim/runner.py)
# ---------------------------------------------------------------------------


def zero_launches():
    adam_ops.launches = 0
    topk_ops.launches = 0


def read_launches() -> dict:
    return {"K1": adam_ops.launches, "K2": topk_ops.launches}


class RecordedSession(AMSSession):
    """`AMSSession` that keeps itself and each phase's time (host clock
    around the phase, from an idle device to the delta on the host), so
    the smoke can read the ``ams`` run's last state afterwards."""

    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.phase_s = []
        RecordedSession.made.append(self)

    def train_phase(self, t_now):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super().train_phase(t_now)
        torch.cuda.synchronize()
        self.phase_s.append(time.perf_counter() - t0)
        return out


def run_one(scheme, world, pre, ams, sim, expect, label=None):
    """One `run_scheme` with the launch counts zeroed just before and read
    just after; ``expect(result, extra)`` gives the counts it must have."""
    jit_iters = [0]
    lg = world.loss_and_grad
    if scheme == "jit":  # count Just-In-Time's training iterations
        def counting(*args):
            jit_iters[0] += 1
            return lg(*args)
        world.loss_and_grad = counting
    runner.AMSSession = RecordedSession
    try:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        r = runner.run_scheme(scheme, world, pre, ams, sim)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        runner.AMSSession = AMSSession
        world.loss_and_grad = lg
    duration = world.video.cfg.duration
    up, down = r.bandwidth_kbps(duration)
    check(all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in r.miou_per_frame),
          f"{scheme}: every mIoU finite and in [0, 1]")
    want = expect(r, jit_iters[0])
    print(f"scheme {label or scheme}: mean mIoU {r.mean_miou:.4f} over "
          f"{len(r.miou_per_frame)} frames, uplink {up:.2f} Kbps, downlink "
          f"{down:.2f} Kbps, {r.updates} updates, wall {wall:.2f} s, launches "
          f"{launches}" + (f", {jit_iters[0]} training iterations" if scheme == "jit"
                           else ""))
    check(launches == want, f"{label or scheme}: launches {launches}, want {want}")
    return dict(scheme=scheme, mean_miou=r.mean_miou, up_kbps=up, down_kbps=down,
                updates=r.updates, wall_s=wall, launches=launches, result=r)


def schemes_path(dev):
    """The five schemes at the student's full width, then ``ams`` and
    ``no_custom`` under a learned teacher. Returns the runs, the ``ams``
    run's session and the seconds the phase took."""
    t_start = time.perf_counter()
    seg = SegConfig(n_classes=5, width=WIDTH)
    ams = AMSConfig(**SCHEME_AMS)
    sim = runner.SimConfig(**SCHEME_SIM)
    zero_launches()
    t0 = time.perf_counter()
    pre = pretrain_student(seg, n_videos=5, steps=PRETRAIN_STEPS, batch=8, lr=2e-3,
                           seed=42, video_kw=dict(height=HW, width=HW, fps=4.0,
                                                  duration=60.0), device=dev)
    torch.cuda.synchronize()
    pre_launches = read_launches()
    print(f"streaming schemes: pretrain_student {PRETRAIN_STEPS} steps (batch 8, "
          f"5 videos of {HW}x{HW}, seed 42) in {time.perf_counter() - t0:.2f} s; "
          f"launches {pre_launches}")
    check(pre_launches == {"K1": PRETRAIN_STEPS, "K2": 0}, "pretrain_student launches")
    world = SegWorld.make(VideoConfig(**SCHEME_VIDEO), seg)
    n_frames = world.video.cfg.n_frames
    print(f"streaming schemes: {n_frames} frames of {HW}x{HW} at "
          f"{SCHEME_VIDEO['fps']} fps, {ams}, {sim}")

    def ams_expect(r, _):
        n = len(r.extras["history"])
        check(r.updates == n >= 5, f"ams shipped {r.updates} updates (at least 5)")
        return {"K1": ams.k_iters * n, "K2": n - 1}

    def one_time_expect(r, _):
        check(r.updates == 1, f"one_time shipped {r.updates} updates")
        return {"K1": sim.one_time_iters, "K2": 0}

    def no_custom_expect(r, _):
        check(r.ledger.up_bytes == r.ledger.down_bytes == 0, "no_custom moves 0 bytes")
        return {"K1": 0, "K2": 0}

    def remote_expect(r, _):
        check(r.ledger.up_bytes > 0 and r.ledger.down_bytes > 0,
              "remote_tracking moves bytes both ways")
        return {"K1": 0, "K2": 0}

    def jit_expect(r, iters):
        check(iters > 0 and r.updates > 0, "jit trained and shipped")
        return {"K1": 0, "K2": iters - 1}

    expects = {"no_custom": no_custom_expect, "one_time": one_time_expect,
               "remote_tracking": remote_expect, "jit": jit_expect, "ams": ams_expect}
    runs = {}
    RecordedSession.made.clear()
    for scheme in runner.SCHEMES:
        runs[scheme] = run_one(scheme, world, pre, ams, sim, expects[scheme])
    session = RecordedSession.made[-1]
    zero_launches()
    t0 = time.perf_counter()
    teacher = train_teacher(world.video, seg.n_classes, steps=TEACHER_STEPS, device=dev)
    torch.cuda.synchronize()
    teacher_launches = read_launches()
    print(f"streaming schemes: train_teacher {TEACHER_STEPS} steps in "
          f"{time.perf_counter() - t0:.2f} s; launches {teacher_launches}")
    check(teacher_launches == {"K1": TEACHER_STEPS, "K2": 0}, "train_teacher launches")
    learned = SegWorld(video=world.video, teacher=teacher, seg_cfg=seg)
    for scheme in ("ams", "no_custom"):
        runs[f"learned_{scheme}"] = run_one(scheme, learned, pre, ams, sim,
                                            expects[scheme], label=f"{scheme} (learned teacher)")
    launches = {"pretrain_student": pre_launches, "train_teacher": teacher_launches,
                **{k: v["launches"] for k, v in runs.items()}}
    phase_s = time.perf_counter() - t_start
    print(f"streaming schemes: phase wall {phase_s:.1f} s; ams phases (s, host clock "
          f"around each): {[round(x, 4) for x in session.phase_s]}")
    print("TABLE1 " + json.dumps({k: {x: v[x] for x in ("mean_miou", "up_kbps",
                                                          "down_kbps", "updates", "wall_s")}
                                  for k, v in runs.items()}))
    return pre, runs, session, launches, phase_s


def recheck_b1(dev, s, bw, flops):
    """K1 and K2 at B = 1 against their plain versions on the ``ams`` run's
    last update and a real gradient; K2's times at B = 1."""
    u1 = tree.tree_map(lambda l: l.unsqueeze(0), s.u_prev)
    err2 = k2_compare(u1, FRAC)
    mask = selection.gradient_guided_mask(s.u_prev, FRAC)
    frames, labels = s.buffer.sample(np.random.default_rng(2), s.cfg.batch_size,
                                     s.buffer.stamps[-1])
    _, grads = s.task.loss_and_grad(s.params, host_to_device(frames, dev),
                                    host_to_device(labels, dev))
    one = [tree.tree_map(lambda l: l.unsqueeze(0), t)
           for t in (s.params, grads, s.opt_state.m, s.opt_state.v, mask)]
    _, bc = adam_ops.bias_correction(s.opt_state.count.reshape(1), lr=s.cfg.lr,
                                     b1=s.cfg.b1, b2=s.cfg.b2)
    plan = stacking.stack_plan(one[0])
    err1 = 0.0
    for group in plan.groups:
        bufs = [stacking.flatten_group(tree.leaves(t), group, 1) for t in one]
        err1 = max(err1, k1_compare(bufs, bc))
    bits, n = topk_ops.abs_bits_buffer(u1)
    k = topk_ops.selection_count(n, FRAC)
    ms = device_ms(lambda: topk_ops.topk_threshold_bits(bits, k))
    plain_ms = device_ms(lambda: topk_ref.topk_threshold_bits_ref(bits, k), n=5)
    absu = torch.cat([l.abs().reshape(-1) for l in tree.leaves(s.u_prev)])[None]
    library_ms = device_ms(lambda: torch.kthvalue(absu, n - k + 1, dim=1), n=5)
    check(torch.equal(torch.kthvalue(absu, n - k + 1, dim=1).values.view(torch.int32),
                      topk_ops.topk_threshold_bits(bits, k)),
          "K2 at B=1 differs from torch.kthvalue")
    nbytes = bits.numel() * 4 + 4
    bound_ms = 1e3 * max(nbytes / bw, bits.numel() / flops)
    print(f"re-check at B=1 on the ams run's last u and a real gradient: K1 bitwise "
          f"equal, K2 exact; K2 topk_threshold_bits {tuple(bits.shape)} k={k}: kernel "
          f"{ms:.4f} ms on the device ({topk_ops.blocks_per_session(bits)} blocks), "
          f"plain {plain_ms:.4f} ms, torch.kthvalue {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e6:.3f} MB)")
    return err1, err2, dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms)


def sequential_phase_breakdown(dev, s):
    """Where one sequential ``ams`` phase's time goes, each stage timed on
    its own on the run's last state (replay batches from a separate RNG)."""
    cfg = s.cfg
    t_now = s.buffer.stamps[-1]
    rng = np.random.default_rng(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = [s.buffer.sample(rng, cfg.batch_size, t_now) for _ in range(cfg.k_iters)]
    frames = host_to_device(np.stack([b[0] for b in batches]), dev)
    labels = host_to_device(np.stack([b[1] for b in batches]), dev)
    torch.cuda.synchronize()
    prepare_ms = 1e3 * (time.perf_counter() - t0)
    grad_ms = time_ms(lambda: s.task.loss_and_grad(s.params, frames[0], labels[0]), reps=5)
    _, grads = s.task.loss_and_grad(s.params, frames[0], labels[0])
    mask = selection.gradient_guided_mask(s.u_prev, FRAC)
    adam_ms = time_ms(lambda: masked_adam_update(s.params, grads, s.opt_state, mask,
                                                 lr=cfg.lr, b1=cfg.b1, b2=cfg.b2,
                                                 eps=cfg.eps))
    select_ms = time_ms(lambda: selection.gradient_guided_mask(s.u_prev, FRAC))
    encode_ms = time_ms(lambda: encode_delta(s.params, mask, cfg.value_dtype), reps=3)
    k = cfg.k_iters
    total = prepare_ms + k * (grad_ms + adam_ms) + select_ms + encode_ms
    print(f"sequential ams phase breakdown (ms, each stage timed alone): prepare+H2D "
          f"{prepare_ms:.1f}; {k} x loss/grad {grad_ms:.2f} = {k * grad_ms:.1f}; {k} x "
          f"masked Adam (flatten + K1 at B=1 + views) {adam_ms:.3f} = {k * adam_ms:.2f}; "
          f"selection (K2 at B=1 + masks) {select_ms:.3f}; encode {encode_ms:.1f}; "
          f"sum {total:.1f}")
    return dict(prepare_ms=prepare_ms, grad_ms=grad_ms, adam_ms=adam_ms,
                select_ms=select_ms, encode_ms=encode_ms, sum_ms=total)


# ---------------------------------------------------------------------------
# the serving engine (sim/multiclient.py, serving/)
# ---------------------------------------------------------------------------


def serving_path(dev, pre):
    """`run_multiclient` on the card with the schemes phase's pretrained
    student; K1/K2 launches checked against the engine's and the update
    pipeline's own counters. Returns the results, the launches and the
    groups by B."""
    seg = SegConfig(n_classes=5, width=WIDTH)
    ams = AMSConfig(**SCHEME_AMS)
    cfg = ServingConfig(duration=SERVE_S, device_backend="torch")
    torch.cuda.synchronize()
    info0, snap = batched.update_pipeline_info(), timing.snapshot()
    exec0, races0 = batched.exec_info(), batched.race_info()
    zero_launches()
    t0 = time.perf_counter()
    r = run_multiclient(SERVE_CLIENTS, pre, seg, ams, duration=SERVE_S,
                        video_kw=dict(height=HW, width=HW, fps=4.0),
                        policy="fair", n_gpus=1, fuse_train=SERVE_FUSE,
                        serving_cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    info = {k: v - info0[k] for k, v in batched.update_pipeline_info().items()}
    stats = timing.delta(snap)

    def calls(stage):
        return {key: v["calls"] for (st, key), v in stats.items() if st == stage}

    stacked = calls("train_fused")            # {(B, K): groups}
    singletons = sum(calls("encode_solo").values())
    groups = {1: singletons} if singletons else {}
    for (b, _), n in sorted(stacked.items()):
        groups[b] = groups.get(b, 0) + n
    ran = {k: v - exec0[k] for k, v in batched.exec_info().items()}
    races = {k: v for k, v in batched.race_info().items() if k not in races0}
    solo_selects = sum(calls("select_solo").values())
    # K per singleton phase, per eager loop and per graph replay; 1 per
    # warm-up before a capture. A stacked call that missed the cache raced
    # the two shapes: 3 runs of each, 5 more than a cached call.
    want = {"K1": ams.k_iters * (singletons + ran["loop_runs"] + ran["graph_replays"])
            + ran["warm_iters"],
            "K2": info["stacked_select_launches"] + solo_selects}
    phases = r["phases_per_client"]
    print(f"serving: {SERVE_CLIENTS} clients x {seg_param_count(seg):,} params, "
          f"{HW}x{HW} at 4 fps for {SERVE_S:.0f} s, fair, 1 GPU slot on "
          f"{cfg.device_backend} ({torch.cuda.get_device_name(0)}), fuse_train "
          f"{SERVE_FUSE}; groups by B {groups}; update pipeline {info}; launches "
          f"{launches}, want {want}")
    check(sum(phases) == singletons + info["stacked_encode_sessions"],
          f"serving: {sum(phases)} phases, {singletons} singletons + "
          f"{info['stacked_encode_sessions']} in stacked groups")
    check(sum(calls("select_stacked").values()) == info["stacked_select_launches"],
          "serving: stacked selections timed as counted")
    check(launches == want, f"serving: launches {launches}, want {want}")
    check(ran["loop_runs"] + ran["graph_replays"] == sum(stacked.values()) + 5 * len(races),
          f"serving: {ran} for {sum(stacked.values())} stacked calls, {len(races)} races")
    modes = debug_snapshot()["auto_exec_modes"]
    print(f"serving: exec runs {ran}; auto_exec_modes {modes}; races "
          + "; ".join(f"{race_label(key)} {backend}:{abs(hash(key)) % 10**8:08d} "
                      f"winner {v['winner']} "
                      f"graph {v['graph_s']:.4f} s loop {v['loop_s']:.4f} s"
                      for (backend, key), v in races.items())
          + f"; cache {batched.cache_info()}")
    check(any(b >= 2 for b, _ in stacked), "serving: a fused group of B >= 2 trained")
    check(all(math.isfinite(m) and 0.0 <= m <= 1.0 for m in r["miou_per_client"]),
          "serving: every client's mIoU finite and in [0, 1]")
    check(min(phases) > 0 and r["delta_latency_mean_s"] > 0.0,
          "serving: every client trained and received deltas")
    print(f"serving: mean mIoU {r['mean_miou']:.4f}, per client "
          f"{[round(m, 4) for m in r['miou_per_client']]}; phases served "
          f"{r['phases_served']} ({phases} per client), deferred "
          f"{r['phases_deferred']}, dropped {r['dropped_requests']}; fused launches "
          f"{r['fused_launches']} covering {r['fused_sessions']} sessions; mean up "
          f"{r['mean_up_kbps']:.2f} Kbps, down {r['mean_down_kbps']:.2f} Kbps; delta "
          f"latency mean {r['delta_latency_mean_s']:.3f} s, max "
          f"{r['delta_latency_max_s']:.3f} s; {r['events_processed']} events; "
          f"wall {wall:.2f} s (engine {r['wall_s']:.2f} s); modeled gpu "
          f"utilization {r['gpu_utilization']:.3f}")
    for (st, key), v in sorted(stats.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        print(f"serving stage {st} {key}: {v['calls']} calls, first "
              f"{v['first_calls']} ({v['first_s']:.3f} s), steady {v['steady_s']:.3f} s, "
              f"{v['nbytes']:,} bytes")
    drift = r["observability"]["drift"]
    for st, e in drift.items():
        ratio = e["drift_ratio"]
        print(f"serving drift {st}: {e['steady_calls']} steady of {e['calls']} calls; "
              f"measured {e['measured_steady_s']:.3f} s on the card "
              f"({e['measured_per_call_s']:.4f} s a call) vs modeled "
              f"{e['modeled_steady_s']:.3f} s; drift_ratio "
              f"{'none (unpriced)' if ratio is None else f'{ratio:.3f}'}; first calls "
              f"{e['compile_s']:.3f} s")
    report = serving_stage_report(drift)
    for st, e in report["stages"].items():
        frac = e["roofline_fraction"]
        eff = e["model_efficiency"]
        print(f"serving stage report {st}: measured {e['measured_s']:.3f} s, modeled "
              f"{e['modeled_s']:.3f} s, model efficiency "
              f"{'none' if eff is None else f'{eff:.3f}'}, {e['nbytes']:,} bytes, HBM "
              f"roofline fraction {'none' if frac is None else f'{frac:.4f}'}")
    print(f"serving stage report: bottleneck {report['bottleneck']}, measured total "
          f"{report['measured_total_s']:.3f} s")
    print("SERVING " + json.dumps(dict(
        wall_s=wall, groups_by_b=groups, launches=launches, exec_runs=ran,
        races={race_label(k): v for (_, k), v in races.items()},
        **{k: r[k] for k in ("mean_miou", "miou_per_client", "phases_served",
                             "phases_deferred", "dropped_requests", "mean_up_kbps",
                             "mean_down_kbps", "delta_latency_mean_s",
                             "delta_latency_max_s", "events_processed",
                             "fused_launches", "fused_sessions")},
        drift={k: {x: e[x] for x in ("calls", "steady_calls", "measured_steady_s",
                                     "modeled_steady_s", "drift_ratio")}
               for k, e in drift.items()})))
    return r, launches, groups


# ---------------------------------------------------------------------------
# the LLM serving path: Gemma-2 9B prefill and greedy decode
# ---------------------------------------------------------------------------

def within_bf16_ulp(got, want, atol=1e-5) -> bool:
    """|got - want| <= one bf16 ulp of want (+ atol near zero): two float32
    results a few roundings apart round to neighbouring bf16 values."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    return bool(((g - w).abs() <= ulp + atol).all())


def k3_compare(x, w) -> float:
    got = norm_ops.rms_norm(x, w)
    want = norm_ref.rms_norm_ref(x, w)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape, "K3 dtype/shape")
    if x.dtype == torch.float32:  # sums in another order: ~1e-6 relative
        check(torch.allclose(got, want, rtol=2e-6, atol=1e-6),
              "K3 differs from its plain version beyond 2e-6")
    else:
        check(within_bf16_ulp(got, want), "K3 differs from its plain version "
              "by more than one bf16 ulp")
    return float((got.float() - want.float()).abs().max())


def k4_compare(q, k, v, **kw) -> float:
    got = attn_ops.flash_attention(q, k, v, **kw)
    want = attn_ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape, "K4 dtype/shape")
    check(bool(torch.isfinite(got.float()).all()), "K4 output finite")
    if q.dtype == torch.float32:  # online vs two-pass softmax, other sums
        check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
              "K4 differs from its plain version beyond 2e-5")
    else:
        check(within_bf16_ulp(got, want), "K4 differs from its plain version "
              "by more than one bf16 ulp")
    err = float((got.float() - want.float()).abs().max())
    del got, want
    torch.cuda.empty_cache()
    return err


def expected_launches(cfg) -> tuple[int, int, int]:
    """(K3 launches per prefill, K3 launches per decode step, K4 launches
    per prefill), from the block structure: a self-attention block's
    RMSNorms (2, 4 with post-norms) and one K4; an ``xattn`` block's 2
    norms and one K4 (onto the memory); an ``attn_xattn`` block's 3 norms
    and 2 K4; a Mamba2 block's ln1 and inner norm; an RWKV6 block's ln1,
    ln2 and ln_x (block norms are K3 only where the model's norm is
    RMSNorm); the shared attention block's 2 norms and one K4 per group;
    the final norm. The encoder (``encoder_layers`` non-causal blocks and
    its final norm) runs in prefill only, over the memory. Decode never
    launches K4."""
    rms = int(cfg.norm == "rms")
    per_attn = (4 if cfg.post_norm else 2) * rms
    k3 = k4 = 0
    for kind in cfg.pattern:
        if kind == "mamba":
            k3 += rms + 1
        elif kind == "rwkv":
            k3 += 2 * rms + 1
        elif kind == "xattn":
            k3, k4 = k3 + 2 * rms, k4 + 1
        elif kind == "attn_xattn":
            k3, k4 = k3 + 3 * rms, k4 + 2
        else:
            k3, k4 = k3 + per_attn, k4 + 1
    k3, k4 = k3 * cfg.num_groups, k4 * cfg.num_groups
    if cfg.shared_attn:
        k3 += 2 * rms * cfg.num_groups
        k4 += cfg.num_groups
    k3 += rms
    encoder_k3 = (per_attn * cfg.encoder_layers + rms) if cfg.encoder_layers else 0
    return k3 + encoder_k3, k3, k4 + cfg.encoder_layers


def llm_path(dev, path_inputs, n_decode: int, label: str = "LLM"):
    """One LLM at full width (and depth, unless its config says a cut):
    random bf16 weights drawn on the card (``path_inputs(dev)``), a batch of
    random prompts (and a memory of stub embeddings for a model with
    cross-attention), prefill, then ``n_decode`` greedy decode steps
    through `launch.serve.serve`. A first, cold run (the kernels' first
    launches, cuBLAS's first calls at these shapes) goes before the run
    whose times and launch counts are kept: K3 and K4 are counted from 0
    just before it and read just after, and must equal
    `expected_launches` (Gemma-2: K3 169 per prefill and per decode step,
    K4 42 per prefill), all K4 launches on its bf16 route."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, prompt, memory = path_inputs(dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = sum(l.numel() for l in tree.leaves(params))
    check(n_params == build_model(cfg).num_params(), "parameter count")
    batch, prompt_len = prompt.shape
    extra = (f", {cfg.num_experts} experts top-{cfg.experts_per_token} + "
           f"{cfg.num_shared_experts} shared of d_ff {cfg.expert_d_ff}, capacity "
           f"{cfg.capacity_factor}" if cfg.num_experts else "")
    if "mamba" in cfg.pattern:
        extra += (f", pattern {cfg.pattern} x {cfg.num_groups} groups, Mamba2 d_inner "
                f"{cfg.ssm_expand * cfg.d_model} in heads of {cfg.ssm_head_dim}, d_state "
                f"{cfg.ssm_state}, conv {cfg.ssm_conv}, chunk {cfg.ssm_chunk}, shared "
                f"attention {cfg.shared_attn}")
    if "rwkv" in cfg.pattern:
        extra += (f", RWKV6 {cfg.d_model // cfg.ssm_head_dim} wkv heads of "
                f"{cfg.ssm_head_dim}, channel-mix d_ff {cfg.d_ff}, {cfg.norm} norms")
    if memory is not None:
        extra += (f", pattern {cfg.pattern} x {cfg.num_groups} groups, encoder layers "
                  f"{cfg.encoder_layers}, {cfg.norm} norms, positions {cfg.pos}; memory "
                  f"{tuple(memory.shape)} {memory.dtype} N(0, 1)")
    print(f"{label} path: {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"window {cfg.window_size}, softcaps {cfg.attn_logit_softcap}/"
          f"{cfg.final_logit_softcap}, {cfg.mlp_act}{extra}), {n_params:,} params in "
          f"{cfg.param_dtype}, drawn on the card in {draw_s:.1f} s "
          f"({torch.cuda.memory_allocated():,} bytes allocated); batch {batch}, "
          f"prompts of {prompt_len} tokens, {n_decode} decode steps")
    cold = serve(cfg, params, prompt, n_decode, dev, memory=memory)
    check(cold["finite"], f"{label}: every logit of the cold run finite")
    norm_ops.launches = 0
    attn_ops.reset_launches()
    r = serve(cfg, params, prompt, n_decode, dev, memory=memory)
    launches = {"rms_norm": norm_ops.launches, "flash_attention": attn_ops.launches,
                "flash_attention_by_route": dict(attn_ops.launches_by_route)}
    peak = torch.cuda.max_memory_allocated()
    capacity = torch.cuda.get_device_properties(dev).total_memory
    toks = r["tokens"]
    print(f"{label} prefill {r['prefill_ms']:.1f} ms, decode "
          f"{r['decode_ms_per_token']:.3f} ms per token (CUDA events; the cold first "
          f"run: {cold['prefill_ms']:.1f} ms, {cold['decode_ms_per_token']:.3f} ms); "
          f"peak memory {peak / 2**30:.2f} GiB ({peak:,} bytes of the card's "
          f"{capacity:,}); all logits finite: {r['finite']}")
    print(f"{label} launches: prefill {r['launches']['prefill']}, decode "
          f"{r['launches']['decode']} over {n_decode} steps; total {launches} "
          f"(K4 by route: {launches['flash_attention_by_route']})")
    print(f"{label} first 16 generated tokens of row 0: {toks[0, :16].tolist()}")
    n_norms, n_decode_norms, n_attn = expected_launches(cfg)
    check(peak < capacity, f"{label}: peak memory under the card's")
    check(r["finite"], f"{label}: every logit finite")
    check(torch.equal(toks, cold["tokens"]),
          f"{label}: the cold and the timed run's tokens agree")
    check(tuple(toks.shape) == (batch, n_decode + 1), f"{label}: generated tokens' shape")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{label}: tokens in the vocabulary")
    check(r["launches"]["prefill"] == {"rms_norm": n_norms, "flash_attention": n_attn},
          f"{label}: prefill launches {r['launches']['prefill']}, expected "
          f"{(n_norms, n_attn)}")
    check(r["launches"]["decode"] == {"rms_norm": n_decode_norms * n_decode,
                                      "flash_attention": 0},
          f"{label}: decode launches {r['launches']['decode']}")
    check(launches["rms_norm"] == n_norms + n_decode_norms * n_decode
          and launches["flash_attention"] == n_attn, f"{label}: path launches")
    check(launches["flash_attention_by_route"] == {"bf16_wgmma": n_attn,
                                                   "f32_cuda_cores": 0},
          f"{label}: K4 routes {launches['flash_attention_by_route']}")
    return cfg, params, prompt, memory, r, cold, launches, peak


def analytic_shares(cfg, r, batch: int, prompt_len: int, n_decode: int, label: str):
    """The run's prefill and decode times against `roofline.analytic`'s
    FLOPs and bytes at the card's data-sheet peaks (`launch/mesh.py`):
    prefill's model FLOPs over time x peak (MFU) and its bound (the larger
    of FLOPs / peak and bytes / HBM rate) over its time; a decode step's
    bytes over its time x HBM rate, against the cache of prompt_len +
    n_decode positions."""
    pre = analytic_cost(cfg, ShapeSpec("prefill", prompt_len, batch))
    dec = analytic_cost(cfg, ShapeSpec("decode", prompt_len + n_decode, batch))
    t_pre, t_dec = r["prefill_ms"] / 1e3, r["decode_ms_per_token"] / 1e3
    bound_pre = roofline_terms(pre["flops"], pre["bytes"], 0.0, 1)
    bound_dec = roofline_terms(dec["flops"], dec["bytes"], 0.0, 1)
    out = dict(prefill_flops=pre["flops"], prefill_model_flops=pre["model_flops"],
               prefill_bytes=pre["bytes"], prefill_bound_ms=1e3 * bound_pre["step_time_lb_s"],
               prefill_bound_by=bound_pre["bottleneck"],
               prefill_mfu=pre["model_flops"] / (t_pre * PEAK_FLOPS_BF16),
               prefill_bound_share=bound_pre["step_time_lb_s"] / t_pre,
               decode_bytes=dec["bytes"], decode_bound_ms=1e3 * bound_dec["step_time_lb_s"],
               decode_bound_by=bound_dec["bottleneck"],
               decode_bw_share=dec["bytes"] / (t_dec * HBM_BW))
    print(f"{label} shares of the analytic bound ({cfg.name}; {PEAK_FLOPS_BF16 / 1e12:.0f} "
          f"TFLOP/s bf16, {HBM_BW / 1e12} TB/s): prefill {pre['flops']:.4e} FLOPs "
          f"({pre['model_flops']:.4e} model), {pre['bytes']:.4e} bytes, bound "
          f"{out['prefill_bound_ms']:.2f} ms by {out['prefill_bound_by']}; MFU "
          f"{out['prefill_mfu']:.3f}, bound/time {out['prefill_bound_share']:.3f}. Decode "
          f"{dec['bytes']:.4e} bytes a step, bound {out['decode_bound_ms']:.3f} ms by "
          f"{out['decode_bound_by']}; bytes/(time x HBM rate) {out['decode_bw_share']:.3f}")
    return out


def llm_layer_inputs(cfg, params, prompt):
    """The run's own data for K3 and K4, recomputed from the prompt: the
    input of layer 0's first norm, and layer 0's (local) and layer 1's
    (global) q, k, v."""
    B, S = prompt.shape
    positions = torch.arange(S, device=prompt.device).expand(B, S)
    x = embed_apply(cfg, params["embed"], prompt, positions)
    gp = tfm.group_params(params, 0)
    local, glob = gp["b0"], gp["b1"]
    qkv_local = _proj_qkv(cfg, local["attn"], apply_norm(cfg, x, local["ln1"]),
                          positions=positions)
    x1, _, _ = tfm.block_apply(cfg, cfg.pattern[0], local, x, positions=positions)
    qkv_global = _proj_qkv(cfg, glob["attn"], apply_norm(cfg, x1, glob["ln1"]),
                           positions=positions)
    return (x, local["ln1"]), qkv_local, qkv_global


def k3_time(x, w, bw, n=20):
    """K3's device time at x's shape beside its plain version's,
    F.rms_norm's (with weight 1 + w) and its bound."""
    ms = device_ms(lambda: norm_ops.rms_norm(x, w), n=n)
    call_ms = time_ms(lambda: norm_ops.rms_norm(x, w))
    plain_ms = device_ms(lambda: norm_ref.rms_norm_ref(x, w), n=5)
    w1 = (1.0 + w.float()).to(w.dtype)
    library_ms = device_ms(lambda: torch.nn.functional.rms_norm(
        x, (x.shape[-1],), weight=w1, eps=1e-6), n=n)
    y = torch.empty_like(x)
    copy_ms = device_ms(lambda: y.copy_(x), n=n)  # the same bytes, no arithmetic
    nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
    bound_ms = 1e3 * nbytes / bw
    print(f"K3 rms_norm {tuple(x.shape)} {x.dtype} ({norm_ops.variant(x, w)}): kernel "
          f"{ms:.4f} ms on the device ({call_ms:.4f} ms per call from idle), plain "
          f"{plain_ms:.4f} ms, F.rms_norm {library_ms:.4f} ms (kernel/F.rms_norm "
          f"{ms / library_ms:.3f}), Tensor.copy_ of x {copy_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e6:.3f} MB, {bound_ms / ms:.1%} of it)")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
                copy_ms=copy_ms, bound_ms=bound_ms)


def k3_phase(dev, cfg, norm_in, bw):
    """K3 against its plain version on synthetic rows and on the run's
    prefill-layer input; then its time at the prefill's shape and at a
    decode step's (the last position of the same input)."""
    g = torch.Generator(device=dev).manual_seed(13)
    err = 0.0
    for shape, dt, wdt in (((3, 7, 3584), torch.float32, torch.float32),
                           ((5, 33), torch.float32, torch.bfloat16),
                           ((MAIN_BATCH, 1, 3584), torch.bfloat16, torch.bfloat16),
                           ((4, 40_000), torch.bfloat16, torch.float32)):
        x = (torch.randn(shape, generator=g, device=dev) * 3).to(dt)
        w = (torch.randn(shape[-1], generator=g, device=dev) * 0.1).to(wdt)
        err = max(err, k3_compare(x, w))
    x, w0 = norm_in
    w = (torch.randn(w0.shape, generator=g, device=dev) * 0.1).to(w0.dtype)
    err = max(err, k3_compare(x, w0), k3_compare(x, w))
    print(f"K3 rms_norm within 1 bf16 ulp (float32: 2e-6) of its plain version on "
          f"4 synthetic shapes and on the run's layer-0 input {tuple(x.shape)} "
          f"(its zero-init weight and a random one); max abs err {err:.3e}")
    xd = x[:, -1:].contiguous()  # a decode step's input: (MAIN_BATCH, 1, d)
    err = max(err, k3_compare(xd, w))
    check(norm_ops.variant(x, w) == "warp_per_row" and norm_ops.variant(xd, w) == "split_row",
          "K3 takes a warp per row in prefill and a split row in decode")
    prefill = k3_time(x, w, bw)
    decode = k3_time(xd, w, bw, n=200)
    return dict(err=err, **prefill, **{f"decode_{k}": v for k, v in decode.items()})


def live_pairs(S: int, window: int) -> int:
    """Causal (query, key) pairs that the mask keeps, over one head."""
    if not window:
        return S * (S + 1) // 2
    return sum(min(i + 1, window) for i in range(S))


def k4_phase(dev, cfg, qkv_local, qkv_global, bw, bf16_flops):
    """K4 against its plain version on synthetic inputs and on the run's
    local and global layer; then times at both shapes, and beside
    scaled_dot_product_attention at softcap 0."""
    g = torch.Generator(device=dev).manual_seed(14)
    err = 0.0
    for B, S, KV, G, hd, dt, kw in (
            (1, 777, 1, 8, 256, torch.float32, dict(causal=True, window=300, softcap=30.0)),
            (2, 1000, 8, 2, 256, torch.bfloat16, dict(causal=False, window=0, softcap=0.0)),
            (1, 300, 2, 2, 256, torch.bfloat16, dict(causal=True, window=100, softcap=50.0)),
            (1, 1000, 1, 8, 64, torch.bfloat16, dict(causal=True, window=0, softcap=50.0)),
            (1, 1000, 2, 2, 128, torch.bfloat16, dict(causal=True, window=300, softcap=0.0))):
        q = torch.randn(B, S, KV, G, hd, generator=g, device=dev).to(dt)
        k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
        v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
        err = max(err, k4_compare(q, k, v, **kw))
    print(f"K4 flash_attention within tolerance of its plain version on 5 synthetic "
          f"cases (ragged S, MQA, non-causal, head dims 64/128/256 in bf16, float32 "
          f"at 2e-5); max abs err {err:.3e}")
    cap = cfg.attn_logit_softcap
    kw_local = dict(causal=True, window=cfg.window_size, softcap=cap)
    kw_global = dict(causal=True, window=0, softcap=cap)
    err_local = k4_compare(*qkv_local, **kw_local)
    err_global = k4_compare(*qkv_global, **kw_global)
    q, k, v = qkv_global
    print(f"K4 flash_attention within 1 bf16 ulp of its plain version on the run's "
          f"layer 0 (local, window {cfg.window_size}) and layer 1 (global) q, k, v "
          f"{tuple(q.shape)}: max abs err {err_local:.3e} / {err_global:.3e}")
    B, S, KV, G, hd = q.shape
    H = KV * G
    ms = device_ms(lambda: attn_ops.flash_attention(q, k, v, **kw_global), n=10, reps=5)
    local_ms = device_ms(lambda: attn_ops.flash_attention(*qkv_local, **kw_local),
                         n=10, reps=5)
    plain_ms = device_ms(lambda: attn_ref.flash_attention_ref(q, k, v, **kw_global),
                         n=1, reps=3)
    torch.cuda.empty_cache()
    nocap = dict(causal=True, window=0, softcap=0.0)
    ms_nocap = device_ms(lambda: attn_ops.flash_attention(q, k, v, **nocap), n=10, reps=5)
    q4 = q.permute(0, 2, 3, 1, 4).reshape(B, H, S, hd).contiguous()
    k4, v4 = (t.permute(0, 2, 1, 3).contiguous() for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ours = attn_ops.flash_attention(q, k, v, **nocap)
    lib = sdpa(q4, k4, v4, is_causal=True, enable_gqa=True)
    lib = lib.reshape(B, KV, G, S, hd).permute(0, 3, 1, 2, 4)
    # the yardstick computes the same function (SDPA rounds P to bf16)
    sdpa_err = float((ours.float() - lib.float()).abs().max())
    check(sdpa_err <= 1e-2 * float(ours.float().abs().max()),
          f"K4 at softcap 0 vs scaled_dot_product_attention: {sdpa_err}")
    library_ms = device_ms(lambda: sdpa(q4, k4, v4, is_causal=True, enable_gqa=True),
                           n=10, reps=5)
    del ours, lib, q4, k4, v4
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()  # q, o; k, v
    pairs = B * H * live_pairs(S, 0)
    pairs_local = B * H * live_pairs(S, cfg.window_size)
    bound_ms = 1e3 * max(nbytes / bw, 4 * hd * pairs / bf16_flops)
    local_bound_ms = 1e3 * max(nbytes / bw, 4 * hd * pairs_local / bf16_flops)
    # the softcap's exp and reciprocal and the softmax's exp per live score
    sfu_ms, sfu_local_ms = (1e3 * 3 * n / SFU_PER_S for n in (pairs, pairs_local))
    tflops, local_tflops = (4 * hd * n / t / 1e9 for n, t in ((pairs, ms),
                                                             (pairs_local, local_ms)))
    print(f"K4 flash_attention {tuple(q.shape)} bf16, softcap {cap}: global layer "
          f"kernel {ms:.3f} ms, {tflops:.1f} TFLOP/s, {bound_ms / ms:.1%} of its bound "
          f"{bound_ms:.4f} ms ({4 * hd * pairs / 1e12:.3f} TFLOP at "
          f"{bf16_flops / 1e12:.0f} TFLOP/s bf16; 3 special-function ops per live "
          f"score {sfu_ms:.4f} ms); local layer {local_ms:.3f} ms, {local_tflops:.1f} "
          f"TFLOP/s, {local_bound_ms / local_ms:.1%} of its bound {local_bound_ms:.4f} "
          f"ms (special functions {sfu_local_ms:.4f} ms); plain (global) "
          f"{plain_ms:.3f} ms")
    print(f"K4 at softcap 0 (global): kernel {ms_nocap:.3f} ms, "
          f"scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
          f"{library_ms:.3f} ms ({ms_nocap / library_ms:.2f}x; max abs diff "
          f"{sdpa_err:.3e}); no single PyTorch call computes the softcapped attention")
    return dict(err=max(err, err_local, err_global), ms=ms, local_ms=local_ms,
                plain_ms=plain_ms, ms_softcap0=ms_nocap, library_ms=library_ms,
                bound_ms=bound_ms, local_bound_ms=local_bound_ms,
                transcendental_ms=sfu_ms, tflops=tflops, local_tflops=local_tflops)


def moe_layer_inputs(cfg, params, prompt):
    """The MoE run's own data for K3 and K4, recomputed from the prompt:
    the input of layer 0's first norm and layer 0's q, k, v."""
    B, S = prompt.shape
    positions = torch.arange(S, device=prompt.device).expand(B, S)
    x = embed_apply(cfg, params["embed"], prompt, positions)
    layer0 = tfm.group_params(params, 0)["b0"]
    qkv = _proj_qkv(cfg, layer0["attn"], apply_norm(cfg, x, layer0["ln1"]),
                    positions=positions)
    return (x, layer0["ln1"]), qkv


def k4_compare_rows(q, k, v, **kw) -> float:
    """K4 against its plain version one batch row at a time (a row's
    scores alone are H x S x S float32)."""
    got = attn_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), "K4 output finite")
    err = 0.0
    for b in range(q.shape[0]):
        want = attn_ref.flash_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw)
        check(got.dtype == want.dtype and got[b:b + 1].shape == want.shape,
              "K4 dtype/shape")
        check(within_bf16_ulp(got[b:b + 1], want), "K4 differs from its plain "
              "version by more than one bf16 ulp")
        err = max(err, float((got[b:b + 1].float() - want.float()).abs().max()))
        del want
        torch.cuda.empty_cache()
    return err


def attention_f64(q, k, v, causal=True):
    """The plain version's function (no window or softcap; causal or not,
    Sq and Skv free) in float64."""
    Sq, Skv, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.double(), k.double()) * hd**-0.5
    if causal:
        s.masked_fill_(~torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril(), -1e300)
    p = torch.softmax(s, dim=-1)
    del s
    return torch.einsum("bkgqs,bskh->bqkgh", p, v.double())


def k4_against_float64(q, k, v, causal=True) -> dict:
    """K4 and its plain version each against the same attention in float64,
    one batch row at a time: how many outputs each puts more than one bf16
    ulp (+ 1e-5) from the float64 value, and its largest error; and how
    many of K4's outputs lie more than one ulp from the plain version's.
    Where the softmax is nearly a hard max and outputs cancel, the two
    float32 evaluations differ from float64, and from each other, by far
    more than one bf16 ulp; K4 must then miss the float64 value no more
    often than its plain version does."""
    got = attn_ops.flash_attention(q, k, v, causal=causal, window=0, softcap=0.0)
    out = dict(n=got.numel(), kernel_beyond_plain=0, kernel_beyond_f64=0,
               plain_beyond_f64=0, kernel_max_err_f64=0.0, plain_max_err_f64=0.0)
    for b in range(q.shape[0]):
        sl = slice(b, b + 1)
        want = attn_ref.flash_attention_ref(q[sl], k[sl], v[sl], causal=causal)
        truth = attention_f64(q[sl], k[sl], v[sl], causal)
        g, w = got[sl].double(), want.double()
        ulp_t = torch.exp2(torch.floor(torch.log2(truth.abs().clamp_min(1e-30))) - 7)
        ulp_w = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
        out["kernel_beyond_plain"] += int(((g - w).abs() > ulp_w + 1e-5).sum())
        out["kernel_beyond_f64"] += int(((g - truth).abs() > ulp_t + 1e-5).sum())
        out["plain_beyond_f64"] += int(((w - truth).abs() > ulp_t + 1e-5).sum())
        out["kernel_max_err_f64"] = max(out["kernel_max_err_f64"],
                                        float((g - truth).abs().max()))
        out["plain_max_err_f64"] = max(out["plain_max_err_f64"],
                                       float((w - truth).abs().max()))
        del want, truth, g, w, ulp_t, ulp_w
        torch.cuda.empty_cache()
    return out


def k3_run_phase(dev, label, norm_in, variants, bw, seed, what="layer-0 input"):
    """K3 on a run's own norm input ``norm_in`` = (x, w), x (B, S, d): with
    its own weight and a random one, and at its last position (a decode
    step's shape), each within one bf16 ulp of its plain version; the
    variants taken at both shapes must be ``variants``; then both timed
    beside the bound, the plain version and F.rms_norm."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x, w0 = norm_in
    w = (torch.randn(w0.shape, generator=g, device=dev) * 0.1).to(w0.dtype)
    xd = x[:, -1:].contiguous()
    err = max(k3_compare(x, w0), k3_compare(x, w), k3_compare(xd, w))
    taken = (norm_ops.variant(x, w), norm_ops.variant(xd, w))
    check(taken == variants, f"{label}: K3 variants {taken}, expected {variants}")
    print(f"{label} K3 rms_norm within 1 bf16 ulp of its plain version on the run's {what} "
          f"{tuple(x.shape)} (its own and a random weight) and its last position; variants "
          f"{taken[0]} / {taken[1]}; max abs err {err:.3e}")
    return dict(err=err, shape=list(x.shape), variant=taken[0], decode_variant=taken[1],
                prefill=k3_time(x, w, bw), decode=k3_time(xd, w, bw, n=200))


def k4_run_phase(dev, label, cfg, qkv, bw, bf16_flops, seed, causal=True,
                 what="layer-0 q, k, v"):
    """K4 at a run's shape without softcap or window (self-attention,
    causal or not, or attention onto a memory: Sq != Skv, non-causal): on
    N(0, 1) inputs within one bf16 ulp of its plain version (one batch row
    at a time); on the run's own q, k, v, where the init leaves the softmax
    nearly a hard max, against attention in float64, missing it by more
    than one ulp no more often than its plain version (printed too: whether
    it also lies within one ulp of the plain version everywhere, the
    stronger check, which then holds); then its time beside its bound, the
    plain version and scaled_dot_product_attention (is_causal as the
    call, enable_gqa), which computes the same function here."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = qkv
    check(cfg.window_size == 0 and cfg.attn_logit_softcap == 0.0,
          f"{label} path: K4 window {cfg.window_size}, softcap {cfg.attn_logit_softcap}")
    kw = dict(causal=causal, window=0, softcap=0.0)
    B, Sq, KV, G, hd = q.shape
    Skv, H = k.shape[1], KV * G
    qs, ks, vs = (torch.randn(t.shape, generator=g, device=dev).to(t.dtype) for t in qkv)
    err = k4_compare_rows(qs, ks, vs, **kw)
    del qs, ks, vs
    print(f"{label} K4 flash_attention within 1 bf16 ulp of its plain version at the run's "
          f"shape {tuple(q.shape)} over {Skv} keys (causal {causal}) on N(0, 1) inputs (one "
          f"batch row at a time): max abs err {err:.3e}")
    f64 = k4_against_float64(q, k, v, causal)
    held = ("one bf16 ulp of the plain version, and float64" if f64["kernel_beyond_plain"] == 0
            else "float64")
    print(f"{label} K4 on the run's {what} (|q| up to {float(q.abs().max()):.1f}, |k| "
          f"{float(k.abs().max()):.1f}, |v| {float(v.abs().max()):.1f}; the init's fan-in "
          f"of wq is its G axis, {G} here) against attention in float64: outputs more than "
          f"1 bf16 ulp (+1e-5) off: kernel {f64['kernel_beyond_f64']}, plain "
          f"{f64['plain_beyond_f64']} of {f64['n']:,}; largest error kernel "
          f"{f64['kernel_max_err_f64']:.3e}, plain {f64['plain_max_err_f64']:.3e}; kernel "
          f"more than 1 ulp from plain: {f64['kernel_beyond_plain']}; held to: {held}")
    check(f64["kernel_beyond_f64"] <= f64["plain_beyond_f64"],
          f"{label} path: K4 misses the float64 attention more often than its plain version")
    ms = device_ms(lambda: attn_ops.flash_attention(q, k, v, **kw), n=10, reps=5)
    plain_ms = device_ms(lambda: attn_ref.flash_attention_ref(q, k, v, **kw), n=1, reps=3)
    torch.cuda.empty_cache()
    q4 = q.permute(0, 2, 3, 1, 4).reshape(B, H, Sq, hd).contiguous()
    k4, v4 = (t.permute(0, 2, 1, 3).contiguous() for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_kw = dict(is_causal=causal, enable_gqa=G > 1)
    ours = attn_ops.flash_attention(q, k, v, **kw)
    lib = sdpa(q4, k4, v4, **lib_kw).reshape(B, KV, G, Sq, hd).permute(0, 3, 1, 2, 4)
    sdpa_err = float((ours.float() - lib.float()).abs().max())
    check(sdpa_err <= 1e-2 * float(ours.float().abs().max()),
          f"{label} K4 vs scaled_dot_product_attention: {sdpa_err}")
    library_ms = device_ms(lambda: sdpa(q4, k4, v4, **lib_kw), n=10, reps=5)
    del ours, lib, q4, k4, v4
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()  # q, o; k, v
    pairs = B * H * (live_pairs(Sq, 0) if causal else Sq * Skv)
    flops = 4 * hd * pairs
    bytes_ms, ops_ms = 1e3 * nbytes / bw, 1e3 * flops / bf16_flops
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    sfu_ms = 1e3 * pairs / SFU_PER_S  # the softmax's exp
    tflops = flops / ms / 1e9
    print(f"{label} K4 flash_attention {tuple(q.shape)} over {Skv} keys bf16, causal "
          f"{causal}, no softcap or window: kernel {ms:.4f} ms, {tflops:.1f} TFLOP/s, "
          f"{bound_ms / ms:.1%} of its bound {bound_ms:.4f} ms by {bound_by} "
          f"({flops / 1e12:.4f} TFLOP at {bf16_flops / 1e12:.0f} TFLOP/s bf16, "
          f"{nbytes / 1e6:.1f} MB at {bw / 1e12} TB/s; one exp per live score {sfu_ms:.4f} "
          f"ms); plain {plain_ms:.3f} ms; scaled_dot_product_attention({lib_kw}) "
          f"{library_ms:.4f} ms (kernel/SDPA {ms / library_ms:.2f}x; max abs diff "
          f"{sdpa_err:.3e})")
    return dict(k4_err=err, k4_f64=f64, held=held, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                transcendental_ms=sfu_ms, tflops=tflops, shape=list(q.shape), kv_len=Skv,
                causal=causal)


def moe_kernels_phase(dev, cfg, norm_in, qkv, bw, bf16_flops):
    """K3 and K4 on the MoE run's layer-0 inputs: K3 at the prefill's and a
    decode step's shape, K4 at (2, 8000, 16, 1, 128) without softcap or
    window (`k3_run_phase`, `k4_run_phase`)."""
    k3 = k3_run_phase(dev, "MoE", norm_in, ("warp_per_row", "split_row"), bw, 15)
    k4 = k4_run_phase(dev, "MoE", cfg, qkv, bw, bf16_flops, 15)
    return dict(k3_err=k3["err"], k3=k3["prefill"], k3_decode=k3["decode"], **k4)


# ---------------------------------------------------------------------------
# the hand-off checks and the served paths after Moonlight: Zamba2-7B
# (Mamba2 blocks and a shared attention block), RWKV6-3B, Whisper large-v3
# (an encoder, cross-attention) and Llama-3.2-Vision (gated
# cross-attention)
# ---------------------------------------------------------------------------

# The prefill's hand-off to decode, held in relative L2 norm at the last
# position (PERF.md §6): each of group 0's blocks' contribution
# (its output minus its input) decoded from the prefill's caches against
# the same block over all S + 1 positions, on the run's own inputs, in
# bf16 and, for Zamba2, in float32; and the logits of the first decode
# step after the prefill against `forward`'s last logits over the same
# S + 1 tokens, for RWKV6 (in bf16). Zamba2's logits are printed, not
# held: its random init's shared attention (32 heads of 112 with G = 1,
# so `wq` is unscaled: |q| up to ~330) is nearly a hard max, and any
# difference between two evaluations grows group by group, so that the
# logits differ by ~0.75 in relative norm in float32 too, while every
# block hands off within a few 1e-6 there. Whisper's and Llama-3.2-Vision's
# logits are printed for the same reason (G = 1 and 8: |q| in the hundreds
# and tens), their blocks held: the self-attention blocks and the
# cross-attention blocks, whose decode reads the memory's K/V from their
# own prefill.
HANDOFF_BLOCK_BOUND = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
HANDOFF_LOGITS_BOUND = 5e-2


def rel_norm(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def pad_kv(cache: dict, length: int) -> dict:
    """A block's prefill cache with its self-attention K/V (B, S, KV, hd)
    zero-padded to ``length`` positions, so that decode can write
    position S; the cross-attention and recurrent leaves as they are."""
    out = dict(cache)
    for key in ("k", "v"):
        if key in cache:
            t = cache[key]
            out[key] = torch.zeros((t.shape[0], length) + t.shape[2:], dtype=t.dtype,
                                   device=t.device)
            out[key][:, :t.shape[1]] = t
    return out


@torch.no_grad()
def handoff_check(cfg, params, prompt, label, hold_logits: bool, memory=None) -> dict:
    """The prefill's caches handed to decode (recurrent states, the shared
    block's and the attention blocks' K/V, the cross-attention blocks' K/V
    of the memory), on the card at the run's own size: (1) the logits of
    the first decode step (position S) after the prefill against the last
    logits of `forward` over the same S + 1 tokens and the same memory;
    (2) group 0's blocks one by one on the run's own inputs: each block's
    prefill over S positions with ``want_cache``, then its decode of
    position S (reading the cross cache from that prefill), against the
    block over all S + 1 positions, in the block's contribution at
    position S."""
    model = build_model(cfg)
    B, S = prompt.shape
    batch = {"tokens": prompt} if memory is None else {"tokens": prompt, "memory": memory}
    logits, caches = make_prefill_step(model, S + 1)(params, batch)
    tok = torch.argmax(logits, dim=-1).to(prompt.dtype)
    _, caches, dec = make_serve_step(model)(params, caches, {"tokens": tok, "pos": S})
    del caches, logits
    tokens = torch.cat([prompt, tok], dim=1)
    full, _ = model.forward(params, tokens, memory)
    want = full[:, -1:].clone()
    del full
    out = {"logits": rel_norm(dec, want),
           "argmax_equal": bool(torch.equal(dec.argmax(-1), want.argmax(-1)))}
    del dec, want
    torch.cuda.empty_cache()

    pos = torch.arange(S + 1, device=prompt.device).expand(B, S + 1)
    x = embed_apply(cfg, params["embed"], tokens, pos)
    mem = tfm._memory(cfg, params, memory)  # encoded, for an encoder-decoder
    gp = tfm.group_params(params, 0)
    blocks = {}
    shared = params.get("shared_attn")

    def split(x):  # the prompt's positions and the decoded one, contiguous
        return x[:, :S].contiguous(), x[:, S:].contiguous()

    if shared is not None:
        y, _ = tfm._shared_attn_apply(cfg, shared, x, pos)
        head, last = split(x)
        _, (k, v) = tfm._shared_attn_apply(cfg, shared, head, pos[:, :S])
        kv = {n: torch.zeros((B, S + 1) + t.shape[2:], dtype=t.dtype, device=t.device)
              for n, t in (("k", k), ("v", v))}
        kv["k"][:, :S], kv["v"][:, :S] = k, v
        d = tfm._shared_attn_decode(cfg, shared, last, kv, S)
        blocks["shared"] = rel_norm(d[:, 0] - x[:, S], y[:, S] - x[:, S])
        del k, v, kv
        x = y
    for i, kind in enumerate(cfg.pattern):
        check(kind not in tfm.MOE_KINDS, f"{label}: hand-off of block kind {kind}")
        p = gp[f"b{i}"]
        y, _, _ = tfm.block_apply(cfg, kind, p, x, positions=pos, memory=mem)
        head, last = split(x)
        _, _, c = tfm.block_apply(cfg, kind, p, head, positions=pos[:, :S], memory=mem,
                                  want_cache=True)
        d, _ = tfm.block_decode(cfg, kind, p, last, pad_kv(c, S + 1), S)
        blocks[f"b{i}"] = rel_norm(d[:, 0] - x[:, S], y[:, S] - x[:, S])
        del c
        x = y
    del x, y, mem
    torch.cuda.empty_cache()
    out["blocks"] = blocks
    bound = HANDOFF_BLOCK_BOUND[cfg.cdtype]
    print(f"{label} hand-off, prefill of {S} then decode of position {S}, against the full "
          f"sequence of {S + 1} (relative L2 norm, {cfg.compute_dtype}): logits "
          f"{out['logits']:.4e} (argmax equal: {out['argmax_equal']}; held to "
          f"{HANDOFF_LOGITS_BOUND}: {hold_logits}); group 0's blocks' contributions "
          f"{json.dumps({k: float(f'{v:.4g}') for k, v in blocks.items()})} (held to {bound})")
    check(all(v <= bound for v in blocks.values()),
          f"{label}: a block's prefill-to-decode hand-off off by more than {bound}: {blocks}")
    if hold_logits:
        check(out["logits"] <= HANDOFF_LOGITS_BOUND,
              f"{label}: decode logits after the prefill off forward's by {out['logits']}")
    return out


def first_norm_input(module, fn):
    """The first (x, w) that ``fn()`` hands to ``module.rms_norm``: a
    block's inner norm input, recomputed from the run's data."""
    seen = []
    orig = module.rms_norm

    def record(x, w, eps=1e-6):
        if not seen:
            seen.append((x, w))
        return orig(x, w, eps)

    module.rms_norm = record
    try:
        fn()
    finally:
        module.rms_norm = orig
    return seen[0]


def hybrid_layer_inputs(cfg, params, prompt, memory=None):
    """The hybrid run's own data for K3 and K4, recomputed from the prompt:
    the shared block's q, k, v (the first thing group 0 runs), and group
    0's first Mamba2 inner norm input (B, S, d_inner)."""
    B, S = prompt.shape
    positions = torch.arange(S, device=prompt.device).expand(B, S)
    x = embed_apply(cfg, params["embed"], prompt, positions)
    shared = params["shared_attn"]
    qkv = _proj_qkv(cfg, shared["attn"], apply_norm(cfg, x, shared["ln1"]),
                    positions=positions)
    h, _ = tfm._shared_attn_apply(cfg, shared, x, positions)
    b0 = tfm.group_params(params, 0)["b0"]
    inner = first_norm_input(mamba2, lambda: tfm.block_apply(cfg, "mamba", b0, h,
                                                             positions=positions))
    return dict(norm_in=(inner[0], inner[1].clone()), qkv=qkv)


def recurrent_layer_inputs(cfg, params, prompt, memory=None):
    """The recurrent run's own data for K3: layer 0's ln_x input (B, S,
    d_model), from its time-mix over the LayerNorm of the embeddings."""
    B, S = prompt.shape
    positions = torch.arange(S, device=prompt.device).expand(B, S)
    x = embed_apply(cfg, params["embed"], prompt, positions)
    b0 = tfm.group_params(params, 0)["b0"]
    h = apply_norm(cfg, x, b0["ln1"])
    x, w = first_norm_input(rwkv6, lambda: rwkv6.rwkv6_time_mix(cfg, b0["rwkv"]["tm"], h))
    return dict(norm_in=(x, w.clone()))


def encdec_layer_inputs(cfg, params, prompt, memory):
    """The encoder-decoder run's own data for K4, recomputed from its
    prompt and frames: the encoder's layer-0 q, k, v (B, 1500, 20, 1, 64),
    and the decoder's layer-0 cross-attention q (B, 64, 20, 1, 64) with k,
    v (B, 1500, 20, 64) of the encoded frames (the input of that
    cross-attention: the embeddings plus the block's self-attention)."""
    B, S = prompt.shape
    frames = memory.to(cfg.cdtype)
    e0 = tfm.group_params(params["encoder"], 0)["b0"]
    fpos = torch.arange(frames.shape[1], device=prompt.device).expand(B, frames.shape[1])
    enc_qkv = _proj_qkv(cfg, e0["attn"], apply_norm(cfg, frames, e0["ln1"]), positions=fpos)
    mem = tfm.encode(cfg, params, memory)
    positions = torch.arange(S, device=prompt.device).expand(B, S)
    x = embed_apply(cfg, params["embed"], prompt, positions)
    b0 = tfm.group_params(params, 0)["b0"]
    out, _ = attn_mod.self_attention(cfg, b0["attn"], apply_norm(cfg, x, b0["ln1"]), window=0,
                                     positions=positions)
    h = apply_norm(cfg, x + out, b0["lnx"])
    cross_qkv = _proj_qkv(cfg, b0["xattn"], h, x_kv=mem, rope=False)
    return dict(enc_qkv=enc_qkv, cross_qkv=cross_qkv)


def vlm_layer_inputs(cfg, params, prompt, memory):
    """The vision-language run's own data for K3 and K4, recomputed from
    its prompt and patch embeddings: the input of layer 0's first norm
    (B, 8000, 8192) with its weight, and the q, k, v of group 0's
    cross-attention block (the fifth layer): q (B, 8000, 8, 8, 128) from
    the output of the four self-attention blocks before it, k and v (B,
    1601, 8, 128) from the memory."""
    B, S = prompt.shape
    positions = torch.arange(S, device=prompt.device).expand(B, S)
    x = embed_apply(cfg, params["embed"], prompt, positions)
    gp = tfm.group_params(params, 0)
    norm_in = (x, gp["b0"]["ln1"].clone())
    i = cfg.pattern.index("xattn")
    for j in range(i):
        x, _, _ = tfm.block_apply(cfg, cfg.pattern[j], gp[f"b{j}"], x, positions=positions)
    p = gp[f"b{i}"]
    cross_qkv = _proj_qkv(cfg, p["xattn"], apply_norm(cfg, x, p["ln1"]),
                          x_kv=memory.to(cfg.cdtype), rope=False)
    return dict(norm_in=norm_in, cross_qkv=cross_qkv)


def free_weights(label, cfg, held: int) -> None:
    """After the caller dropped a path's weights: the allocated memory must
    have fallen by their size at least."""
    torch.cuda.empty_cache()
    freed = torch.cuda.memory_allocated()
    nbytes = build_model(cfg).num_params() * cfg.pdtype.itemsize
    print(f"{label}: device memory allocated {held:,} bytes with {cfg.name}'s weights, "
          f"{freed:,} after freeing them ({nbytes:,} bytes of weights)")
    check(held - freed >= nbytes, f"{cfg.name}'s weights freed ({label})")


def float32_handoff(dev, path_inputs, label) -> dict:
    """`handoff_check` on the path's weights before their rounding to bf16
    (the same draws from the same seed, and the same prompt), in float32:
    K4 takes its float32 route and K3 reads float32 rows."""
    cfg, params, prompt, _ = path_inputs(dev, param_dtype="float32", compute_dtype="float32")
    out = handoff_check(cfg, params, prompt, f"{label} (float32 weights)", hold_logits=False)
    del params, prompt
    torch.cuda.empty_cache()
    return out


def served_path(dev, path_inputs, n_decode, label, hold_logits, layer_inputs):
    """One path end to end (`llm_path`), its hand-off check (with the
    path's memory, where it has one), and the run's own inputs for the
    kernel phases, ``layer_inputs(cfg, params, prompt, memory)``: a dict of
    tensors computed from the run's data (a norm's weight cloned, since it
    outlives the params); the weights are dropped, and checked freed,
    before it returns."""
    cfg, params, prompt, memory, r, cold, launches, peak = llm_path(
        dev, path_inputs, n_decode, label)
    handoff = handoff_check(cfg, params, prompt, label, hold_logits, memory)
    inputs = layer_inputs(cfg, params, prompt, memory)
    held = torch.cuda.memory_allocated()
    del params, prompt, memory
    free_weights(f"after the {label} path", cfg, held)
    return dict(cfg=cfg, run=r, cold=cold, launches=launches, peak=peak, handoff=handoff,
                **inputs)


def encdec_phase(dev, bw, bf16_flops) -> dict:
    """Whisper large-v3 end to end (`served_path`), the shares of the
    analytic bound, then K4 on its encoder's and its decoder's
    cross-attention's own q, k, v (non-causal; the cross one 64 queries
    over 1,500 frames)."""
    t0 = time.perf_counter()
    enc = served_path(dev, encdec_path_inputs, ENCDEC_DECODE, "EncDec", False,
                      encdec_layer_inputs)
    enc["shares"] = analytic_shares(enc["cfg"], enc["run"], ENCDEC_BATCH, ENCDEC_PROMPT,
                                    ENCDEC_DECODE, "EncDec")
    enc["k4_encoder"] = k4_run_phase(dev, "EncDec encoder", enc["cfg"], enc.pop("enc_qkv"),
                                     bw, bf16_flops, 18, causal=False,
                                     what="encoder layer-0 q, k, v")
    enc["k4_cross"] = k4_run_phase(dev, "EncDec cross", enc["cfg"], enc.pop("cross_qkv"), bw,
                                   bf16_flops, 19, causal=False,
                                   what="decoder layer-0 cross-attention q, k, v")
    torch.cuda.empty_cache()
    enc["seconds"] = time.perf_counter() - t0
    return enc


def vlm_phase(dev, bw, bf16_flops) -> dict:
    """Llama-3.2-Vision at full width and 20 layers end to end
    (`served_path`), the shares of the analytic bound, then K3 at 8,192
    wide on its layer-0 input and K4 on its cross-attention block's own q,
    k, v (8,000 queries over 1,601 patches)."""
    t0 = time.perf_counter()
    vlm = served_path(dev, vlm_path_inputs, VLM_DECODE, "VLM", False, vlm_layer_inputs)
    vlm["shares"] = analytic_shares(vlm["cfg"], vlm["run"], VLM_BATCH, VLM_PROMPT, VLM_DECODE,
                                    "VLM")
    vlm["k3"] = k3_run_phase(dev, "VLM", vlm.pop("norm_in"), ("split_row", "split_row"), bw,
                             20)
    vlm["k4_cross"] = k4_run_phase(dev, "VLM cross", vlm["cfg"], vlm.pop("cross_qkv"), bw,
                                   bf16_flops, 21, causal=False,
                                   what="cross-attention block's q, k, v (group 0, layer 4)")
    torch.cuda.empty_cache()
    vlm["seconds"] = time.perf_counter() - t0
    return vlm


# ---------------------------------------------------------------------------
# The training path: Gemma 2B trained at full size through K1, K3, K4 and
# the backward kernels K3-bwd and K4-bwd
# ---------------------------------------------------------------------------

# Gemma 2B's published config (the JAX trainer's default --arch): 18
# layers, d_model 2,048, 8 q heads of 256 over 1 KV head, GeGLU d_ff
# 16,384, vocab 256,000, bf16, remat; 2,506,172,416 random bf16 params
# drawn on the card from seed 0. 2 phases of K = 4 steps at 2 x 2,048
# tokens, gamma 0.05, lr 1e-3, clip 1.0. The token stream draws ids below
# 32,768 (`TokenStream` samples on the host in O(vocab) a position, ~8x
# cheaper than at 256,000), valid ids of the model; the cross-entropy
# still runs over all 256,000 logits.
TRAIN_ARCH, TRAIN_PARAMS = "gemma-2b", 2_506_172_416
TRAIN_BATCH, TRAIN_SEQ, TRAIN_K, TRAIN_PHASES = 2, 2048, 4, 2
TRAIN_GAMMA, TRAIN_LR, TRAIN_CLIP, TRAIN_STREAM_VOCAB = 0.05, 1e-3, 1.0, 32_768
# predicted before the first run: 15 bytes of optimizer state a coordinate
# (p, m, g bf16; v, u float32; the mask) = 37.6 GB, the edge's copy of
# the init 5.0 GB, the two phases' mask trees 5.0 GB, ~15 GB of logits
# (bf16, float32, the log-sum-exp's and the backward's temporaries at
# 4,096 x 256,000) and activations under remat
TRAIN_PEAK_PREDICTED = 62e9
# K4-bwd's bf16 route: the dQ pass and the dK/dV pass (then the G reduce)
BWD_WGMMA_KERNELS = ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel")
# K4-bwd on every option the forward takes, against its plain version:
# (B, Sq, Skv, KV, G, hd, causal, window, softcap, dtype)
K4_BWD_GRID = [
    (1, 300, 300, 2, 2, 256, True, 0, 50.0, torch.bfloat16),
    (1, 300, 300, 2, 2, 128, True, 64, 30.0, torch.bfloat16),
    (2, 200, 200, 4, 1, 64, False, 0, 0.0, torch.bfloat16),
    (1, 100, 333, 2, 2, 112, False, 0, 0.0, torch.bfloat16),
    (1, 333, 100, 1, 8, 128, True, 0, 0.0, torch.bfloat16),
    (1, 96, 96, 2, 2, 256, True, 20, 50.0, torch.float32),
    (1, 257, 257, 1, 8, 112, True, 0, 0.0, torch.float32),
    (2, 130, 70, 2, 2, 64, False, 0, 20.0, torch.float32),
]


def train_expected_launches(cfg) -> dict:
    """Kernel launches of one training step of a stack of dense attention
    blocks under remat. Each block runs K3 on its 2 norms (4 with
    post-norms) and K4 once in the forward, and again when backward
    recomputes its group (remat); K3-bwd and K4-bwd once per forward norm
    and attention; the final norm once forward (outside the groups) and
    once backward; K1 once per param dtype (one: every leaf is the
    config's param dtype). Every K4-bwd launch takes the bf16 wgmma route.
    For Gemma 2B (18 layers): K3 73, K3-bwd 37, K4 36, K4-bwd 18 (all
    bf16_wgmma), K1 1."""
    check(all(k in ("attn", "attn_local") for k in cfg.pattern),
          "train_expected_launches counts dense attention stacks")
    norms = (2 + 2 * cfg.post_norm) * cfg.num_layers
    rec = 2 if cfg.remat else 1
    return {"rms_norm": rec * norms + 1, "rms_norm_bwd": norms + 1,
            "flash_attention": rec * cfg.num_layers,
            "flash_attention_bwd": cfg.num_layers,
            "flash_attention_bwd_bf16_wgmma": cfg.num_layers, "masked_adam_3d": 1,
            "topk_threshold_bits": 0}


def train_counts() -> dict:
    return {"rms_norm": norm_ops.launches, "rms_norm_bwd": norm_ops.bwd_launches,
            "flash_attention": attn_ops.launches,
            "flash_attention_bwd": attn_ops.bwd_launches,
            "flash_attention_bwd_bf16_wgmma": attn_ops.bwd_launches_by_route["bf16_wgmma"],
            "masked_adam_3d": adam_ops.launches, "topk_threshold_bits": topk_ops.launches}


class StageClock:
    """`launch/train.train`'s ``clock``: CUDA events around each stage of
    each step, synchronised at its end, and the host's clock beside them
    (sampling and encoding work on the host)."""

    def __init__(self):
        self.step = 0
        self.records = []  # (stage, step, device ms, host ms)

    @contextlib.contextmanager
    def __call__(self, name):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        yield
        b.record()
        b.synchronize()
        self.records.append((name, self.step, a.elapsed_time(b),
                             1e3 * (time.perf_counter() - t0)))

    def by_step(self) -> list:
        out = [dict() for _ in range(self.step)]
        for name, step, ms, host in self.records:
            out[step][name] = ms if name not in ("sample", "encode") else host
        return out


def attention_bwd_f64(q, k, v, do, *, causal, window, softcap):
    """dq, dk, dv of the plain attention's function in float64 (autograd;
    masked scores -1e300)."""
    qd, kd, vd = (t.detach().double().requires_grad_() for t in (q, k, v))
    Sq, Skv, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqkgh,bskh->bkgqs", qd, kd) * hd**-0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    p = torch.softmax(s.masked_fill(~mask, -1e300), dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, vd)
    return torch.autograd.grad(o, (qd, kd, vd), do.double())


def rms_norm_bwd_f64(x, w, dy, eps=1e-6):
    xd, wd = x.detach().double().requires_grad_(), w.detach().double().requires_grad_()
    y = xd * torch.rsqrt(torch.mean(xd * xd, dim=-1, keepdim=True) + eps) * (1.0 + wd)
    return torch.autograd.grad(y, (xd, wd), dy.double())


def bwd_errors(names, kernel, plain, truth) -> dict:
    """Each output's largest error from float64, the kernel's and the plain
    version's (also over the largest |float64 value|), whether the kernel's
    is within 2x the plain one's, and the largest kernel - plain gap."""
    out = {}
    for n, a, b, t in zip(names, kernel, plain, truth):
        t = t.detach()
        scale = float(t.abs().max())
        ek = float((a.double() - t).abs().max())
        ep = float((b.double() - t).abs().max())
        out[n] = dict(kernel=ek, plain=ep, kernel_rel=ek / scale, plain_rel=ep / scale,
                      kernel_vs_plain=float((a.double() - b.double()).abs().max()),
                      held=ek <= 2 * ep)
    return out


def close_to_plain(got, want, what="backward kernel") -> float:
    """float32: within 1e-4 relative and 2e-5 of the largest |value|;
    bfloat16: one bf16 ulp plus 1e-4 of the largest |value| (the kernel and
    the plain version compute in float32 and sum in other orders). Returns
    the largest abs error."""
    scale = float(want.float().abs().max())
    if want.dtype == torch.float32:
        ok = bool(((got - want).abs() <= 1e-4 * want.abs() + 2e-5 * scale).all())
    else:
        ok = within_bf16_ulp(got, want, atol=1e-4 * scale)
    check(ok, f"{what} within tolerance of its plain version ({tuple(got.shape)} "
              f"{got.dtype})")
    return float((got.float() - want.float()).abs().max())


def k4_bwd_phase(dev, captured, bw, bf16_flops) -> dict:
    """K4's forward at the training path's shape, then K4-bwd. The forward
    as `k4_run_phase` holds it: on N(0, 1) q, k, v within one bf16 ulp of
    its plain version, on the run's own against attention in float64 (the
    run's saved output is the kernel's, bit for bit); its row log-sum-exp,
    the one the run saved and the N(0, 1) inputs', within `close_to_plain`'s
    float32 bound of the plain forward's. K4-bwd on the run's own layer-0
    q, k, v, output, log-sum-exp and dO, and on N(0, 1) inputs of the same
    shapes: dq, dk and dv within 2x the error from float64 of the bf16
    plain backward, which reads the plain forward's own output and
    log-sum-exp, so that a wrong log-sum-exp from the kernel shows as a gap
    (the run's init makes the softmax nearly a hard max, F12). On the
    option grid: the forward's output and log-sum-exp against the plain
    forward's, and the backward against the plain backward on the same
    output and log-sum-exp. Then timed beside its bound, the plain version
    and autograd through scaled_dot_product_attention."""
    q, k, v, o, lse, do, kw = captured
    causal, window, softcap = kw["causal"], kw["window"], kw["softcap"]
    check(window == 0 and softcap == 0.0,
          f"training path: K4 window {window}, softcap {softcap}")
    names = ("dq", "dk", "dv")
    checks, lse_err = {}, {}
    g = torch.Generator(device=dev).manual_seed(22)
    syn = [torch.randn(t.shape, generator=g, device=dev).to(t.dtype) for t in (q, k, v)]
    fwd_err = k4_compare_rows(*syn, **kw)
    check(torch.equal(o, attn_ops._forward(q, k, v, causal, window, softcap, False)[0]),
          "the training run's saved K4 output is the kernel's")
    f64 = k4_against_float64(q, k, v, causal)
    check(f64["kernel_beyond_f64"] <= f64["plain_beyond_f64"],
          f"training path: K4 misses the float64 attention more often than its plain "
          f"version ({f64})")
    o_syn, lse_syn = attn_ops._forward(*syn, causal, window, softcap, want_lse=True)
    do_syn = torch.randn(do.shape, generator=g, device=dev).to(do.dtype)
    for label, args in (("run", (q, k, v, o, lse, do)),
                        ("normal", (*syn, o_syn, lse_syn, do_syn))):
        po, pl = attn_ref.flash_attention_ref(*args[:3], **kw, return_lse=True)
        lse_err[label] = close_to_plain(args[4], pl, f"K4's row log-sum-exp ({label})")
        got = attn_ops.flash_attention_bwd(*args, **kw)
        plain = attn_ref.flash_attention_bwd_ref(*args[:3], po, pl, args[5], **kw)
        truth = attention_bwd_f64(args[0], args[1], args[2], args[5], **kw)
        checks[label] = bwd_errors(names, got, plain, truth)
        del got, plain, truth, po, pl
        torch.cuda.empty_cache()
        check(all(r["held"] for r in checks[label].values()),
              f"K4-bwd within 2x the plain backward's error from float64 ({label}): "
              f"{checks[label]}")
    grid_err, grid_fwd_err, grid_lse_err = 0.0, 0.0, 0.0
    for B_, Sq, Skv, KV, G, hd, c_, w_, sc_, dtype in K4_BWD_GRID:
        qkv = torch.randn(B_, max(Sq, Skv), KV, G + 2, hd, generator=g, device=dev).to(dtype)
        a = (qkv[:, :Sq, :, :G], qkv[:, :Skv, :, G], qkv[:, :Skv, :, G + 1])
        okw = dict(causal=c_, window=w_, softcap=sc_)
        grid_fwd_err = max(grid_fwd_err, k4_compare(*a, **okw))
        oo, ll = attn_ops._forward(*a, c_, w_, sc_, want_lse=True)
        check(torch.equal(oo, attn_ops._forward(*a, c_, w_, sc_, False)[0]),
              "the log-sum-exp store leaves K4's output alone")
        _, pl = attn_ref.flash_attention_ref(*a, **okw, return_lse=True)
        grid_lse_err = max(grid_lse_err, close_to_plain(ll, pl, "K4's row log-sum-exp"))
        dd = torch.randn(oo.shape, generator=g, device=dev).to(dtype)
        got = attn_ops.flash_attention_bwd(*a, oo, ll, dd, **okw)
        plain = attn_ref.flash_attention_bwd_ref(*a, oo, ll, dd, **okw)
        grid_err = max([grid_err] + [close_to_plain(x, y) for x, y in zip(got, plain)])
    lse_err["grid"] = grid_lse_err
    print(f"K4 forward at the training shape {tuple(q.shape)} (causal {causal}): within 1 "
          f"bf16 ulp of its plain version on N(0, 1) inputs (max abs err {fwd_err:.3e}); on "
          f"the run's layer-0 q, k, v against attention in float64: outputs more than 1 bf16 "
          f"ulp (+1e-5) off: kernel {f64['kernel_beyond_f64']}, plain "
          f"{f64['plain_beyond_f64']} of {f64['n']:,}; row log-sum-exp within the float32 "
          f"bound of the plain forward's (max abs err: the run's saved one "
          f"{lse_err['run']:.3e}, N(0, 1) {lse_err['normal']:.3e}, the {len(K4_BWD_GRID)} "
          f"option cases {grid_lse_err:.3e}; their outputs {grid_fwd_err:.3e})")
    print(f"K4-bwd within 2x the bf16 plain backward's error from float64 on the run's "
          f"layer-0 tensors {tuple(q.shape)} ({json.dumps(checks['run'])}) and on N(0, 1) "
          f"inputs ({json.dumps(checks['normal'])}); within tolerance of the plain backward "
          f"on {len(K4_BWD_GRID)} option cases (max abs err {grid_err:.3e})")
    B_, S_, KV, G, hd = q.shape
    H = KV * G
    fn = lambda: attn_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)  # noqa: E731
    ms = device_ms(fn, n=5, reps=3)
    plain_ms = device_ms(lambda: attn_ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw),
                         n=2, reps=3)
    qs = q.detach().permute(0, 2, 3, 1, 4).reshape(B_, H, S_, hd).contiguous().requires_grad_()
    ks = k.detach().permute(0, 2, 1, 3).contiguous().requires_grad_()
    vs = v.detach().permute(0, 2, 1, 3).contiguous().requires_grad_()
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                           enable_gqa=True)
    gs = do.permute(0, 2, 3, 1, 4).reshape(B_, H, S_, hd).contiguous()
    library_ms = device_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), gs,
                                                       retain_graph=True), n=5, reps=3)
    flops = 5 * 2 * B_ * H * hd * live_pairs(S_, kw["window"])
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, o, do, lse, q, k, v))
    bound_ms = 1e3 * max(flops / bf16_flops, nbytes / bw)
    bound_by = "operations" if flops / bf16_flops >= nbytes / bw else "bytes"
    route = attn_ops.BWD_ROUTES[q.dtype][0]
    print(f"K4-bwd flash_attention_bwd {tuple(q.shape)} bf16 causal, route {route}: kernel "
          f"{ms:.3f} ms on the "
          f"device ({flops / ms / 1e9:.1f} TFLOP/s of the 5 products), plain {plain_ms:.3f} ms, "
          f"autograd through SDPA {library_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({flops:.4e} FLOPs, {nbytes / 1e6:.1f} MB; {bound_ms / ms:.1%} of it)")
    # against the plain version, as for the other kernels: on N(0, 1) inputs
    # and the grid (on the run's tensors, whose gradients reach ~1e11, one
    # bf16 ulp is ~1e9; their errors are in `checks`, relative too)
    err = max(grid_err, *(r["kernel_vs_plain"] for r in checks["normal"].values()))
    fwd = dict(err=max(fwd_err, grid_fwd_err), normal_err=fwd_err, grid_err=grid_fwd_err,
               against_float64=f64, lse_err=lse_err)
    return dict(err=err, fwd=fwd, checks=checks, grid_err=grid_err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, route=route,
                tflops=flops / ms / 1e9, shape=list(q.shape))


def k3_bwd_phase(dev, captured, bw) -> dict:
    """K3-bwd on the training run's own layer-0 norm input, weight and dy,
    and on N(0, 1) inputs of the same shape: dx and dw within 2x the bf16
    plain backward's error from float64; timed beside its bound, the plain
    version and autograd through F.rms_norm."""
    x, w, dy = captured
    x2, dy2 = x.reshape(-1, x.shape[-1]), dy.reshape(-1, dy.shape[-1])
    g = torch.Generator(device=dev).manual_seed(23)
    xs = torch.randn(x2.shape, generator=g, device=dev).to(x.dtype)
    ws = (0.1 * torch.randn(w.shape, generator=g, device=dev)).to(w.dtype)
    dys = torch.randn(dy2.shape, generator=g, device=dev).to(dy.dtype)
    checks = {}
    for label, args in (("run", (x2, w, dy2)), ("normal", (xs, ws, dys))):
        got = norm_ops.rms_norm_bwd(*args)
        plain = norm_ref.rms_norm_bwd_ref(*args)
        checks[label] = bwd_errors(("dx", "dw"), got, plain, rms_norm_bwd_f64(*args))
        check(all(r["held"] for r in checks[label].values()),
              f"K3-bwd within 2x the plain backward's error from float64 ({label}): "
              f"{checks[label]}")
    print(f"K3-bwd within 2x the bf16 plain backward's error from float64 on the run's "
          f"layer-0 norm input {tuple(x2.shape)} ({json.dumps(checks['run'])}) and on N(0, 1) "
          f"inputs ({json.dumps(checks['normal'])})")
    variant = norm_ops.bwd_variant(x2, w, dy2)
    check(variant == "warp_per_row", f"K3-bwd at the training shape takes warp_per_row, "
                                     f"not {variant}")
    ms = device_ms(lambda: norm_ops.rms_norm_bwd(x2, w, dy2), n=20)
    plain_ms = device_ms(lambda: norm_ref.rms_norm_bwd_ref(x2, w, dy2), n=5)
    xl = x2.detach().clone().requires_grad_()
    wl = (1.0 + w.float()).to(w.dtype).requires_grad_()
    y = torch.nn.functional.rms_norm(xl, (x2.shape[-1],), weight=wl, eps=1e-6)
    library_ms = device_ms(lambda: torch.autograd.grad(y, (xl, wl), dy2, retain_graph=True),
                           n=20)
    nbytes = 3 * x2.numel() * x2.element_size() + 2 * w.numel() * w.element_size()
    bound_ms = 1e3 * nbytes / bw
    print(f"K3-bwd rms_norm_bwd {tuple(x2.shape)} bf16, variant {variant}: kernel {ms:.4f} ms "
          f"on the device, "
          f"plain {plain_ms:.4f} ms, autograd through F.rms_norm {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB; {bound_ms / ms:.1%} of it)")
    err = max(r["kernel_vs_plain"] for r in checks["normal"].values())
    return dict(err=err, checks=checks, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by="bytes", shape=list(x2.shape), variant=variant)


def train_path(dev, bw, bf16_flops) -> dict:
    """Gemma 2B at full size trained by `launch/train.train`: 2 phases of
    K = 4 steps at 2 x 2,048 tokens, the first on a random mask drawn on
    the card, the second gradient-guided (bisection: 2.5B coordinates are
    above `selection._SMALL`), the delta encoded at each phase's end and
    applied to the edge's copy of the init. Each step's kernel launches
    are read and must be `train_expected_launches`; every loss finite;
    at step 1 every leaf's gradient finite and not all zero (F11's
    symptom); the edge's params after both deltas equal the trained ones
    rounded through fp16 on the coordinates either mask selected, and the
    init elsewhere. Prints each step's loss and stage times (CUDA events;
    sampling and encoding on the host clock), the peak memory beside its
    prediction, the step's MFU against `roofline.analytic` and the
    downlink per phase. K3-bwd and K4-bwd are then held and timed on the
    run's layer-0 tensors, captured by wrapping the wrappers during step
    1 (the last call of each is layer 0's)."""
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    check(build_model(cfg).num_params() == TRAIN_PARAMS and cfg.remat,
          f"{cfg.name}: {TRAIN_PARAMS:,} parameters under remat")
    want = train_expected_launches(cfg)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    captured, counts, grads_ok = {}, [], {}
    real_attn_bwd, real_norm_bwd = attn_ops.flash_attention_bwd, norm_ops.rms_norm_bwd

    # copies: w is a view into the optimizer's flat params, which K1 then
    # rewrites in place
    def cap_attn(q, k, v, o, lse, do, **kw):
        captured["attn"] = (*(t.detach().clone() for t in (q, k, v, o, lse, do)), kw)
        return real_attn_bwd(q, k, v, o, lse, do, **kw)

    def cap_norm(x, w, dy, eps=1e-6):
        captured["norm"] = tuple(t.detach().clone() for t in (x, w, dy))
        return real_norm_bwd(x, w, dy, eps)

    clock = StageClock()
    last = {}

    def log(it, loss, down, state):
        nonlocal last
        now = train_counts()
        counts.append({k: now[k] - last[k] for k in now})
        last = now
        clock.step += 1
        if it == 0:
            attn_ops.flash_attention_bwd, norm_ops.rms_norm_bwd = real_attn_bwd, real_norm_bwd
            leaves = tree.leaves(state.grads)
            grads_ok["finite"] = all(bool(torch.isfinite(g).all()) for g in leaves)
            grads_ok["nonzero"] = all(bool((g != 0).any()) for g in leaves)
            grads_ok["leaves"] = len(leaves)
        print(f"train step {it}: loss {loss:.4f}, downlink so far {down:,} bytes; "
              f"launches {counts[-1]}")

    stream = TokenStream(StreamConfig(vocab_size=TRAIN_STREAM_VOCAB, seed=1))
    attn_ops.flash_attention_bwd, norm_ops.rms_norm_bwd = cap_attn, cap_norm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    last = train_counts()
    t1 = time.perf_counter()
    try:
        r = train(cfg, params, stream, steps=TRAIN_K * TRAIN_PHASES, phase_len=TRAIN_K,
                  batch=TRAIN_BATCH, seq=TRAIN_SEQ, gamma=TRAIN_GAMMA, lr=TRAIN_LR,
                  clip=TRAIN_CLIP, mask_gen=torch.Generator(device=dev).manual_seed(1),
                  log=log, clock=clock)
    finally:
        attn_ops.flash_attention_bwd, norm_ops.rms_norm_bwd = real_attn_bwd, real_norm_bwd
    train_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in r.losses), f"every loss finite: {r.losses}")
    check(grads_ok.get("finite") and grads_ok.get("nonzero"),
          f"step 1: every leaf's gradient finite and not all zero ({grads_ok})")
    check(all(c == want for c in counts), f"launches per step {counts}, want {want}")

    # the edge: the init with both deltas applied
    t2 = time.perf_counter()
    edge = params
    del params
    for d in r.deltas:
        edge = apply_delta(edge, d)
    same = all(torch.equal(e, torch.where(m1 | m2, t.detach().to(torch.float16).to(t.dtype),
                                          t.detach()))
               for e, t, m1, m2 in zip(tree.leaves(edge), tree.leaves(r.state.params),
                                       tree.leaves(r.masks[0]), tree.leaves(r.masks[1])))
    check(same, "edge params after the deltas: the trained ones through fp16 where a mask "
                "selected, the init elsewhere")
    edge_s = time.perf_counter() - t2
    del edge
    downlink = [dict(selected=sum(int(m.sum()) for m in tree.leaves(mk)),
                     values_bytes=d.value_bytes, mask_gz_bytes=d.mask_bytes,
                     mask_raw_bytes=-(-d.n_total // 8), total_bytes=d.total_bytes)
                for mk, d in zip(r.masks, r.deltas)]
    losses = r.losses
    del r
    torch.cuda.empty_cache()

    steps = clock.by_step()
    step_ms = [s["forward_backward"] + s.get("clip", 0.0) + s["adam"] for s in steps]
    cost = analytic_cost(cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH))
    warm = statistics.median(step_ms[1:])
    mfu = cost["model_flops"] / (warm / 1e3 * PEAK_FLOPS_BF16)
    for i, s in enumerate(steps):
        print(f"train step {i} stages (ms; CUDA events; sample and encode on the host "
              f"clock): " + ", ".join(f"{k} {v:.2f}" for k, v in s.items()))
    print(f"train: {cfg.name} ({TRAIN_PARAMS:,} params, {cfg.num_layers} layers, remat) "
          f"{TRAIN_PHASES} phases of K={TRAIN_K} at {TRAIN_BATCH} x {TRAIN_SEQ} tokens; "
          f"losses {[round(x, 4) for x in losses]}; step (forward+backward, clip, K1) "
          f"{[round(x, 1) for x in step_ms]} ms, median after the first {warm:.1f} ms; MFU "
          f"{mfu:.3f} ({cost['model_flops']:.4e} model FLOPs a step at "
          f"{PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s); peak memory {peak:,} bytes (predicted "
          f"{TRAIN_PEAK_PREDICTED:,.0f}); init {t_init:.1f} s, train() {train_s:.1f} s, "
          f"edge apply and check {edge_s:.1f} s")
    print(f"train downlink per phase: {json.dumps(downlink)}")
    print(f"train launches per step {counts[0]} (all {len(counts)} steps equal, as "
          f"derived from the config); step-1 gradients finite and non-zero on all "
          f"{grads_ok['leaves']} leaves")
    return dict(cfg=cfg, steps=steps, step_ms=step_ms, warm_step_ms=warm, mfu=mfu,
                model_flops=cost["model_flops"], peak=peak, counts=counts, want=want,
                losses=losses, downlink=downlink, t_init=t_init, train_s=train_s,
                edge_s=edge_s, captured=captured, seconds=time.perf_counter() - t0)


T_START = time.perf_counter()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this needs one NVIDIA GPU")
    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    bw, flops, bf16_flops = peaks(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {name}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}; data-sheet peaks {bw / 1e12} TB/s, "
          f"{flops / 1e12} TFLOP/s float32")
    t_build = build.build_all()
    print(f"build: {t_build:.2f} s for {list(build.SOURCES)} into {build.BUILD_DIR}")
    sass = sass_counts()
    print(f"K4 bf16 kernel SASS (flash_fwd_wgmma_kernel, {sass['functions']} "
          f"instantiations): HGMMA {sass['HGMMA']}, UTMALDG {sass['UTMALDG']}, "
          f"UTMASTG {sass['UTMASTG']}")
    check(sass["functions"] == 3 and sass["HGMMA"] > 0 and sass["UTMALDG"] > 0,
          f"the bf16 K4 kernel runs on wgmma and TMA: {sass}")
    bwd_sass = {k: sass_counts(k, "flash_attention_bwd") for k in BWD_WGMMA_KERNELS}
    print(f"K4-bwd bf16 kernels' SASS (3 instantiations each): {json.dumps(bwd_sass)}")
    check(all(c["functions"] == 3 and c["HGMMA"] > 0 and c["UTMALDG"] > 0
              for c in bwd_sass.values()),
          f"the bf16 K4-bwd kernels run on wgmma and TMA: {bwd_sass}")

    # 2-3. kernels against their plain versions
    k1 = k1_phase(dev, bw, flops)
    k2 = k2_phase(dev, bw, flops)

    # 4. the main path: one traced eager iteration, then 3 fused phases
    # under the auto exec shape, then the shapes against each other
    trace = ams_iteration_trace(dev)
    sessions, launches, main_exec = main_path(dev)
    err1, err2 = recheck_on_run(dev, sessions)
    shapes = exec_shape_check(dev, sessions)
    breakdown = phase_breakdown(dev, sessions)
    del sessions
    batched.cache_clear()
    torch.cuda.empty_cache()

    # 5. the streaming schemes
    pre, _, ams_session, runner_launches, schemes_s = schemes_path(dev)
    err1_b1, err2_b1, k2_b1 = recheck_b1(dev, ams_session, bw, flops)
    seq = sequential_phase_breakdown(dev, ams_session)
    del ams_session
    torch.cuda.empty_cache()

    # 6. the serving engine on the schemes phase's pretrained student
    serving, serving_launches, serving_groups = serving_path(dev, pre)
    del pre
    torch.cuda.empty_cache()

    # 7. the LLM serving path, then K3 and K4 on its own data; the fused
    # phase's graphs and their memory pools go first
    batched.cache_clear()
    torch.cuda.empty_cache()
    cfg, params, prompt, _, llm, llm_cold, llm_launches, peak = llm_path(
        dev, main_path_inputs, MAIN_DECODE)
    held = torch.cuda.memory_allocated()
    norm_in, qkv_local, qkv_global = llm_layer_inputs(cfg, params, prompt)
    del params
    torch.cuda.empty_cache()
    k3 = k3_phase(dev, cfg, norm_in, bw)
    k4 = k4_phase(dev, cfg, qkv_local, qkv_global, bw, bf16_flops)
    llm_shares = analytic_shares(cfg, llm, MAIN_BATCH, MAIN_PROMPT, MAIN_DECODE, "LLM")

    # 8. the MoE serving path, once Gemma-2's weights and layer inputs are
    # gone (both models' weights and caches would not fit the card at once)
    t_moe = time.perf_counter()
    del norm_in, qkv_local, qkv_global, prompt
    torch.cuda.empty_cache()
    freed = torch.cuda.memory_allocated()
    gemma_bytes = build_model(cfg).num_params() * cfg.pdtype.itemsize
    print(f"MoE path: device memory allocated {held:,} bytes with {cfg.name}'s weights, "
          f"{freed:,} after freeing them ({gemma_bytes:,} bytes of weights)")
    check(held - freed >= gemma_bytes, f"{cfg.name}'s weights freed before the MoE path")
    mcfg, mparams, mprompt, _, moe, moe_cold, moe_launches, moe_peak = llm_path(
        dev, moe_path_inputs, MOE_DECODE, "MoE")
    moe_norm_in, moe_qkv = moe_layer_inputs(mcfg, mparams, mprompt)
    del mparams, mprompt
    torch.cuda.empty_cache()
    moe_shares = analytic_shares(mcfg, moe, MOE_BATCH, MOE_PROMPT, MOE_DECODE, "MoE")
    mk = moe_kernels_phase(dev, mcfg, moe_norm_in, moe_qkv, bw, bf16_flops)
    del moe_norm_in, moe_qkv
    torch.cuda.empty_cache()
    moe_s = time.perf_counter() - t_moe

    # 9. the hybrid path (Zamba2-7B), once Moonlight's weights are gone;
    # then K3 on its Mamba2 inner norm input and K4 at head dim 112
    t_hyb = time.perf_counter()
    hyb = served_path(dev, hybrid_path_inputs, HYBRID_DECODE, "Hybrid", False,
                      hybrid_layer_inputs)
    hyb_shares = analytic_shares(hyb["cfg"], hyb["run"], HYBRID_BATCH, HYBRID_PROMPT,
                                 HYBRID_DECODE, "Hybrid")
    hk3 = k3_run_phase(dev, "Hybrid", hyb.pop("norm_in"), ("split_row", "split_row"), bw, 16,
                       what="Mamba2 inner norm input")
    hk4 = k4_run_phase(dev, "Hybrid", hyb["cfg"], hyb.pop("qkv"), bw, bf16_flops, 16)
    torch.cuda.empty_cache()
    hyb["handoff_float32"] = float32_handoff(dev, hybrid_path_inputs, "Hybrid")
    hyb_s = time.perf_counter() - t_hyb

    # 10. the recurrent path (RWKV6-3B); then K3 on its ln_x input
    t_rec = time.perf_counter()
    rec = served_path(dev, recurrent_path_inputs, RECURRENT_DECODE, "Recurrent", True,
                      recurrent_layer_inputs)
    rec_shares = analytic_shares(rec["cfg"], rec["run"], RECURRENT_BATCH, RECURRENT_PROMPT,
                                 RECURRENT_DECODE, "Recurrent")
    rk3 = k3_run_phase(dev, "Recurrent", rec.pop("norm_in"), ("warp_per_row", "split_row"), bw,
                       17, what="RWKV6 ln_x input")
    torch.cuda.empty_cache()
    rec_s = time.perf_counter() - t_rec

    # 11. the encoder-decoder path (Whisper large-v3); 12. the
    # vision-language path (Llama-3.2-Vision at full width, 20 layers)
    enc = encdec_phase(dev, bw, bf16_flops)
    ek4, xk4, enc_shares, enc_s = (enc[k] for k in ("k4_encoder", "k4_cross", "shares",
                                                    "seconds"))
    vlm = vlm_phase(dev, bw, bf16_flops)
    vk3, vk4, vlm_shares, vlm_s = (vlm[k] for k in ("k3", "k4_cross", "shares", "seconds"))

    # 13. the training path (Gemma 2B at full size), then K4-bwd and K3-bwd
    # on its own layer-0 tensors
    tr = train_path(dev, bw, bf16_flops)
    cap = tr.pop("captured")
    k4b = k4_bwd_phase(dev, cap["attn"], bw, bf16_flops)
    k3b = k3_bwd_phase(dev, cap["norm"], bw)
    del cap
    torch.cuda.empty_cache()
    train_launches = {k: sum(c[k] for c in tr["counts"]) for k in tr["want"]}

    # 14. kernels line
    kernels = [
        dict(name="masked_adam_3d", route="cuda",
             source="src/repro_torch/csrc/masked_adam.cu",
             replaces="src/repro/kernels/masked_adam/masked_adam.py:64",
             launches=launches["masked_adam_3d"],
             main_path_exec_runs=main_exec["runs"], main_path_race=main_exec["race"],
             flat_step_ms=breakdown["adam_ms"], flat_step_device_ms=breakdown["adam_device_ms"],
             tree_step_ms=breakdown["tree_step_ms"],
             tree_step_device_ms=breakdown["tree_step_device_ms"],
             runner_launches=sum(v["K1"] for v in runner_launches.values()),
             runner_launches_by_run={k: v["K1"] for k, v in runner_launches.items()},
             serving_launches=serving_launches["K1"],
             max_abs_err=max(k1["err"], err1, err1_b1),
             ms=k1["ms"], kernel_ms=k1["ms"], call_ms=k1["call_ms"],
             plain_ms=k1["plain_ms"],
             bound_ms=k1["bound_ms"], bound_by="bytes", library_ms=None,
             b1_ms=k1["b1_ms"], b1_plain_ms=k1["b1_plain_ms"],
             b1_bound_ms=k1["b1_bound_ms"],
             train_launches=train_launches["masked_adam_3d"],
             train_adam_ms=statistics.median(s["adam"] for s in tr["steps"])),
        dict(name="topk_threshold_bits", route="cuda",
             source="src/repro_torch/csrc/topk_mask.cu",
             replaces="src/repro/kernels/topk_mask/topk_mask.py:50",
             launches=launches["topk_threshold_bits"],
             runner_launches=sum(v["K2"] for v in runner_launches.values()),
             runner_launches_by_run={k: v["K2"] for k, v in runner_launches.items()},
             serving_launches=serving_launches["K2"],
             max_abs_err=max(k2["err"], err2, err2_b1), ms=k2["ms"], kernel_ms=k2["ms"],
             call_ms=k2["call_ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"], bound_by="bytes",
             library_ms=k2["library_ms"], blocks=k2["blocks"],
             digit_bits=list(topk_ops.DIGIT_BITS),
             b1_ms=k2_b1["ms"], b1_plain_ms=k2_b1["plain_ms"],
             b1_library_ms=k2_b1["library_ms"], b1_bound_ms=k2_b1["bound_ms"]),
        dict(name="rms_norm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm/rmsnorm.py:25",
             launches=llm_launches["rms_norm"], moe_launches=moe_launches["rms_norm"],
             train_launches=train_launches["rms_norm"],
             max_abs_err=max(k3["err"], mk["k3_err"], hk3["err"], rk3["err"], vk3["err"]),
             ms=k3["ms"],
             call_ms=k3["call_ms"], plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by="bytes", library_ms=k3["library_ms"],
             library_call="torch.nn.functional.rms_norm(x, (d,), weight=1+w, eps=1e-6)",
             copy_ms=k3["copy_ms"],
             decode_ms=k3["decode_ms"], decode_call_ms=k3["decode_call_ms"],
             decode_plain_ms=k3["decode_plain_ms"], decode_bound_ms=k3["decode_bound_ms"],
             decode_library_ms=k3["decode_library_ms"],
             **{f"moe_{k}": v for k, v in mk["k3"].items()},
             **{f"moe_decode_{k}": v for k, v in mk["k3_decode"].items()},
             hybrid_launches=hyb["launches"]["rms_norm"],
             recurrent_launches=rec["launches"]["rms_norm"],
             encdec_launches=enc["launches"]["rms_norm"],
             vlm_launches=vlm["launches"]["rms_norm"],
             **{f"{name}_{k}": v for name, r in (("d7168", hk3), ("d2560", rk3),
                                                 ("d8192", vk3))
                for k, v in (dict(shape=r["shape"], variant=r["variant"],
                                  decode_variant=r["decode_variant"], err=r["err"],
                                  **r["prefill"],
                                  **{f"decode_{kk}": vv for kk, vv in r["decode"].items()})
                             ).items()}),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py:89",
             launches=llm_launches["flash_attention"],
             launches_by_route=llm_launches["flash_attention_by_route"],
             moe_launches=moe_launches["flash_attention"],
             moe_launches_by_route=moe_launches["flash_attention_by_route"],
             train_launches=train_launches["flash_attention"],
             hybrid_launches=hyb["launches"]["flash_attention"],
             hybrid_launches_by_route=hyb["launches"]["flash_attention_by_route"],
             encdec_launches=enc["launches"]["flash_attention"],
             encdec_launches_by_route=enc["launches"]["flash_attention_by_route"],
             vlm_launches=vlm["launches"]["flash_attention"],
             vlm_launches_by_route=vlm["launches"]["flash_attention_by_route"],
             max_abs_err=max(k4["err"], mk["k4_err"], hk4["k4_err"], ek4["k4_err"],
                             xk4["k4_err"], vk4["k4_err"], k4b["fwd"]["err"]),
             train_shape=k4b["shape"], train_max_abs_err=k4b["fwd"]["normal_err"],
             train_against_float64=k4b["fwd"]["against_float64"],
             lse_max_abs_err=k4b["fwd"]["lse_err"],
             option_grid_max_abs_err=k4b["fwd"]["grid_err"],
             ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by="operations", library_ms=k4["library_ms"],
             library_call="scaled_dot_product_attention(is_causal=True, "
                          "enable_gqa=True) at softcap 0, beside ms_softcap0",
             ms_softcap0=k4["ms_softcap0"], local_ms=k4["local_ms"],
             local_bound_ms=k4["local_bound_ms"],
             transcendental_ms=k4["transcendental_ms"], tflops=k4["tflops"],
             local_tflops=k4["local_tflops"], bound_share=k4["bound_ms"] / k4["ms"],
             local_bound_share=k4["local_bound_ms"] / k4["local_ms"],
             hd128_shape=mk["shape"], hd128_ms=mk["ms"], hd128_plain_ms=mk["plain_ms"],
             hd128_bound_ms=mk["bound_ms"], hd128_library_ms=mk["library_ms"],
             hd128_transcendental_ms=mk["transcendental_ms"], hd128_tflops=mk["tflops"],
             hd128_against_float64=mk["k4_f64"],
             hd112_shape=hk4["shape"], hd112_ms=hk4["ms"], hd112_plain_ms=hk4["plain_ms"],
             hd112_bound_ms=hk4["bound_ms"], hd112_library_ms=hk4["library_ms"],
             hd112_transcendental_ms=hk4["transcendental_ms"], hd112_tflops=hk4["tflops"],
             hd112_against_float64=hk4["k4_f64"],
             **{f"{name}_{k}": r[k] for name, r in (("whisper_encoder", ek4),
                                                    ("whisper_cross", xk4), ("vlm_cross", vk4))
                for k in ("shape", "kv_len", "causal", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "transcendental_ms", "tflops", "held")},
             **{f"{name}_against_float64": r["k4_f64"]
                for name, r in (("whisper_encoder", ek4), ("whisper_cross", xk4),
                                ("vlm_cross", vk4))},
             memory_library_call="scaled_dot_product_attention(is_causal=False, "
                                 "enable_gqa=G > 1) at the same shape",
             sass=sass),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py:89",
             replaces_what="the gradient of flash_attention_4d, which the JAX package "
                           "takes with jax.value_and_grad of its plain attention",
             launches=train_launches["flash_attention_bwd"],
             launches_per_step=tr["want"]["flash_attention_bwd"],
             max_abs_err=k4b["err"], max_abs_err_on="N(0, 1) inputs and the option grid",
             ms=k4b["ms"], plain_ms=k4b["plain_ms"],
             bound_ms=k4b["bound_ms"], bound_by=k4b["bound_by"],
             library_ms=k4b["library_ms"],
             library_call="torch.autograd.grad through scaled_dot_product_attention("
                          "is_causal=True, enable_gqa=True)",
             shape=k4b["shape"], tflops=k4b["tflops"], against_float64=k4b["checks"],
             option_grid_max_abs_err=k4b["grid_err"], bf16_route=k4b["route"],
             launches_bf16_wgmma=train_launches["flash_attention_bwd_bf16_wgmma"],
             sass=bwd_sass),
        dict(name="rms_norm_bwd", route="cuda", source="src/repro_torch/csrc/rmsnorm_bwd.cu",
             replaces="src/repro/kernels/rmsnorm/rmsnorm.py:25",
             replaces_what="the gradient of rms_norm_2d, which the JAX package takes "
                           "with jax.value_and_grad of models/layers.rms_norm",
             launches=train_launches["rms_norm_bwd"],
             launches_per_step=tr["want"]["rms_norm_bwd"],
             max_abs_err=k3b["err"], max_abs_err_on="N(0, 1) inputs", ms=k3b["ms"],
             plain_ms=k3b["plain_ms"],
             bound_ms=k3b["bound_ms"], bound_by=k3b["bound_by"],
             library_ms=k3b["library_ms"],
             library_call="torch.autograd.grad through torch.nn.functional.rms_norm",
             shape=k3b["shape"], against_float64=k3b["checks"], variant=k3b["variant"]),
    ]
    print(f"AMS summary: eager iteration busy share {trace['busy_share']:.3f} "
          f"({trace['launches']} launches, wall {trace['wall_ms']:.2f} ms); race at "
          f"({B}, 20) winner {main_exec['race']['winner']} (graph "
          f"{main_exec['race']['graph_s']:.4f} s, loop {main_exec['race']['loop_s']:.4f} s); "
          f"graph vs loop {json.dumps(shapes)}; flat masked Adam "
          f"{breakdown['adam_ms']:.3f} ms an iteration (device "
          f"{breakdown['adam_device_ms']:.4f}; the tree step {breakdown['tree_step_ms']:.3f}, "
          f"device {breakdown['tree_step_device_ms']:.4f})")
    print(f"streaming schemes summary: phase {schemes_s:.1f} s; sequential ams phase "
          f"stages {json.dumps({k: round(v, 3) for k, v in seq.items()})}")
    print(f"serving summary: groups by B {serving_groups}, mean mIoU "
          f"{serving['mean_miou']:.4f}, drift_ratio train_fused "
          f"{serving['observability']['drift'].get('train_fused', {}).get('drift_ratio')}")
    print(f"LLM summary: prefill {llm['prefill_ms']:.1f} ms (the previous slice's runs "
          f"on an H100 80GB HBM3 at 700 W: 678.6-686.4; cold "
          f"{llm_cold['prefill_ms']:.1f}), decode {llm['decode_ms_per_token']:.3f} "
          f"ms/token (cold {llm_cold['decode_ms_per_token']:.3f}), peak {peak:,} bytes")
    print(f"MoE summary: {mcfg.name} prefill {moe['prefill_ms']:.1f} ms (cold "
          f"{moe_cold['prefill_ms']:.1f}), decode {moe['decode_ms_per_token']:.3f} ms/token "
          f"(cold {moe_cold['decode_ms_per_token']:.3f}), peak {moe_peak:,} bytes; K4 at "
          f"{tuple(mk['shape'])} {mk['ms']:.3f} ms (SDPA {mk['library_ms']:.3f}, bound "
          f"{mk['bound_ms']:.4f}); the MoE phase took {moe_s:.1f} s")
    for label, r, secs, extra in (("Hybrid", hyb, hyb_s, f"; K4 at {tuple(hk4['shape'])} "
                                   f"{hk4['ms']:.3f} ms (SDPA {hk4['library_ms']:.3f}, bound "
                                   f"{hk4['bound_ms']:.4f}); K3 at {tuple(hk3['shape'])} "
                                   f"{hk3['prefill']['ms']:.4f} ms"),
                                  ("Recurrent", rec, rec_s, f"; K3 at {tuple(rk3['shape'])} "
                                   f"{rk3['prefill']['ms']:.4f} ms"),
                                  ("EncDec", enc, enc_s, f"; K4 encoder at "
                                   f"{tuple(ek4['shape'])} {ek4['ms']:.4f} ms (SDPA "
                                   f"{ek4['library_ms']:.4f}, bound {ek4['bound_ms']:.4f}), "
                                   f"cross at {tuple(xk4['shape'])} over {xk4['kv_len']} "
                                   f"{xk4['ms']:.4f} ms (SDPA {xk4['library_ms']:.4f}, bound "
                                   f"{xk4['bound_ms']:.4f})"),
                                  ("VLM", vlm, vlm_s, f"; K4 cross at {tuple(vk4['shape'])} "
                                   f"over {vk4['kv_len']} {vk4['ms']:.4f} ms (SDPA "
                                   f"{vk4['library_ms']:.4f}, bound {vk4['bound_ms']:.4f}); K3 "
                                   f"at {tuple(vk3['shape'])} {vk3['prefill']['ms']:.4f} ms")):
        print(f"{label} summary: {r['cfg'].name} prefill {r['run']['prefill_ms']:.1f} ms "
              f"(cold {r['cold']['prefill_ms']:.1f}), decode "
              f"{r['run']['decode_ms_per_token']:.3f} ms/token (cold "
              f"{r['cold']['decode_ms_per_token']:.3f}), peak {r['peak']:,} bytes; hand-off "
              f"logits {r['handoff']['logits']:.4e}, blocks "
              f"{max(r['handoff']['blocks'].values()):.4e} at most{extra}; the phase took "
              f"{secs:.1f} s")
    print("HANDOFF " + json.dumps({hyb["cfg"].name: hyb["handoff"],
                                   f"{hyb['cfg'].name} float32": hyb["handoff_float32"],
                                   rec["cfg"].name: rec["handoff"],
                                   enc["cfg"].name: enc["handoff"],
                                   f"{vlm['cfg'].name} ({vlm['cfg'].num_layers} layers)":
                                   vlm["handoff"]}))
    print("ANALYTIC_SHARES " + json.dumps({cfg.name: llm_shares, mcfg.name: moe_shares,
                                           hyb["cfg"].name: hyb_shares,
                                           rec["cfg"].name: rec_shares,
                                           enc["cfg"].name: enc_shares,
                                           f"{vlm['cfg'].name} ({vlm['cfg'].num_layers} "
                                           "layers)": vlm_shares}))
    print(f"Train summary: {tr['cfg'].name} step {tr['warm_step_ms']:.1f} ms (median after "
          f"the first), MFU {tr['mfu']:.3f}, peak {tr['peak']:,} bytes (predicted "
          f"{TRAIN_PEAK_PREDICTED:,.0f}); K4-bwd {k4b['ms']:.3f} ms (SDPA backward "
          f"{k4b['library_ms']:.3f}, bound {k4b['bound_ms']:.4f}), K3-bwd {k3b['ms']:.4f} ms "
          f"(F.rms_norm backward {k3b['library_ms']:.4f}, bound {k3b['bound_ms']:.4f}); the "
          f"phase took {tr['seconds']:.1f} s")
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
