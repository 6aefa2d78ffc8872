"""Batched serving entry point: prefill a prompt batch, then greedy-decode tokens
against the KV cache (the JAX package's `launch/serve.py`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --batch 2 --prompt-len 16 --tokens 8 --device cpu

runs a smoke config on the CPU (``--arch moonshot-v1-16b-a3b`` for the
MoE one, ``zamba2-7b`` for the Mamba2 hybrid, ``rwkv6-3b`` for RWKV6,
``llama-3.2-vision-90b`` and ``whisper-large-v3`` for cross-attention and
the encoder, fed the JAX CLI's stub memory of ``0.1``s); without
``--device`` it runs on the card. `serve` is the function behind it: it
prefills, then decodes against the KV, cross-attention and
recurrent-state caches. The six full-size paths, which `chip_smoke.py`
drives and `scripts/profile_llm_serve.py` profiles, are defined once
here: `MAIN_ARCH` (dense), `MOE_ARCH`, `HYBRID_ARCH`, `RECURRENT_ARCH`,
`ENCDEC_ARCH` and `VLM_ARCH`, each with its batch of prompts and decode
steps (`main_path_inputs`, `moe_path_inputs`, `hybrid_path_inputs`,
`recurrent_path_inputs`, `encdec_path_inputs`, `vlm_path_inputs`). Each
returns ``(cfg, params, prompt, memory)``, memory None where the model
has no cross-attention.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core import timing
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.rmsnorm import ops as norm_ops
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build


# The main path: Gemma-2 9B's published config with random bf16 weights,
# 8,000-token prompts (past the 4,096 window, not a multiple of the
# attention kernel's 64-row tile), then 64 greedy decode steps.
MAIN_ARCH = "gemma2-9b"
MAIN_BATCH, MAIN_PROMPT, MAIN_DECODE = 2, 8000, 64

# The MoE path: Moonlight-16B-A3B's published config (48 layers, 64 routed
# experts top-6 and 2 shared, 28.55B parameters, 57.1 GB in bf16) with
# random bf16 weights, the same prompts and decode steps as the main path.
# On one 80 GB card: the weights, a 6.3 GB bf16 KV cache at 2 x 8,064
# positions and a few hundred MB of MoE dispatch transients a layer.
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_BATCH, MOE_PROMPT, MOE_DECODE = 2, 8000, 64

# The hybrid path: Zamba2-7B's published config (81 Mamba2 layers in 27
# groups of 3, one shared attention + SwiGLU block before each group, 32
# heads of 112; 6,635,851,856 parameters, 13.3 GB in bf16) with random
# bf16 weights, the same prompts and decode steps. Its caches at 2 x 8,064
# positions: the shared block's K/V for 27 groups (6.2 GB in bf16) and
# float32 SSM states.
HYBRID_ARCH = "zamba2-7b"
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_DECODE = 2, 8000, 64

# The recurrent path: RWKV6-3B's published config (32 layers, d_model
# 2,560, 40 wkv heads of 64; 2,690,501,120 parameters, 5.4 GB in bf16)
# with random bf16 weights, the same prompts and decode steps. Its cache is
# float32 wkv states and the last normed inputs, whatever the prompt.
RECURRENT_ARCH = "rwkv6-3b"
RECURRENT_BATCH, RECURRENT_PROMPT, RECURRENT_DECODE = 2, 8000, 64

# The encoder-decoder path: Whisper large-v3's published config (32
# encoder and 32 decoder layers, d_model 1,280, 20 heads of 64;
# 1,534,602,240 parameters, 3.07 GB in bf16) with random bf16 weights:
# 16 stub 30 s audio windows of 1,500 frame embeddings, as a transcription
# server batches them, 64-token decoder prompts and 64 decode steps (a
# decoder context of 128, under Whisper's 448). No cut.
ENCDEC_ARCH = "whisper-large-v3"
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_DECODE = 16, 64, 64

# The vision-language path: Llama-3.2-Vision 90B at its published width
# (d_model 8,192, 64 query and 8 KV heads of 128, d_ff 28,672) cut from
# 100 to 20 layers, 4 groups of (4 self-attention blocks, 1 gated
# cross-attention block): 18,163,769,348 parameters, 36.3 GB in bf16 (the
# whole model, 173 GB, does not fit one card). An image's 1,601 stub patch
# embeddings and an 8,000-token prompt per row, batch 2, 64 decode steps.
VLM_ARCH = "llama-3.2-vision-90b"
VLM_LAYERS = 20
VLM_BATCH, VLM_PROMPT, VLM_DECODE = 2, 8000, 64


def _path_inputs(arch: str, batch: int, prompt_len: int, device, **overrides):
    """The config, its weights drawn on the device from a generator seeded
    with 0, (batch, prompt_len) random token ids from the same generator
    and, for a model with cross-attention, a memory of N(0, 1) stub
    embeddings (batch, num_xattn_tokens, d_model) in the compute dtype,
    drawn after them (not the CLI's constant: with equal memory rows the
    cross-attention's softmax is uniform, and a wrong K/V tail would go
    unseen)."""
    dev = resolve_device(device)
    cfg = get_config(arch, **overrides)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build(cfg).init(gen, dev)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev)
    memory = None
    if cfg.num_xattn_tokens:
        memory = torch.randn((batch, cfg.num_xattn_tokens, cfg.d_model), generator=gen,
                             device=dev).to(cfg.cdtype)
    return cfg, params, prompt, memory


def main_path_inputs(device="cuda"):
    """``(cfg, params, prompt, None)`` of the main path: `MAIN_ARCH`'s full
    config, its weights drawn on ``device`` from a generator seeded with 0,
    and (MAIN_BATCH, MAIN_PROMPT) random token ids from the same generator."""
    return _path_inputs(MAIN_ARCH, MAIN_BATCH, MAIN_PROMPT, device)


def moe_path_inputs(device="cuda"):
    """``(cfg, params, prompt, None)`` of the MoE path: `MOE_ARCH`'s full
    config, its bf16 weights drawn on ``device`` from a generator seeded
    with 0, and (MOE_BATCH, MOE_PROMPT) random token ids from the same
    generator."""
    return _path_inputs(MOE_ARCH, MOE_BATCH, MOE_PROMPT, device)


def hybrid_path_inputs(device="cuda", **overrides):
    """``(cfg, params, prompt, None)`` of the hybrid path: `HYBRID_ARCH`'s
    full config, its bf16 weights drawn on ``device`` from a generator
    seeded with 0, and (HYBRID_BATCH, HYBRID_PROMPT) random token ids from
    the same generator. ``overrides`` change config fields: with
    ``param_dtype="float32"`` the weights are the same draws, unrounded."""
    return _path_inputs(HYBRID_ARCH, HYBRID_BATCH, HYBRID_PROMPT, device, **overrides)


def recurrent_path_inputs(device="cuda"):
    """``(cfg, params, prompt, None)`` of the recurrent path:
    `RECURRENT_ARCH`'s full config, its bf16 weights drawn on ``device``
    from a generator seeded with 0, and (RECURRENT_BATCH, RECURRENT_PROMPT)
    random token ids from the same generator."""
    return _path_inputs(RECURRENT_ARCH, RECURRENT_BATCH, RECURRENT_PROMPT, device)


def encdec_path_inputs(device="cuda"):
    """``(cfg, params, prompt, memory)`` of the encoder-decoder path:
    `ENCDEC_ARCH`'s full config, its bf16 weights, (ENCDEC_BATCH,
    ENCDEC_PROMPT) random token ids and (ENCDEC_BATCH, 1500, 1280) N(0, 1)
    frame embeddings, all from one generator seeded with 0 on ``device``."""
    return _path_inputs(ENCDEC_ARCH, ENCDEC_BATCH, ENCDEC_PROMPT, device)


def vlm_path_inputs(device="cuda"):
    """``(cfg, params, prompt, memory)`` of the vision-language path:
    `VLM_ARCH`'s config at `VLM_LAYERS` layers, its bf16 weights, (VLM_BATCH,
    VLM_PROMPT) random token ids and (VLM_BATCH, 1601, 8192) N(0, 1) patch
    embeddings, all from one generator seeded with 0 on ``device``. Every
    cross-attention ``gate`` is then set to 1.0: the init's 0 makes
    tanh(gate) = 0, so the cross-attention would add nothing to the logits
    and no check on the path could see it."""
    cfg, params, prompt, memory = _path_inputs(VLM_ARCH, VLM_BATCH, VLM_PROMPT, device,
                                               num_layers=VLM_LAYERS)
    for i, kind in enumerate(cfg.pattern):
        if kind == "xattn":
            params["groups"][f"b{i}"]["gate"].fill_(1.0)
    return cfg, params, prompt, memory


class _Clock:
    """Milliseconds between marks: CUDA events on the card (device time,
    read after one synchronise), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self, i: int, j: int) -> float:
        a, b = self.marks[i], self.marks[j]
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b)
        return 1e3 * (b - a)


def _counts():
    return {"rms_norm": norm_ops.launches, "flash_attention": attn_ops.launches}


def _diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def serve(cfg: ModelConfig, params: dict, prompt: torch.Tensor, n_tokens: int,
          device="cuda", memory=None) -> dict:
    """Prefill ``prompt`` (B, S) and take ``n_tokens`` greedy decode steps
    against a cache of ``S + n_tokens`` positions (and the recurrent
    blocks' states and the memory's cross-attention K/V, which the prefill
    hands over). ``memory`` (B, Sm, d_model): the stub frontend embeddings
    that cross-attention reads (encoded first where the model has an
    encoder); the prefill's time includes the encoder.

    Returns a dict: ``tokens`` (B, n_tokens + 1) int32 on the host (the
    prefill's token, then one per decode step); ``finite`` (every logit of
    the run was finite); ``prefill_ms`` and ``decode_ms_per_token``
    (device time on the card, host time on the CPU); ``launches``, the
    RMSNorm and flash-attention kernel launches of the prefill and of all
    decode steps (0 on the CPU, where the plain versions run).

    Its spans (`core.timing.span`): ``serve.call`` around the whole
    call, its attributes the batch and the token and frame counts;
    ``serve.prefill`` over the interval that ``prefill_ms`` times;
    ``serve.decode_step`` around each decode step, whose host stamps are
    the tokens' timestamps."""
    B, S = prompt.shape
    with timing.span("serve.call", batch=B, prompt_tokens=S, new_tokens=n_tokens,
                     memory_positions=0 if memory is None else memory.shape[1]):
        dev = resolve_device(device)
        model = build(cfg)
        prompt = prompt.to(dev)
        batch = {"tokens": prompt}
        if memory is not None:
            batch["memory"] = memory.to(dev)
        prefill_step = make_prefill_step(model, S + n_tokens)
        serve_step = make_serve_step(model)

        clock = _Clock(dev)
        c0 = _counts()
        clock.mark()
        with timing.span("serve.prefill"):
            logits, caches = prefill_step(params, batch)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, 1)
        clock.mark()
        c1 = _counts()
        finite = torch.isfinite(logits).all()
        out = [tok]
        for i in range(n_tokens):
            with timing.span("serve.decode_step"):
                tok, caches, logits = serve_step(params, caches, {"tokens": tok, "pos": S + i})
                finite &= torch.isfinite(logits).all()  # stays on the device
            out.append(tok)
        clock.mark()
        c2 = _counts()
        return {
            "tokens": torch.cat(out, dim=1).cpu(),
            "finite": bool(finite),
            "prefill_ms": clock.ms(0, 1),
            "decode_ms_per_token": clock.ms(1, 2) / max(n_tokens, 1),
            "launches": {"prefill": _diff(c1, c0), "decode": _diff(c2, c1)},
        }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build(cfg).init(gen, dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    memory = None
    if cfg.num_xattn_tokens:  # the JAX package's CLI stub
        memory = 0.1 * torch.ones((args.batch, cfg.num_xattn_tokens, cfg.d_model),
                                  device=dev)
    # --tokens counts the prefill's token too, as in the JAX package's CLI
    r = serve(cfg, params, prompt, max(args.tokens - 1, 0), dev, memory=memory)
    dt = r["decode_ms_per_token"]
    print(f"arch={cfg.name} device={dev} batch={args.batch} "
          f"prefill={r['prefill_ms']:.1f}ms decode={dt:.2f}ms/tok "
          f"({args.batch * 1e3 / max(dt, 1e-9):.1f} tok/s) finite={r['finite']} "
          f"launches={r['launches']}")
    print("sample:", r["tokens"][0, :16].tolist())


if __name__ == "__main__":
    main()
