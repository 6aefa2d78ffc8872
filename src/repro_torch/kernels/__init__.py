"""Hand-written CUDA kernels for the serving hot path, for Hopper (sm_90a).

Six kernel families live here, each as ``ops.py`` (the wrapper, with its
launch counter) + ``ref.py`` (the plain PyTorch version); the CUDA
sources are in ``repro_torch/csrc/`` and `build` compiles them at first
use:

* ``masked_adam`` — the fused Algorithm-2 inner update over per-dtype
  ``(B, rows, 128)`` buffers of a fused session stack;
* ``topk_mask`` — the exact bit-pattern top-k threshold behind
  gradient-guided selection;
* ``rmsnorm`` — the LLM zoo's (1 + w)-scaled RMSNorm over rows;
* ``flash_attention`` — the LLM zoo's forward flash attention for
  prefill, in the model's ``(B, S, KV, G, hd)`` layout;
* ``grad_norm`` — the trainer's global gradient norm;
* ``wkv6`` — RWKV-6's wkv recurrence over a whole sequence (the
  prefill's scan).

A wrapper given a CUDA tensor launches its kernel or raises; given a CPU
tensor it runs the plain version. There is no switch and no fallback.
"""
