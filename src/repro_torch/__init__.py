"""PyTorch/CUDA port of the AMS system, for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package stands alone
(it imports neither ``jax`` nor ``repro``) and mirrors its layout, so
``repro_torch/core/masked_adam.py`` is the counterpart of
``repro/core/masked_adam.py`` and so on.

Ported (the fused AMS server phase for B sessions of the seg student,
down to the edge's mIoU):

* host side, copied: ``data/video.py``, ``metrics/miou.py``,
  ``core/buffer.py``, ``core/sampler.py``, ``core/atr.py``;
* ``models/common.py`` (the metadata the student needs) and
  ``models/seg/student.py``, with ``params_from_numpy`` to carry the JAX
  package's weights over; parameters keep its HWIO layout and key names;
* ``core/masked_adam.py``, ``core/selection.py``, ``core/delta.py``,
  ``core/client.py``, ``core/server.py``, ``core/batched.py`` and
  ``sim/seg_world.py``;
* the two kernels on that path, hand-written in CUDA C++ for sm_90a
  (sources in ``csrc/``, built at first use by ``kernels/build.py``):
  the fused masked-Adam step and the bit-pattern top-k threshold. Each
  has a plain PyTorch version in its ``ref.py``, which CPU tensors take
  and which the kernel is held against on the card.

Ported (the LLM zoo's dense serving path, prefill and greedy decode):

* ``models/common.py`` (the whole ``ModelConfig``, initialisers that draw
  on the card), ``models/layers.py``, ``models/attention.py``,
  ``models/transformer.py`` (dense block kinds) and ``models/registry.py``
  with ``params_from_numpy``; ``configs/`` (Gemma-2 9B and Gemma 2B);
  ``launch/steps.py`` and ``launch/serve.py``;
* its two kernels, hand-written in CUDA C++ for sm_90a: RMSNorm and
  forward flash attention (grouped KV heads, causal, sliding-window and
  softcap masks).

Not ported yet: the serving engine (``serving/``), the learned teacher,
``pretrain_student``, ``sim/runner.py`` and the multi-client simulator,
the momentum optimizer and the Table-3 selection strategies, sharded
execution, the exec/kernel-mode races and ``core/timing.py``, the
roofline model, and the LLM zoo's MoE, Mamba2, RWKV6, cross-attention and
encoder modules with their configs, ``data/tokens.py``, ``checkpoint/``
and the dry-run and training launchers.

Entry points take ``device="cuda"`` by default and raise when there is
no card; the CPU runs only when the caller passes ``device="cpu"``.
"""
