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

Ported (the paper's streaming schemes and the serving runtime):

* ``sim/runner.py`` (the five schemes of §4.1), ``data/codec.py``,
  ``core/bandwidth.py``, momentum SGD and the Table-3 selection
  strategies, ``models/seg/teacher.py`` (the learned teacher) and
  ``pretrain_student``;
* the serving engine, ``serving/`` (events, network, faults, policies,
  the GPU pool with its ``device_backend="torch"`` binding, the fleet,
  the flight recorder and drift audit, sessions that bind real AMS cores,
  the engine), ``core/scheduler.py``, ``core/timing.py`` with its stage
  hooks in ``core/batched.py``, ``core/selection.py`` and
  ``core/delta.py``, and ``sim/multiclient.py``.

Ported (the fused path's execution shape): the flat layout of the
masked-Adam K loop, the K loop as one CUDA graph or an eager loop, and
the race between them (``core/batched.py``).

Ported (the LLM zoo's MoE serving path and the roofline arithmetic):
``models/moe.py`` with the ``moe``/``moe_local`` block kinds, the SwiGLU
MLP, the configs of Moonlight-16B-A3B, Mixtral 8x22B, Llama-4 Maverick
and Llama 3 405B; ``roofline/analytic.py``, ``roofline/analysis.py`` (its
arithmetic) and ``launch/mesh.py`` (an H100's constants).

Ported later: the Mamba2, RWKV6, cross-attention and encoder modules
with their configs, ``data/tokens.py``, ``checkpoint/`` and the training
launcher; and the dry run (``launch/dryrun.py``, ``launch/input_specs.py``,
``launch/shardings.py``, the production meshes of ``launch/mesh.py``,
``roofline/analysis.trace_facts``), which traces every step on the meta
device.

Ported last: sharded execution on several cards
(``core.batched.train_phases_sharded``, the session mesh of
``launch/mesh.py``, ``launch/host_mesh.py``).

Not ported yet: the collective-bytes reader of ``roofline/analysis.py``.

Entry points take ``device="cuda"`` by default and raise when there is
no card; the CPU runs only when the caller passes ``device="cpu"``. The
dry run is the exception: it makes only meta tensors, on any host.
"""
