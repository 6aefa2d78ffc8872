"""Model configuration and parameter metadata: the port's counterpart of
the JAX package's `models/common.py`.

``ModelConfig`` is copied field for field, so the architecture configs
(`repro_torch.configs`) copy verbatim. Fields that only steer the JAX
package's sharding, scan or kernel choice (``remat``, ``use_pallas``,
``scan_unroll``, ``act_sharding``, ``moe_ep_axis``, ``moe_cap_axes``,
``attn_q_chunk``, ``attn_kv_chunk``) are kept and read by nothing here:
the port runs eagerly (its dry run's sharded trace places tensors by the
sharding rules alone), and a CUDA tensor always takes the hand-written
kernels.

A ``ParamMeta`` tree describes every leaf's shape, its logical axes
(one name a dimension, the JAX package's vocabulary below) and its
initialiser. It is the source of truth for three views of a model:

  * ``init_params``      draws real weights from a `torch.Generator`, on
                         the generator's own device, so a full-size model
                         is drawn on the card (its largest leaves one
                         stacked slice at a time, `WHOLE_DRAW_BYTES`);
  * ``abstract_params``  gives tensors on ``torch.device("meta")``: shapes
                         and dtypes, no storage (the dry run,
                         `launch/dryrun.py`);
  * ``partition_specs``  maps the logical axes to mesh axes through a
                         rules table (`launch/shardings.py`).

A partition spec here is a plain tuple, one entry a dimension: a mesh
axis name, a tuple of names, or None (the JAX package's
``PartitionSpec``, which torch has no counterpart of).

Logical axis vocabulary (the JAX package's):
  "layers"   the stacked group axis                     (never sharded)
  "embed"    d_model                                    (FSDP -> "data")
  "heads"    fused attention head dim (H*hd)            (TP   -> "model")
  "ff"       mlp hidden                                 (TP   -> "model")
  "vocab"    vocabulary                                 (TP   -> "model")
  "experts"  MoE expert dim                             (EP   -> "model")
  "unsharded" anything replicated (norm scales, biases, conv taps, ...)

The draws cannot match ``jax.random`` bit for bit, so tests that compare
the two packages carry the JAX package's weights over instead
(`params_from_numpy`).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


@dataclass(frozen=True)
class ModelConfig:
    """One config type for every architecture family (see configs/)."""

    name: str = "model"
    family: str = "dense"  # dense|moe|ssm|hybrid|vlm|audio|seg
    source: str = ""  # citation (arXiv id / hf model card)

    # trunk
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # block pattern, repeated num_layers/len(pattern) times (groups).
    # Block kinds: attn | attn_local | xattn | attn_xattn | moe | moe_local
    #              | mamba | rwkv
    pattern: tuple = ("attn",)

    # attention details
    window_size: int = 0  # for *_local blocks
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    post_norm: bool = False  # gemma2-style post-block norms
    rope_theta: float = 10_000.0
    pos: str = "rope"  # rope|learned|none
    max_position: int = 1 << 20  # for learned positions only

    # mlp
    mlp_act: str = "swiglu"  # swiglu|geglu|gelu
    norm: str = "rms"  # rms|layer
    norm_plus_one: bool = False  # gemma-style (1 + w) RMSNorm scale
    embed_scale: bool = False  # gemma sqrt(d_model) embedding scale
    tie_embeddings: bool = True

    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    expert_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # hybrid (zamba2): a single *shared* attention block applied at the start
    # of every group (weights reused across groups).
    shared_attn: bool = False

    # cross-attention inputs (vlm patches / audio frames)
    num_xattn_tokens: int = 0

    # encoder (whisper)
    encoder_layers: int = 0

    # numerics / runtime
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = False  # activation checkpointing per group body in training
    use_pallas: bool = False  # read by nothing here (no kernel switch)
    scan_unroll: bool = False  # read by nothing here (no scan)
    attn_q_chunk: int = 512  # read by nothing here (the kernel tiles)
    attn_kv_chunk: int = 512
    act_sharding: tuple | None = None  # read by nothing here (one card)
    # windowed decode uses a ring cache of size min(seq, window)
    decode_window_slicing: bool = False
    moe_ep_axis: str | None = None  # read by nothing here (one card)
    moe_cap_axes: tuple | None = None
    # runtime sliding-window override applied to *full* attention blocks
    # (long-context policy for dense archs); 0 = no override.
    attn_window_override: int = 0

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def num_groups(self) -> int:
        assert self.num_layers % len(self.pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern length {len(self.pattern)}"
        )
        return self.num_layers // len(self.pattern)

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Param metadata
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamMeta:
    shape: tuple
    axes: tuple  # logical axis names, len == len(shape)
    init: str = "fan_in"  # fan_in|zeros|ones|normal|embed
    init_scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def tree_map_meta(fn: Callable[[ParamMeta], Any], metas):
    return tree.tree_map(fn, metas)


# A leaf whose float32 draw would take more than this many bytes is drawn
# one slice of its leading (stacked-group) axis at a time, straight into
# the final tensor: Moonlight-16B-A3B's stacked expert leaves (48, 64,
# 2048, 1408) would need a 35.4 GB float32 temporary beside their 17.7 GB
# bf16 result. Gemma-2 9B's largest leaf is 4.3 GB in float32, so every
# leaf of it is drawn whole.
WHOLE_DRAW_BYTES = 8 << 30


def _leaf_init(meta: ParamMeta, gen: torch.Generator, dtype, device):
    if meta.init == "zeros":
        return torch.zeros(meta.shape, dtype=dtype, device=device)
    if meta.init == "ones":
        return torch.ones(meta.shape, dtype=dtype, device=device)
    if meta.init == "normal":
        scale = meta.init_scale
    elif meta.init == "embed":
        scale = 1.0
    elif meta.init == "fan_in":
        # fan-in is the second-to-last axis by convention (matmul lhs dim);
        # for 1-D params fall back to the only axis.
        fan_in = meta.shape[-2] if len(meta.shape) >= 2 else meta.shape[0]
        scale = meta.init_scale / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {meta.init}")
    # drawn in float32 on the generator's device, so a seed gives the same
    # weights wherever they end up
    if 4 * math.prod(meta.shape) <= WHOLE_DRAW_BYTES or len(meta.shape) < 2:
        x = torch.randn(meta.shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return x.mul_(scale).to(device=device, dtype=dtype)
    out = torch.empty(meta.shape, dtype=dtype, device=device)
    for i in range(meta.shape[0]):
        x = torch.randn(meta.shape[1:], generator=gen, dtype=torch.float32,
                        device=gen.device)
        out[i].copy_(x.mul_(scale))
    return out


def init_params(metas, gen: torch.Generator, dtype, device) -> dict:
    """Materialize real parameters from a ParamMeta tree, leaves drawn in
    flatten order from ``gen``. A CPU generator gives the same weights on
    every device; a CUDA generator draws on the card, which a model of
    billions of parameters needs."""
    return tree.tree_map(lambda m: _leaf_init(m, gen, dtype, device), metas)


def params_from_numpy(params, device="cuda", dtype=None) -> dict:
    """Carry a parameter tree of arrays (the JAX package's params or
    caches, as numpy or anything `np.asarray` takes, same nesting) into
    the port as tensors on ``device``: bit for bit, or cast to ``dtype``.
    bfloat16 arrays (ml_dtypes) come over through their bits."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        return t.to(device=dev, dtype=dtype or t.dtype)

    return tree.tree_map(leaf, params)


def abstract_params(metas, dtype) -> dict:
    """The tree as tensors on the meta device, in ``dtype``: shapes and
    dtypes, no storage (the dry run)."""
    meta = torch.device("meta")
    return tree_map_meta(lambda m: torch.empty(m.shape, dtype=dtype, device=meta), metas)


# Default tensor-parallel rules; fsdp=True additionally shards the embed
# (d_model) axis of weight matrices over the data axis (ZeRO-3 semantics).
def sharding_rules(*, fsdp: bool, data_axis="data", model_axis="model") -> dict:
    return {
        "layers": None,
        "embed": data_axis if fsdp else None,
        "heads": model_axis,
        "kv_heads": model_axis,
        "qgroups": None,
        "ff": model_axis,
        "vocab": model_axis,
        "experts": model_axis,
        "expert_embed": data_axis if fsdp else None,
        "expert_ff": model_axis,
        "unsharded": None,
        # activation/cache logical axes (used by launch/shardings.py)
        "batch": data_axis,
        "seq": None,
        "cache_seq": None,
    }


def meta_pspec(meta: ParamMeta, rules: dict) -> tuple:
    """Map logical axes -> mesh axes; a mesh axis may appear only once, the
    first logical axis wins (e.g. MoE (experts, embed, ff): experts->model,
    then ff must stay unsharded). Tuple rules keep their non-conflicting
    components (partial FSDP+TP sharding)."""
    used = set()
    out = []
    for ax in meta.axes:
        mesh_ax = rules.get(ax)
        parts = (
            () if mesh_ax is None else (mesh_ax,) if isinstance(mesh_ax, str) else tuple(mesh_ax)
        )
        parts = tuple(a for a in parts if a not in used)
        if not parts:
            out.append(None)
        else:
            used.update(parts)
            out.append(parts[0] if len(parts) == 1 else parts)
    return tuple(out)


def partition_specs(metas, rules: dict):
    return tree_map_meta(lambda m: meta_pspec(m, rules), metas)


def param_count(metas) -> int:
    return sum(math.prod(m.shape) for m in tree.leaves(metas))


def param_bytes(metas, dtype) -> int:
    return param_count(metas) * dtype.itemsize


# ---------------------------------------------------------------------------
# Shared building blocks for meta trees
# ---------------------------------------------------------------------------


def norm_meta(d: int) -> ParamMeta:
    # every norm stores its scale as an offset w, applied as (1 + w)
    return ParamMeta((d,), ("unsharded",), init="zeros")


def dense_meta(d_in: int, d_out: int, ax_in: str, ax_out: str, scale=1.0) -> ParamMeta:
    return ParamMeta((d_in, d_out), (ax_in, ax_out), init="fan_in", init_scale=scale)


def stack_group(metas, n_groups: int):
    """Prepend a 'layers' axis of ``n_groups`` to every leaf of a block
    meta tree."""
    return tree_map_meta(
        lambda m: ParamMeta((n_groups, *m.shape), ("layers", *m.axes), m.init,
                            m.init_scale), metas)
