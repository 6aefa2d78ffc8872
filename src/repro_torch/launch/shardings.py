"""Per-(arch, mesh, input-shape) sharding rules (the JAX package's
`launch/shardings.py`, rule for rule).

Strategy:
  * tensor-parallel over "model": attention kv-heads (or q-groups when kv
    doesn't divide), mlp/expert ff, vocab, MoE experts — each applied only
    when the dimension divides the mesh axis;
  * FSDP over "data" on the embed (d_model) axis of every weight, so Adam
    moments shard 16x256-way on the big archs;
  * attention weights whose head dims can't shard fall back to
    ("data","model") FSDP on their embed axis (`models.common.meta_pspec`
    keeps the non-conflicting components);
  * batch over ("pod","data"); decode caches shard seq over "model" when kv
    heads can't (and over data too for batch=1 long-context).

``mesh`` is a `launch.mesh.MeshShape` (axis names and sizes): the rules
read nothing else of it. The dry run (`launch.dryrun`) prices each
device's share with these rules, and its sharded trace runs the step on
DTensors placed by them (`placements_for`, `shard_tree`) over a fake
device mesh (`launch.mesh.fake_mesh`).
"""
from __future__ import annotations

from repro_torch import spmd
from repro_torch.models.common import ModelConfig


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def rules_for(cfg: ModelConfig, mesh, *, shape_kind: str = "train", fsdp: bool = True,
              attn_dp: bool = False, moe_shard: bool = False,
              decode_ep: bool = False) -> dict:
    """shape_kind: train | prefill | decode | decode_long (affects batch and
    cache-seq rules only).

    attn_dp: when attention heads can't shard over "model", the default
    fallback shards attention weights over ("data","model"), and the
    model-sharded contraction then all-reduces activation-sized partial
    sums every layer. attn_dp instead keeps attention weights
    ("data",)-sharded and replicated over "model": per-layer traffic
    becomes weight-sized all-gathers.

    moe_shard (coarse-routed MoE whose experts divide "model"): experts
    over model, expert ff over data, embed local.

    decode_ep (MoE decode, experts divisible): a weight-stationary layout,
    no weight dims on "data"; expert ff shards over data instead."""
    axes = mesh.axis_sizes()
    model_n = axes.get("model", 1)
    data_parts = tuple(a for a in ("pod", "data") if a in axes)

    kv_ok = _div(cfg.num_kv_heads, model_n)
    g_ok = _div(cfg.num_heads // max(cfg.num_kv_heads, 1), model_n)

    rules: dict = {
        "layers": None,
        "embed": ("data",) if (fsdp and "data" in axes and _div(cfg.d_model, axes["data"])) else None,
        "heads": "model" if _div(cfg.num_heads, model_n) else None,
        "kv_heads": "model" if kv_ok else None,
        "qgroups": "model" if (not kv_ok and g_ok) else None,
        # attention embed: FSDP always; adds "model" when heads don't shard
        "attn_embed": None,
        "ff": "model" if _div(cfg.d_ff, model_n) else None,
        "vocab": "model" if _div(cfg.vocab_size, model_n) else None,
        "experts": "model" if _div(cfg.num_experts, model_n) else None,
        "unsharded": None,
    }
    # expert weights keep FSDP embed sharding
    rules["expert_embed"] = rules["embed"]
    rules["expert_ff"] = "model" if _div(cfg.expert_d_ff, model_n) else None
    if (moe_shard and cfg.num_experts and _div(cfg.num_experts, model_n)
            and cfg.experts_per_token <= 2):
        # coarse-routed EPxTP (top-1 or top-2, big experts); fine-grained
        # MoE keeps the default
        if fsdp and _div(cfg.expert_d_ff, axes.get("data", 1)):
            rules["expert_embed"] = None
            rules["expert_ff"] = ("data",)
    if (decode_ep and cfg.num_experts and _div(cfg.num_experts, model_n)
            and shape_kind in ("decode", "decode_long")
            and fsdp and _div(cfg.expert_d_ff, axes.get("data", 1))):
        rules["embed"] = None
        rules["expert_embed"] = None
        rules["expert_ff"] = ("data",)
        attn_parts = []
        if not (kv_ok or g_ok):
            attn_parts.append("model")
        d_total = 1
        for a in attn_parts:
            d_total *= axes.get(a, 1)
        rules["attn_embed"] = (
            tuple(attn_parts) if attn_parts and _div(cfg.d_model, d_total) else None
        )
        rules["batch"] = None if shape_kind == "decode_long" else (
            data_parts if len(data_parts) > 1 else data_parts[0])
        rules["cache_seq"] = ("model" if cfg.decode_window_slicing
                              or not kv_ok else None)
        if shape_kind == "decode_long" and not cfg.decode_window_slicing:
            rules["cache_seq"] = tuple(list(data_parts) + (["model"] if not kv_ok else []))
        rules["seq"] = None
        return rules

    attn_parts = list(data_parts[-1:]) if fsdp else []  # ("data",)
    if not (kv_ok or g_ok) and not attn_dp:
        attn_parts.append("model")
    d_total = 1
    for a in attn_parts:
        d_total *= axes.get(a, 1)
    rules["attn_embed"] = tuple(attn_parts) if attn_parts and _div(cfg.d_model, d_total) else (
        ("data",) if fsdp and _div(cfg.d_model, axes.get("data", 1)) else None
    )

    # activation / cache axes
    if shape_kind == "decode_long":  # global_batch == 1
        rules["batch"] = None
        if cfg.decode_window_slicing and (cfg.window_size or cfg.attn_window_override):
            # ring caches are window-sized: shard them over "model" only
            rules["cache_seq"] = "model"
        else:
            seq_parts = list(data_parts)
            if not kv_ok:
                seq_parts.append("model")
            rules["cache_seq"] = tuple(seq_parts)
    elif shape_kind == "decode":
        rules["batch"] = data_parts if len(data_parts) > 1 else data_parts[0]
        rules["cache_seq"] = "model" if not kv_ok else None
    else:
        rules["batch"] = data_parts if len(data_parts) > 1 else data_parts[0]
        rules["cache_seq"] = None
    rules["seq"] = None
    return rules


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(spec, mesh) -> list:
    """DTensor placements on ``mesh`` (a `DeviceMesh` with dim names) of a
    partition spec (`models.common.meta_pspec`: one entry a tensor dim, a
    mesh axis name, a tuple of names, or None): ``Shard(d)`` on each mesh
    dim that dim ``d`` names, ``Replicate()`` on the rest. A dim over
    several mesh dims is split over them in mesh order, as XLA splits it
    over ("pod", "data"); a dim they do not divide is split unevenly, in
    ceil-sized chunks, as XLA pads. A mesh dim of one device shards
    nothing: it replicates."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            i = names.index(a)
            if mesh.size(i) == 1:
                continue
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {a!r} shards two dims of spec {spec}")
            out[i] = Shard(d)
    return out


def shard_tree(tensors, specs, mesh, *, dtype=None, requires_grad: bool = False):
    """A nest of dicts of tensors as DTensors on ``mesh`` placed by the
    same-structure nest of ``specs`` (`placements_for`), each leaf in
    ``dtype`` where given, else its own. A meta leaf's local shard (rank
    0's) is an empty meta tensor of ceil-sized dims; a leaf with values,
    the same on every rank, is distributed (each rank keeps its shard).
    Non-tensor leaves (a decode position) stay as they are."""
    if isinstance(tensors, dict):
        return {k: shard_tree(tensors[k], specs[k], mesh, dtype=dtype,
                              requires_grad=requires_grad) for k in tensors}
    if not hasattr(tensors, "shape"):
        return tensors
    if tensors.device.type != "meta":
        from torch.distributed.tensor import distribute_tensor

        t = distribute_tensor(tensors.detach().to(dtype or tensors.dtype), mesh,
                              placements_for(specs, mesh))
        return t.requires_grad_(requires_grad)
    return spmd.from_meta(tensors.shape, dtype or tensors.dtype, mesh,
                          placements_for(specs, mesh), requires_grad=requires_grad)
