"""Dry run on the meta device: the shape proof and per-device cost account
of every (architecture x input shape) pair on the production meshes (the
JAX package's `launch/dryrun.py`).

Where the JAX package forces 512 host devices, lowers and compiles each
step and reads XLA's memory and cost analysis, the port runs its own step
functions (`launch.steps`) on ``torch.device("meta")``: shapes and dtypes
only, no allocation. Per pair it reports

  * the per-device argument bytes, from the logical-axis sharding rules
    (`launch.shardings`): each dimension divided by the product of its
    mesh axes and rounded up, as XLA pads;
  * the step's temporaries, the peak of the storage bytes live at once in
    the trace less its arguments (`roofline.analysis.trace_facts`),
    traced at the per-device batch (the global batch over the rules'
    batch axes). Activations are not split over "model", so under tensor
    parallelism this is an upper bound; on a one-card mesh it is the
    step's own;
  * the FLOPs of the traced products (``traced_flops``: one device's, at
    the per-device batch with the weights whole), and the analytic FLOPs
    and bytes of the whole step over all devices (`roofline.analytic`);
  * the collectives one device issues, by kind, counted by a second,
    sharded trace (`_trace_collectives`): the same step at the global
    batch, run as one SPMD program on DTensors placed by the rules over
    a fake process group of the mesh's size (`launch.mesh.fake_mesh`),
    PyTorch's partitioner issuing the collectives
    (`roofline.analysis.collective_bytes_from_trace`, the counterpart of
    the JAX package's count of XLA's HLO);
  * the roofline terms, compute, memory and collective, priced at an
    H100's data-sheet peaks (`roofline.analysis.roofline_terms`): the
    whole step's FLOPs and bytes at all the cards' rates, one device's
    collective bytes at the rate of the links that each mesh axis's group
    crosses (`roofline.analysis.collective_seconds`: NVLink within an
    8-card node, its InfiniBand ports between nodes, `launch.mesh`).

The production meshes, (16, 16) and (2, 16, 16) (`launch.mesh`), are read
as 256 and 512 H100s; `lower_pair` on `launch.mesh.make_local_mesh()` is
one card, which issues no collective. The figures are predictions, not
measurements.

Unlike every other entry point of the port, the dry run does not default
to the card: every tensor it makes is on the meta device, on any host,
with or without CUDA. It never touches a card and never falls back to
one; the process group it opens is a fake one of its own, never a real
one (`fake_mesh` refuses to run beside one).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --proof-only   # no sharded trace
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import types

import torch

from repro_torch import spmd
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.masked_adam import FlatMaskedAdam, ShardedMaskedAdam
from repro_torch.launch import input_specs as ispec
from repro_torch.launch.mesh import HBM_BYTES, fake_mesh, make_production_mesh
from repro_torch.launch.shardings import placements_for, rules_for, shard_tree
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models.registry import build
from repro_torch.roofline import analysis
from repro_torch.roofline.analytic import ShapeSpec, analytic_cost

OPTS = ("grad_shard", "m_bf16", "window_slice", "attn_dp", "moe_shard", "decode_ep")
OPTIMIZED = frozenset(["m_bf16", "window_slice", "moe_shard", "decode_ep"])


def _shape(shape) -> tuple[str, dict]:
    """(name, dict) of an `input_specs.INPUT_SHAPES` name, or of a dict
    with ``kind``, ``seq_len`` and ``global_batch`` (and optionally
    ``cache_len`` for a prefill, ``mem_len`` for a memory)."""
    if isinstance(shape, str):
        return shape, dict(ispec.INPUT_SHAPES[shape])
    shp = dict(shape)
    if shp["kind"] not in ("train", "prefill", "decode", "decode_long"):
        raise ValueError(f"unknown step kind {shp['kind']!r}")
    return f"{shp['kind']}_{shp['global_batch']}x{shp['seq_len']}", shp


def resolve_cfg(arch: str, shape, mesh=None):
    _, shp = _shape(shape)
    cfg = get_config(arch)
    variant = "native"
    if shp["global_batch"] > 1 and mesh is not None:
        batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        cfg = cfg.replace(act_sharding=batch_axes)
    if shp["kind"] == "decode_long":
        # long-context policy: sub-quadratic required; dense full-attention
        # archs run the sliding-window variant (window 8,192)
        if not any(k in ("mamba", "rwkv") for k in cfg.pattern) and not cfg.window_size:
            cfg = cfg.replace(attn_window_override=8192)
            variant = "swa_500k"
    return cfg, variant


def _axes(entry) -> tuple:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def shard_bytes(shape, dtype: torch.dtype, spec, mesh) -> int:
    """One device's bytes of a (shape, dtype) array under partition spec
    ``spec``: each dimension over the product of its mesh axes, rounded
    up."""
    sizes = mesh.axis_sizes()
    n = 1
    for i, dim in enumerate(shape):
        parts = math.prod(sizes[a] for a in _axes(spec[i])) if i < len(spec) else 1
        n *= -(-dim // parts)
    return n * dtype.itemsize


def tree_shard_bytes(tensors, specs, mesh, dtype=None) -> int:
    """`shard_bytes` summed over a nest of dicts of tensors and its
    same-structure nest of specs (each leaf in ``dtype`` where given, else
    its own)."""
    if isinstance(tensors, torch.Tensor):
        return shard_bytes(tensors.shape, dtype or tensors.dtype, specs, mesh)
    if tensors.keys() != specs.keys():
        raise ValueError(f"tensors and specs differ in keys: {sorted(tensors)}, "
                         f"{sorted(specs)}")
    return sum(tree_shard_bytes(tensors[k], specs[k], mesh, dtype) for k in tensors)


def _per_device_batch(global_batch: int, rules: dict, mesh) -> int:
    sizes = mesh.axis_sizes()
    return -(-global_batch // math.prod(sizes[a] for a in _axes(rules.get("batch"))))


def _rules(cfg, mesh, kind: str, opts: frozenset) -> dict:
    return rules_for(cfg, mesh, shape_kind=kind,
                     attn_dp="attn_dp" in opts and kind in ("train", "prefill"),
                     moe_shard="moe_shard" in opts and kind in ("train", "prefill"),
                     decode_ep="decode_ep" in opts)


def _trace_step(cfg, mesh, shp: dict, opts: frozenset, *, clip: float = 0.0) -> dict:
    """Trace one step of ``cfg`` at ``shp`` on meta tensors, at the
    per-device batch under the mesh's rules. Returns `trace_facts`'s
    numbers (without the step's output), the per-device argument bytes by
    part, and the per-device batch."""
    kind = shp["kind"]
    model = build(cfg)
    rules = _rules(cfg, mesh, kind, opts)
    pspecs = model.pspecs(rules)
    B, S = shp["global_batch"], shp["seq_len"]
    b = _per_device_batch(B, rules, mesh)
    mem_len = shp.get("mem_len") or cfg.num_xattn_tokens
    params = model.abstract()
    parts = {"params": tree_shard_bytes(params, pspecs, mesh)}

    if kind == "train":
        m_dtype = torch.bfloat16 if "m_bf16" in opts else torch.float32
        # the flat optimizer keeps g (param dtype), m, v and u (float32)
        # and the mask (bool) beside the params, and the step count
        parts["opt_state"] = sum(tree_shard_bytes(params, pspecs, mesh, dt) for dt in
                                 (cfg.pdtype, m_dtype, torch.float32, torch.float32)) + 4
        parts["mask"] = tree_shard_bytes(params, pspecs, mesh, torch.bool)
        parts["inputs"] = tree_shard_bytes(ispec.train_inputs(cfg, B, S, mem_len),
                                           ispec.train_input_pspecs(cfg, rules), mesh)
        state = FlatMaskedAdam(params, m_dtype=m_dtype)
        step = make_train_step(model, clip=clip)
        args = (state, ispec.train_inputs(cfg, b, S, mem_len))
    elif kind == "prefill":
        batch = ispec.train_inputs(cfg, B, S, mem_len)
        bspecs = ispec.train_input_pspecs(cfg, rules)
        batch.pop("labels")
        bspecs.pop("labels")
        parts["inputs"] = tree_shard_bytes(batch, bspecs, mesh)
        step = make_prefill_step(model, cache_len=shp.get("cache_len") or S)
        local = ispec.train_inputs(cfg, b, S, mem_len)
        local.pop("labels")
        args = (params, local)
    else:  # decode / decode_long
        parts["caches"] = tree_shard_bytes(model.abstract_cache(B, S, mem_len=mem_len),
                                           model.cache_pspecs(B, S, rules, mem_len=mem_len),
                                           mesh)
        parts["inputs"] = tree_shard_bytes(
            {"tokens": ispec.decode_inputs(cfg, B, S - 1)["tokens"]},
            {"tokens": ispec.decode_input_pspecs(cfg, rules)["tokens"]}, mesh)
        step = make_serve_step(model)
        args = (params, model.abstract_cache(b, S, mem_len=mem_len),
                ispec.decode_inputs(cfg, b, S - 1))
    del params
    facts = analysis.trace_facts(step, *args)
    facts.pop("out")
    return dict(facts, parts=parts, local_batch=b)


def _trace_collectives(cfg, mesh, shp: dict, opts: frozenset, *,
                       clip: float = 0.0) -> dict:
    """The collectives of one step of ``cfg`` at ``shp`` on ``mesh``, as
    `roofline.analysis.collective_bytes_from_trace` counts them, by kind
    and by mesh axis (with their time at the links, `_by_axis`), and the
    trace's seconds and operations: `sharded_step` on meta tensors over a
    fake device mesh of ``mesh``'s shape (`launch.mesh.fake_mesh`). A
    one-device mesh issues no collective and is not traced."""
    zero = {k: 0 for k in analysis._COLLECTIVES}
    if mesh.size == 1:
        return {"totals": dict(zero), "counts": dict(zero), "sum": 0, "axes": {},
                "link_s": 0.0, "seconds": 0.0, "ops": 0}
    t0 = time.time()
    with fake_mesh(mesh) as dmesh:
        run = sharded_step(cfg, mesh, dmesh, shp, opts, clip=clip)
        trace = analysis.CollectiveTrace()
        with run.layout, trace:
            run.step()
        out = trace.result()
        axes, link_s = _by_axis(trace.by_group, dmesh)
    return dict(out, axes=axes, link_s=link_s, seconds=time.time() - t0, ops=trace.ops)


def sharded_step(cfg, mesh, dmesh, shp: dict, opts: frozenset = frozenset(), *,
                 clip: float = 0.0, values: dict | None = None, clock=None):
    """One step of ``cfg`` at ``shp``, the one `_trace_step` traces, as
    one SPMD program on DTensors over ``dmesh`` (a `DeviceMesh` of
    ``mesh``'s shape), at the global batch: params (and for training the
    optimizer's state) placed by the rules, inputs by their input specs,
    decode caches by their cache specs. The train step's optimizer steps
    each leaf's shard (`core.masked_adam.ShardedMaskedAdam`); the
    prefill's outputs are placed as the JAX package's jit places them
    (its out shardings: logits over batch and vocab, the caches by their
    specs).

    Without ``values`` every local shard is an empty meta tensor (the dry
    run's trace). ``values`` holds the global tensors to distribute
    instead (`launch.shardings.shard_tree`): ``params``, ``batch`` (as
    `launch.input_specs` lays it out, with a decode's ``pos``), for
    training ``mask`` (the params' tree), for decoding ``caches``.
    ``clock`` is the train step's (`launch.steps.make_train_step`).

    Returns a namespace: ``step()`` runs the step, within the context
    ``layout`` (`spmd.weights_at_use`: a train or prefill step gathers
    each group's FSDP shards where it runs; a decode step's few tokens
    move instead, as DTensor chooses, where XLA gathers the weights:
    ROADMAP F18); ``params``, ``state`` (training), ``caches``
    (decoding)."""
    kind = shp["kind"]
    model = build(cfg)
    rules = _rules(cfg, mesh, kind, opts)
    pspecs = model.pspecs(rules)
    B, S = shp["global_batch"], shp["seq_len"]
    mem_len = shp.get("mem_len") or cfg.num_xattn_tokens
    values = values or {}
    params = shard_tree(values.get("params", model.abstract()), pspecs, dmesh,
                        requires_grad=kind == "train")
    run = types.SimpleNamespace(params=params, state=None, caches=None)
    if kind == "train":
        m_dtype = torch.bfloat16 if "m_bf16" in opts else torch.float32
        run.state = ShardedMaskedAdam(params, m_dtype=m_dtype)
        if "mask" in values:
            run.state.set_mask(shard_tree(values["mask"], pspecs, dmesh))
        batch = shard_tree(values.get("batch", ispec.train_inputs(cfg, B, S, mem_len)),
                           ispec.train_input_pspecs(cfg, rules), dmesh)
        train = make_train_step(model, clip=clip, clock=clock)

        def step():
            return train(run.state, batch)
    elif kind == "prefill":
        bspecs = ispec.train_input_pspecs(cfg, rules)
        bspecs.pop("labels")
        batch = values.get("batch") or ispec.train_inputs(cfg, B, S, mem_len)
        batch = shard_tree({k: v for k, v in batch.items() if k != "labels"}, bspecs, dmesh)
        cache_len = shp.get("cache_len") or S
        prefill = make_prefill_step(model, cache_len=cache_len)
        cache_specs = model.cache_pspecs(B, cache_len, rules, mem_len=mem_len)
        logit_spec = (rules.get("batch"), None, rules.get("vocab"))

        def step():
            logits, caches = prefill(params, batch)
            return (logits.redistribute(placements=placements_for(logit_spec, dmesh)),
                    _place_tree(caches, cache_specs, dmesh))
    else:  # decode / decode_long
        run.caches = shard_tree(values.get("caches",
                                           model.abstract_cache(B, S, mem_len=mem_len)),
                                model.cache_pspecs(B, S, rules, mem_len=mem_len), dmesh)
        batch = shard_tree(values.get("batch", ispec.decode_inputs(cfg, B, S - 1)),
                           ispec.decode_input_pspecs(cfg, rules), dmesh)
        serve = make_serve_step(model)
        tok_spec = (rules.get("batch"), None)

        def step():
            tok, caches_out, logits = serve(params, run.caches, batch)
            return (tok.redistribute(placements=placements_for(tok_spec, dmesh)),
                    caches_out, logits)
    run.step = step
    run.layout = (spmd.weights_at_use(_use_layout(model, rules, dmesh))
                  if kind in ("train", "prefill") else contextlib.nullcontext())
    return run


def _by_axis(by_group: dict, dmesh) -> tuple[dict, float]:
    """A trace's collective bytes by the mesh axis whose group carried
    them, and their time at the links that group crosses
    (`roofline.analysis.collective_seconds`, rank 0's group). A group that
    is no axis of the mesh raises."""
    import torch.distributed as dist

    groups = {dmesh.get_group(i).group_name: (name, dist.get_process_group_ranks(
        dmesh.get_group(i))) for i, name in enumerate(dmesh.mesh_dim_names)}
    axes, link_s = {}, 0.0
    for group, nbytes in by_group.items():
        if group not in groups:
            raise NotImplementedError(f"a collective over group {group!r}, no axis of "
                                      f"the mesh {dmesh.mesh_dim_names}")
        name, ranks = groups[group]
        axes[name] = axes.get(name, 0) + nbytes
        link_s += analysis.collective_seconds(nbytes, ranks)
    return axes, link_s


FSDP_AXES = ("embed", "expert_embed", "attn_embed")
BATCH_AXES = ("pod", "data")


def _use_layout(model, rules: dict, dmesh):
    """The layout in which a step uses its weights (`spmd.at_use`): the
    rules' FSDP axes (`FSDP_AXES`) without their batch mesh axes, so each
    group's weights are all-gathered over "data" (and "pod") where the
    group runs (again in a remat recompute), as XLA's scan gathers them,
    and their gradients reduce-scattered back; the tensor-parallel shards
    over "model" stay."""
    use = dict(rules)
    for ax in FSDP_AXES:
        rest = tuple(a for a in _axes(rules.get(ax)) if a not in BATCH_AXES)
        use[ax] = rest[0] if len(rest) == 1 else (rest or None)
    specs = model.pspecs(use)

    def unstack(t):  # a group's leaves: the stacked specs without "layers"
        return {k: unstack(v) for k, v in t.items()} if isinstance(t, dict) else t[1:]

    parts = {"groups": unstack(specs["groups"]), "embed": specs["embed"],
             "shared_attn": specs.get("shared_attn")}
    if "encoder" in specs:
        parts["encoder"] = unstack(specs["encoder"]["groups"]["b0"])
    return lambda params, part: _place_tree(params, parts[part], dmesh)


def _place_tree(tensors, specs, dmesh):
    """Each DTensor of a nest of dicts redistributed to its spec's
    placements (a jit's out shardings)."""
    if isinstance(tensors, dict):
        return {k: _place_tree(tensors[k], specs[k], dmesh) for k in tensors}
    return tensors.redistribute(placements=placements_for(specs, dmesh))


def lower_pair(arch: str, shape, mesh, *, verbose: bool = True, proof_only: bool = False,
               cfg_override=None, opts: frozenset = frozenset(),
               clip: float = 0.0) -> dict:
    """Trace one (architecture, shape) pair on ``mesh`` (a
    `launch.mesh.MeshShape`) and return its facts (the JAX package's keys
    where they have a counterpart; ``trace_s`` for ``compile_s``,
    ``traced_flops`` for ``hlo_flops_scan_once``). ``shape`` is a name of
    `input_specs.INPUT_SHAPES` or a dict (`_shape`). ``cfg_override``
    replaces the resolved config; ``opts`` are the JAX package's levers
    (`OPTS`; ``grad_shard`` is an XLA layout hint and changes nothing
    here); ``clip`` clips the train step's gradients, as the trainer
    does.

    The collective term comes from the sharded trace
    (`_trace_collectives`): ``collective_bytes``, ``collective_counts``
    and ``collective_totals`` as the JAX package fills them from XLA's
    HLO, ``collective_trace_s`` and ``collective_ops`` its seconds and
    operations. ``proof_only`` leaves that trace out (the JAX CLI's
    "skip the count compiles"): the collective facts are then None and
    the roofline has no collective term (``t_collective_s`` None; the
    bottleneck and the step-time bound are those of compute and
    memory), never a term priced at 0."""
    name, shp = _shape(shape)
    cfg, variant = resolve_cfg(arch, shp, mesh)
    if cfg_override is not None:
        cfg = cfg_override
    if "window_slice" in opts:
        cfg = cfg.replace(decode_window_slicing=True)
    chips = mesh.size

    t0 = time.time()
    tr = _trace_step(cfg, mesh, shp, opts, clip=clip)
    trace_s = time.time() - t0

    ana = analytic_cost(cfg, ShapeSpec(kind=shp["kind"], seq_len=shp["seq_len"],
                                       global_batch=shp["global_batch"]))
    arg = sum(tr["parts"].values())
    temp = tr["peak_bytes"] - tr["arg_bytes"]
    facts = {
        "arch": arch, "shape": name, "variant": variant, "opts": sorted(opts),
        "mesh": "x".join(map(str, mesh.shape)), "chips": chips,
        "trace_s": round(trace_s, 2),
        "flops": ana["flops"], "bytes": ana["bytes"], "model_flops": ana["model_flops"],
        "traced_flops": tr["traced_flops"], "traced_ops": tr["ops"],
        "local_batch": tr["local_batch"],
        "device_arg_bytes": arg, "device_arg_parts": tr["parts"],
        "device_temp_bytes": temp, "device_peak_bytes": arg + temp,
        "fits_h100": arg + temp <= HBM_BYTES,
        "trace_arg_bytes": tr["arg_bytes"], "trace_peak_bytes": tr["peak_bytes"],
        "collective_bytes": None, "collective_counts": None, "collective_totals": None,
        "collective_axes": None,
    }
    if proof_only:
        facts.update(analysis.roofline_terms(facts["flops"], facts["bytes"], 0.0, chips))
        facts["t_collective_s"] = None
    else:
        coll = _trace_collectives(cfg, mesh, shp, opts, clip=clip)
        facts.update({
            "collective_bytes": float(coll["sum"]),
            "collective_counts": coll["counts"],
            "collective_totals": coll["totals"],
            "collective_axes": coll["axes"],
            "collective_trace_s": round(coll["seconds"], 2),
            "collective_ops": coll["ops"],
        })
        facts.update(analysis.roofline_terms(facts["flops"], facts["bytes"],
                                             facts["collective_bytes"], chips,
                                             collective_s=coll["link_s"]))
    facts["useful_flops_ratio"] = (
        facts["model_flops"] / facts["flops"] if facts["flops"] else 0.0
    )

    if verbose:
        print(f"[{arch} | {name} | mesh {facts['mesh']} | {variant}] "
              f"trace {facts['trace_s']}s ({tr['ops']:,} ops at batch "
              f"{tr['local_batch']}) bottleneck={facts['bottleneck']}")
        if proof_only:
            coll, t_n = "not traced", "not traced"
        else:
            coll = f"{facts['collective_bytes']:.3e}"
            t_n = f"{facts['t_collective_s']*1e3:.2f}"
        print(f"  flops={facts['flops']:.3e} bytes={facts['bytes']:.3e} coll={coll} "
              f"traced_flops={tr['traced_flops']:.3e} t=(c {facts['t_compute_s']*1e3:.2f} | m "
              f"{facts['t_memory_s']*1e3:.2f} | n {t_n}) ms "
              f"useful={facts['useful_flops_ratio']:.2f}")
        if not proof_only and chips > 1:
            print(f"  collectives: {facts['collective_counts']}, bytes by axis "
                  f"{facts['collective_axes']}, traced in "
                  f"{facts['collective_trace_s']}s ({facts['collective_ops']:,} ops)")
        print(f"  per-device: args {arg/2**30:.2f} GiB, temps {temp/2**30:.2f} GiB, "
              f"peak {(arg + temp)/2**30:.2f} GiB, fits an H100: {facts['fits_h100']}")
    return facts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(ispec.INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--proof-only", action="store_true",
                    help="skip the sharded trace that counts the collectives")
    ap.add_argument("--json", default=None, help="append results (json-lines)")
    ap.add_argument("--opt", action="append", default=[], choices=list(OPTS),
                    help="levers (repeatable)")
    ap.add_argument("--optimized", action="store_true",
                    help="enable the validated levers")
    args = ap.parse_args(argv)
    opts = OPTIMIZED if args.optimized else frozenset(args.opt)

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in ispec.INPUT_SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    ok, fail, rows = 0, [], []
    t0 = time.time()
    for arch, shape in pairs:
        try:
            facts = lower_pair(arch, shape, mesh, proof_only=args.proof_only, opts=opts)
            ok += 1
            rows.append(facts)
            if args.json:
                with open(args.json, "a") as f:
                    f.write(json.dumps(facts) + "\n")
        except Exception as e:  # noqa: BLE001
            fail.append((arch, shape, repr(e)[:300]))
            print(f"[{arch} | {shape}] FAILED: {e}", file=sys.stderr)
    print(f"\nper device on mesh {'x'.join(map(str, mesh.shape))} ({mesh.size} H100s; "
          f"predictions at the data sheet's peaks, not measurements):")
    print(f"{'arch':28s} {'shape':12s} {'args GiB':>9s} {'temps GiB':>9s} "
          f"{'peak GiB':>9s} {'fits':>5s} {'coll GB':>9s} {'bottleneck':>10s} "
          f"{'trace s':>8s} {'coll s':>8s}")
    for r in rows:
        coll = ("-" if r["collective_bytes"] is None
                else f"{r['collective_bytes']/1e9:9.2f}")
        print(f"{r['arch']:28s} {r['shape']:12s} {r['device_arg_bytes']/2**30:9.2f} "
              f"{r['device_temp_bytes']/2**30:9.2f} {r['device_peak_bytes']/2**30:9.2f} "
              f"{str(r['fits_h100']):>5s} {coll:>9s} {r['bottleneck']:>10s} "
              f"{r['trace_s']:8.2f} {r.get('collective_trace_s', 0.0):8.2f}")
    print(f"\ndry-run: {ok} ok, {len(fail)} failed in {time.time() - t0:.1f} s")
    for f in fail:
        print("  FAIL", *f)
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
