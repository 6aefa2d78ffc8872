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
    and bytes of the whole step over all devices priced at an H100's
    data-sheet peaks (`roofline.analytic`,
    `roofline.analysis.roofline_terms`; no collective bytes until the
    port runs sharded, ROADMAP §1 item 5).

The production meshes, (16, 16) and (2, 16, 16) (`launch.mesh`), are read
as 256 and 512 H100s; `lower_pair` on `launch.mesh.make_local_mesh()` is
one card. The figures are predictions, not measurements.

Unlike every other entry point of the port, the dry run does not default
to the card: every tensor it makes is on the meta device, on any host,
with or without CUDA. It never touches a card and never falls back to
one.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.jsonl]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.masked_adam import FlatMaskedAdam
from repro_torch.launch import input_specs as ispec
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.launch.shardings import rules_for
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


def _trace_step(cfg, mesh, shp: dict, opts: frozenset, *, clip: float = 0.0) -> dict:
    """Trace one step of ``cfg`` at ``shp`` on meta tensors, at the
    per-device batch under the mesh's rules. Returns `trace_facts`'s
    numbers (without the step's output), the per-device argument bytes by
    part, and the per-device batch."""
    kind = shp["kind"]
    model = build(cfg)
    rules = rules_for(cfg, mesh, shape_kind=kind,
                      attn_dp="attn_dp" in opts and kind in ("train", "prefill"),
                      moe_shard="moe_shard" in opts and kind in ("train", "prefill"),
                      decode_ep="decode_ep" in opts)
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


def lower_pair(arch: str, shape, mesh, *, verbose: bool = True, cfg_override=None,
               opts: frozenset = frozenset(), clip: float = 0.0) -> dict:
    """Trace one (architecture, shape) pair on ``mesh`` (a
    `launch.mesh.MeshShape`) and return its facts (the JAX package's keys
    where they have a counterpart; ``trace_s`` for ``compile_s``,
    ``traced_flops`` for ``hlo_flops_scan_once``). ``shape`` is a name of
    `input_specs.INPUT_SHAPES` or a dict (`_shape`). ``cfg_override``
    replaces the resolved config; ``opts`` are the JAX package's levers
    (`OPTS`; ``grad_shard`` is an XLA layout hint and changes nothing
    here); ``clip`` clips the train step's gradients, as the trainer
    does."""
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
        # no sharded execution yet (ROADMAP §1 item 5)
        "collective_bytes": None,
        "collective_note": "no counterpart until the port runs sharded",
    }
    facts.update(analysis.roofline_terms(facts["flops"], facts["bytes"], 0.0, chips))
    facts["useful_flops_ratio"] = (
        facts["model_flops"] / facts["flops"] if facts["flops"] else 0.0
    )

    if verbose:
        print(f"[{arch} | {name} | mesh {facts['mesh']} | {variant}] "
              f"trace {facts['trace_s']}s ({tr['ops']:,} ops at batch "
              f"{tr['local_batch']}) bottleneck={facts['bottleneck']}")
        print(f"  flops={facts['flops']:.3e} bytes={facts['bytes']:.3e} "
              f"traced_flops={tr['traced_flops']:.3e} t=(c {facts['t_compute_s']*1e3:.2f} | m "
              f"{facts['t_memory_s']*1e3:.2f}) ms useful={facts['useful_flops_ratio']:.2f}")
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
                    help="the JAX CLI's flag; nothing to skip here (no count compiles)")
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
            facts = lower_pair(arch, shape, mesh, opts=opts)
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
          f"{'peak GiB':>9s} {'fits':>5s} {'bottleneck':>10s} {'trace s':>8s}")
    for r in rows:
        print(f"{r['arch']:28s} {r['shape']:12s} {r['device_arg_bytes']/2**30:9.2f} "
              f"{r['device_temp_bytes']/2**30:9.2f} {r['device_peak_bytes']/2**30:9.2f} "
              f"{str(r['fits_h100']):>5s} {r['bottleneck']:>10s} {r['trace_s']:8.2f}")
    print(f"\ndry-run: {ok} ok, {len(fail)} failed in {time.time() - t0:.1f} s")
    for f in fail:
        print("  FAIL", *f)
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
