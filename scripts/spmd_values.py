"""The port's sharded steps on values: one SPMD program over CPU processes.

The dry run counts the collectives of each step run as one SPMD program on
DTensors (`launch.dryrun.sharded_step`) over a fake process group, on meta
tensors, so its collectives move nothing. This runs the same program on
values: ``--world`` processes on this host in a gloo process group (a file
rendezvous in a temporary directory, gloo's transport on the loopback
device), a CPU device mesh of ``--mesh``'s shape over ("data", "model"),
float64 smoke weights and inputs from ``--seed``. Every rank runs each
architecture's train step (with a mask and a clip), its prefill, a decode
step and a batch-1 long-context decode step (the cache sharded over its
positions) and gathers the results (`DTensor.full_tensor`); rank 0 runs
the plain single-process steps on the same inputs and prints one JSON line
per (arch, step, output): the largest absolute difference and the largest
absolute value of the plain result.

    PYTHONPATH=src python scripts/spmd_values.py [--archs gemma2_9b,rwkv6_3b]

The MoE configs run twice: with a capacity of every token
(``capacity_factor`` = the number of experts) and, as the cases of
``CAPPED`` (named ``arch:capped``), at the config's own capacity factor,
where experts overflow. Each MoE layer's keep mask is recorded on both
sides (the sharded one gathered whole) and printed as one more output,
``keep``: the slots whose flag differs, and how many slots the single
process dropped. Their tokens are drawn from ``FEW`` ids (a repetitive
text), so that the routing is skewed and the train step and the prefill
drop slots too (at random tokens only the 4-token decode step does).

`tests/test_torch_spmd_values.py` runs it and holds the differences.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile

ARCHS = ("gemma2_9b", "mixtral_8x22b", "whisper_large_v3", "rwkv6_3b", "zamba2_7b")
CAPPED = ("mixtral_8x22b:capped", "moonshot_v1_16b_a3b:capped")
FEW = 4  # the token ids of a capped case's batch
B, S, CLIP = 4, 16, 0.5


def smoke_cfg(case: str):
    """The smoke config of a case: an architecture, or ``arch:capped``
    (a MoE one at its own capacity factor)."""
    from repro_torch.configs import get_smoke

    arch, _, capped = case.partition(":")
    # the Mamba2 scan holds its state in float32 and takes float32 or
    # bfloat16 weights only, so Zamba2 runs in float32
    dtype = "float32" if arch == "zamba2_7b" else "float64"
    cfg = get_smoke(arch, head_dim=64, remat=True, act_sharding=("data",),
                    param_dtype=dtype, compute_dtype=dtype)
    if cfg.num_experts and not capped:
        cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
    return cfg


def _record_keeps():
    """Have `models.moe._dispatch` record each call's keep mask (a
    sharded one gathered whole). Returns a function that returns the
    masks recorded since its last call."""
    from repro_torch.models import moe

    dispatch, seen = moe._dispatch, []

    def recording(cfg, x_flat, idx):
        out = dispatch(cfg, x_flat, idx)
        seen.append(_full(out[2]))
        return out

    def taken() -> list:
        got = list(seen)
        seen.clear()
        return got

    moe._dispatch = recording
    return taken


def _full(t):
    import torch

    from repro_torch import spmd

    if isinstance(t, dict):
        return {k: _full(v) for k, v in t.items()}
    if spmd.is_dtensor(t):
        return t.full_tensor().detach().clone()
    return t.detach().clone() if isinstance(t, torch.Tensor) else t


def _leaves_of(tree_):
    from repro_torch import tree

    return tree.leaves(tree_)


def _inputs(cfg, gen, batch: int, seq: int, vocab: int | None = None) -> dict:
    """Tokens (of the first ``vocab`` ids, all by default), labels and
    the cross-attention memory."""
    import torch

    toks = torch.randint(0, vocab or cfg.vocab_size, (batch, seq + 1), generator=gen,
                         dtype=torch.int64).to(torch.int32)
    out = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    if cfg.num_xattn_tokens:
        out["memory"] = 0.3 * torch.randn((batch, cfg.num_xattn_tokens, cfg.d_model),
                                          generator=gen, dtype=cfg.cdtype)
    return out


def _copy(t):
    return {k: _copy(v) for k, v in t.items()} if isinstance(t, dict) else t.detach().clone()


def run_rank(rank: int, world: int, mesh_shape: tuple, store: str, archs, seed: int):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree
    from repro_torch.core.masked_adam import FlatMaskedAdam
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models.registry import build

    torch.set_num_threads(1)
    _keeps = _record_keeps()
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    rows = []
    try:
        mesh = MeshShape(("data", "model"), mesh_shape)
        dmesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=mesh.axis_names)

        def report(arch, step, out, got, want):
            """One row per leaf of ``want`` (rank 0 only)."""
            for i, (a, b) in enumerate(zip(_leaves_of(got), _leaves_of(want), strict=True)):
                a, b = torch.as_tensor(a), torch.as_tensor(b)
                name = out if not isinstance(want, (dict, list)) else f"{out}[{i}]"
                if a.shape != b.shape:
                    raise AssertionError(f"{arch} {step} {name}: shapes "
                                         f"{tuple(a.shape)} and {tuple(b.shape)}")
                diff = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
                scale = b.double().abs().max().item() if b.numel() else 0.0
                rows.append(dict(arch=arch, step=step, out=name, max_abs=diff,
                                 scale=scale, dtype=str(b.dtype).replace("torch.", "")))

        def report_keep(arch, step, got, want):
            """One row for the MoE layers' keep masks (rank 0 only): the
            slots whose flag differs, of all, and those one process drops."""
            if len(got) != len(want):
                raise AssertionError(f"{arch} {step}: {len(got)} MoE dispatches "
                                     f"sharded, {len(want)} in one process")
            if want:
                a, b = torch.cat(got), torch.cat(want)
                rows.append(dict(arch=arch, step=step, out="keep",
                                 max_abs=int((a != b).sum()), scale=b.numel(),
                                 dropped=int((~b).sum()), dtype="bool"))

        for arch in archs:
            cfg = smoke_cfg(arch)
            model = build(cfg)
            gen = torch.Generator().manual_seed(seed)
            params = model.init(gen, device="cpu")
            mask = tree.tree_map(lambda p: torch.rand(p.shape, generator=gen) < 0.5, params)
            batch = _inputs(cfg, gen, B, S, FEW if arch in CAPPED else None)

            # train: the loss, each gradient before the clip, the clip's
            # norm, and the params after the masked Adam update (its
            # update u lies in per-shard flat buffers on the sharded side)
            seen = {}
            for sharded in (True, False):
                if not sharded and rank != 0:
                    break
                now = seen.setdefault(sharded, {})

                @contextlib.contextmanager
                def clock(stage, now=now):
                    yield
                    if stage == "forward_backward":
                        now["grads"] = [_full(leaf.grad) for leaf in leaves]
                        now["gn"] = _full(state.grad_norm())

                _keeps()
                if sharded:
                    run = dryrun.sharded_step(
                        cfg, mesh, dmesh, dict(kind="train", seq_len=S, global_batch=B),
                        clip=CLIP, clock=clock,
                        values=dict(params=_copy(params), batch=batch, mask=mask))
                    state, leaves = run.state, _leaves_of(run.params)
                    with run.layout:
                        _, loss = run.step()
                    now["params"] = _full(run.params)
                else:
                    state = FlatMaskedAdam(_copy(params), m_dtype=torch.float32)
                    state.set_mask(mask)
                    leaves = _leaves_of(state.params)
                    _, loss = make_train_step(model, clip=CLIP, clock=clock)(state, batch)
                    now["params"] = _copy(state.params)
                now["loss"] = _full(loss)
                now["keep"] = _keeps()
            if rank == 0:
                for key in ("loss", "gn", "grads", "params"):
                    report(arch, "train", key, seen[True][key], seen[False][key])
                report_keep(arch, "train", seen[True]["keep"], seen[False]["keep"])

            # prefill at S - 1 tokens into a cache of S positions, then one
            # decode step at position S - 1 from the plain prefill's caches
            pre = {k: v[:, :S - 1] if k != "memory" else v for k, v in batch.items()
                   if k != "labels"}
            shp = dict(kind="prefill", seq_len=S - 1, global_batch=B, cache_len=S)
            run = dryrun.sharded_step(cfg, mesh, dmesh, shp, values=dict(
                params=params, batch=pre))
            _keeps()
            with run.layout:
                logits, caches = run.step()
            got = dict(logits=_full(logits), caches=_full(caches), keep=_keeps())
            if rank == 0:
                want_logits, want_caches = make_prefill_step(model, cache_len=S)(params, pre)
                report(arch, "prefill", "logits", got["logits"], want_logits)
                report(arch, "prefill", "caches", got["caches"], want_caches)
                report_keep(arch, "prefill", got["keep"], _keeps())

            for kind, rows_b in (("decode", B), ("decode_long", 1)):
                # every rank needs the plain prefill's caches to shard them
                start = make_prefill_step(model, cache_len=S)(
                    params, {k: v[:rows_b] for k, v in pre.items()})[1]
                tok = batch["tokens"][:rows_b, S - 1:S].contiguous()
                step_in = {"tokens": tok, "pos": S - 1}
                shp = dict(kind=kind, seq_len=S, global_batch=rows_b)
                run = dryrun.sharded_step(cfg, mesh, dmesh, shp, values=dict(
                    params=params, batch=step_in, caches=_copy(start)))
                _keeps()
                with run.layout:
                    nxt, caches_out, logits = run.step()
                got = dict(tok=_full(nxt), logits=_full(logits), caches=_full(caches_out),
                           keep=_keeps())
                if rank == 0:
                    w_tok, w_caches, w_logits = make_serve_step(model)(
                        params, _copy(start), step_in)
                    report(arch, kind, "tok", got["tok"], w_tok)
                    report(arch, kind, "logits", got["logits"], w_logits)
                    report(arch, kind, "caches", got["caches"], w_caches)
                    report_keep(arch, kind, got["keep"], _keeps())
    finally:
        dist.destroy_process_group()
    if rank == 0:
        for r in rows:
            print(json.dumps(r), flush=True)


def run_world(archs=ARCHS + CAPPED, mesh_shape=(2, 2), seed: int = 0,
              timeout: float = 600) -> list:
    """Start the ranks, wait for them, and return rank 0's rows."""
    world = mesh_shape[0] * mesh_shape[1]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--world", str(world),
             "--mesh", ",".join(map(str, mesh_shape)), "--store", store,
             "--archs", ",".join(archs), "--seed", str(seed)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    bad = [(r, p.returncode, err[-4000:]) for r, (p, (_, err)) in
           enumerate(zip(procs, outs)) if p.returncode != 0]
    if bad:
        raise RuntimeError("ranks failed:\n" + "\n".join(
            f"rank {r} exit {rc}:\n{err}" for r, rc, err in bad))
    return [json.loads(line) for line in outs[0][0].splitlines() if line.startswith("{")]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", default=",".join(ARCHS + CAPPED))
    ap.add_argument("--mesh", default="2,2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank", type=int, default=None, help="run one rank (internal)")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--store", default=None)
    args = ap.parse_args()
    archs = tuple(args.archs.split(","))
    mesh_shape = tuple(int(x) for x in args.mesh.split(","))
    if args.rank is not None:
        run_rank(args.rank, args.world, mesh_shape, args.store, archs, args.seed)
        return
    for r in run_world(archs, mesh_shape, args.seed):
        print(json.dumps(r))


if __name__ == "__main__":
    main()
