"""The port's collective count against XLA's, on a small mesh, on the CPU.

For five smoke configs (head dim 64, remat on, activations over "data"),
the train and decode steps of the JAX package are compiled on a (2, 4)
mesh of eight forced host devices in a child process (a JAX process fixes
its device count at first use), and XLA's HLO is counted by the JAX
package's `collective_bytes_from_hlo`; the port's steps are traced on
DTensors over a fake process group of the same shape
(`repro_torch.launch.dryrun._trace_collectives`). Prints one line per
(arch, step): both sums, their ratio, and both sides' bytes and counts by
kind.

    PYTHONPATH=src python scripts/collectives_vs_xla.py

`tests/test_torch_collectives.py` runs the same compiles and traces (it
loads this file) and holds the ratios.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import textwrap

ARCHS = ("gemma2_9b", "mixtral_8x22b", "whisper_large_v3", "rwkv6_3b", "zamba2_7b")
MESH = (("data", "model"), (2, 4))
B, S = 4, 32
KINDS = ("train", "decode")

CHILD = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.configs import get_smoke
    from repro.core.masked_adam import MaskedAdamState
    from repro.launch import input_specs as ispec
    from repro.launch.shardings import rules_for
    from repro.launch.steps import make_serve_step, make_train_step
    from repro.models.registry import build

    out_dir, B, S = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    done = {}
    for arch in sys.argv[4].split(","):
        cfg = get_smoke(arch, head_dim=64, remat=True, act_sharding=("data",))
        model = build(cfg)
        for kind in ("train", "decode"):
            with jax.set_mesh(mesh):
                rules = rules_for(cfg, mesh, shape_kind=kind)
                pspecs, params = model.pspecs(rules), model.abstract()
                if kind == "train":  # as launch/dryrun.py:99-111 compiles it
                    f32 = lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32)
                    opt = MaskedAdamState(m=jax.tree.map(f32, params),
                                          v=jax.tree.map(f32, params),
                                          count=jax.ShapeDtypeStruct((), jnp.int32))
                    mask = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bool_),
                                        params)
                    opt_specs = MaskedAdamState(m=pspecs, v=pspecs, count=P())
                    bspecs = ispec.train_input_pspecs(cfg, rules)
                    jitted = jax.jit(make_train_step(model),
                                     in_shardings=(pspecs, opt_specs, pspecs, bspecs),
                                     out_shardings=(pspecs, opt_specs, pspecs, P()))
                    lowered = jitted.lower(params, opt, mask, ispec.train_inputs(cfg, B, S))
                else:
                    caches = model.abstract_cache(B, S, mem_len=cfg.num_xattn_tokens)
                    cspecs = model.cache_pspecs(B, S, rules, mem_len=cfg.num_xattn_tokens)
                    jitted = jax.jit(make_serve_step(model),
                                     in_shardings=(pspecs, cspecs,
                                                   ispec.decode_input_pspecs(cfg, rules)),
                                     out_shardings=(P(rules.get("batch"), None), cspecs))
                    lowered = jitted.lower(params, caches, ispec.decode_inputs(cfg, B))
                path = os.path.join(out_dir, f"{arch}.{kind}.hlo")
                with open(path, "w") as f:
                    f.write(lowered.compile().as_text())
                done[f"{arch}.{kind}"] = path
    print(json.dumps(done))
''')


def start_xla(out_dir: str, archs=ARCHS) -> subprocess.Popen:
    """Start the child that compiles the JAX steps into ``out_dir``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", CHILD, out_dir, str(B), str(S), ",".join(archs)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def xla_texts(proc: subprocess.Popen, timeout: float = 600) -> dict:
    """{"arch.kind": XLA's compiled HLO text} once the child is done."""
    stdout, stderr = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX compiles failed:\n{stderr[-3000:]}")
    texts = {}
    for key, path in json.loads(stdout.strip().splitlines()[-1]).items():
        with open(path) as f:
            texts[key] = f.read()
    return texts


def smoke_cfg(arch: str):
    from repro_torch.configs import get_smoke

    return get_smoke(arch, head_dim=64, remat=True, act_sharding=("data",))


def port_count(arch: str, kind: str) -> dict:
    """The port's count of one smoke step on the (2, 4) mesh."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape

    return dryrun._trace_collectives(smoke_cfg(arch), MeshShape(*MESH),
                                     dict(kind=kind, seq_len=S, global_batch=B),
                                     frozenset())


def main() -> None:
    from repro.roofline.analysis import collective_bytes_from_hlo

    with tempfile.TemporaryDirectory() as out:
        proc = start_xla(out)
        port = {(a, k): port_count(a, k) for a in ARCHS for k in KINDS}
        xla = xla_texts(proc)
    print("arch step port_sum xla_sum ratio port_totals xla_totals port_counts xla_counts")
    for (arch, kind), got in port.items():
        ref = collective_bytes_from_hlo(xla[f"{arch}.{kind}"])
        print(arch, kind, got["sum"], ref["sum"], f"{got['sum'] / ref['sum']:.2f}",
              json.dumps(got["totals"]), json.dumps(ref["totals"]),
              json.dumps(got["counts"]), json.dumps(ref["counts"]))


if __name__ == "__main__":
    main()
