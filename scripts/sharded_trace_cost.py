"""What the dry run's sharded trace costs one device, pair by pair.

For each (architecture, shape) on a production mesh, `launch.dryrun`'s
sharded step is traced on meta tensors over a fake process group of the
mesh's shape, as `lower_pair` counts its collectives, and one JSON line
is printed: the collective result bytes of one device (`sum`), the FLOPs
the trace counted on one device's local shards (`flops`), the peak of its
live local storages (`peak`, bytes) and the trace's seconds. Nothing runs
on a card.

    PYTHONPATH=src python scripts/sharded_trace_cost.py --arch mixtral_8x22b \\
        [--shapes train_4k,prefill_32k,decode_32k] [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import time


def trace_cost(arch: str, shape: str, multi_pod: bool) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import input_specs as ispec
    from repro_torch.launch.mesh import fake_mesh, make_production_mesh
    from repro_torch.roofline import analysis

    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    with fake_mesh(mesh) as dmesh:
        run = dryrun.sharded_step(get_config(arch), mesh, dmesh, ispec.INPUT_SHAPES[shape])
        trace = analysis.CollectiveTrace()
        with run.layout, trace:
            run.step()
        out = trace.result()
    return dict(arch=arch, shape=shape, mesh="x".join(map(str, mesh.shape)), sum=out["sum"],
                flops=trace.flops, peak=trace.peak, s=round(time.time() - t0, 1))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shapes", default="train_4k,prefill_32k,decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    for shape in args.shapes.split(","):
        print(json.dumps(trace_cost(args.arch, shape, args.multi_pod)), flush=True)


if __name__ == "__main__":
    main()
