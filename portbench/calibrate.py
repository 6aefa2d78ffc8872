#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the
card; the benchmark's own runs do not run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... --control 3

For each seed, in one process: the cell's weights and traffic drawn from
the seed, a warm call, then the port's calls at the cell's own batch and
sizes until they hold the comparison's sample (``--calls``, or as many as
the sample's requests need at `--rows` kept rows a call), and the
readings of `compare.readings`: the port's ``token_gap`` and
``logits_rel`` and, on the first ``--control`` seeds, the control's (the
reference in float8 in the port's place). One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import compare, harness  # noqa: E402


def main(argv=None, root=ROOT, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    ap.add_argument("--rows", type=int, default=None, help="kept rows a call")
    args = ap.parse_args(argv)
    if device == "cuda" and not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.Bench(root)
    check = bench.data("workloads", args.workload)["check"]
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        session = harness.Session(bench, args.workload, seed, device, rows_per_call=args.rows)
        try:
            session.call(-1)
            calls = [session.call(i) for i in range(math.ceil(
                check["requests"] / session.rows_per_call))]
            t1 = time.perf_counter()
            got = compare.readings(session, calls, check["requests"], check["ref_batch"],
                                   control=n < args.control)
        finally:
            session.close()
        got.update(seed=seed, workload=args.workload, calls=len(calls),
                   calls_s=t1 - t0, check_s=time.perf_counter() - t1,
                   finite=all(c.finite for c in calls))
        print(json.dumps(got), flush=True)
        del session, calls
        if device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
