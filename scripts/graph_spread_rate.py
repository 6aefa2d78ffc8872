"""How often the card test `test_graph_phase_on_the_student_within_the_eager_spread`
fails by chance, for one or more checkouts of the repo.

    python3 scripts/graph_spread_rate.py [--reps N] [TREE ...]

The student's backward is not deterministic on the card (atomics), so the
test holds a CUDA-graph phase to 3x the largest share of parameters more
than one fp16 ulp apart between two of three eager runs. This script
repeats that comparison ``--reps`` times at B = 3 and B = 8 with the
test's own helpers (``tests/test_torch_kernels_cuda.py`` of each TREE,
default the repo's root) and prints each ratio and the count of
failures. Run one process per tree, in turns, to compare two trees on
one card. Needs one card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch


def share(tree, fp16_ulps, x, y) -> float:
    d = torch.cat([fp16_ulps(a, c).reshape(-1)
                   for a, c in zip(tree.leaves(x[0]), tree.leaves(y[0]))])
    return float((d > 1).float().mean())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("tree", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("graph_spread_rate: needs one NVIDIA GPU")
    sys.path[:0] = [f"{a.tree}/src", f"{a.tree}/tests"]
    import test_torch_kernels_cuda as T
    from repro_torch import tree
    from repro_torch.core import batched

    dev = torch.device("cuda", 0)
    fails = 0
    for rep in range(a.reps):
        for b in (3, 8):
            batched.cache_clear()
            lg, args = T._phase_inputs(dev, b)
            loop, graph = T._runner(lg, args, "loop"), T._runner(lg, args, "graph")
            eager = [loop(*args) for _ in range(3)]
            g1 = graph(*args)
            torch.cuda.synchronize()
            spread = max(share(tree, T._fp16_ulps, eager[i], eager[j])
                         for i, j in ((0, 1), (0, 2), (1, 2)))
            got = share(tree, T._fp16_ulps, g1, eager[0])
            ok = got <= 3 * spread
            fails += not ok
            print(f"{a.tree} rep {rep} B={b}: graph vs eager {got:.3e}, spread {spread:.3e}, "
                  f"ratio {got / max(spread, 1e-30):.2f}, {'ok' if ok else 'FAIL'}", flush=True)
    print(f"{a.tree}: {fails} of {2 * a.reps} failed")


if __name__ == "__main__":
    main()
