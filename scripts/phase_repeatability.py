"""How often the student's fused phase is not repeatable bit for bit on the
card, for one or more checkouts of the repo.

    python3 scripts/phase_repeatability.py [--reps N] [TREE]

Each repetition runs one phase of the width-1.0 student (K = 3, batches
of 4 frames of 32x32) through the eager loop twice and its CUDA graph
twice, at B = 3 and B = 8, with the card test's own helpers
(``tests/test_torch_kernels_cuda.py`` of TREE, default the repo's root),
and counts the runs whose four outputs are not equal bit for bit. Run one
process per tree, in turns, to compare two trees on one card. Needs one
card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("tree", nargs="?", default=str(Path(__file__).resolve().parents[1]))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("phase_repeatability: needs one NVIDIA GPU")
    sys.path[:0] = [f"{a.tree}/src", f"{a.tree}/tests"]
    import test_torch_kernels_cuda as T
    from repro_torch.core import batched

    dev = torch.device("cuda", 0)
    fails = 0
    for rep in range(a.reps):
        for b in (3, 8):
            batched.cache_clear()
            lg, args = T._phase_inputs(dev, b)
            loop, graph = T._runner(lg, args, "loop"), T._runner(lg, args, "graph")
            outs = [loop(*args), loop(*args), graph(*args), graph(*args)]
            torch.cuda.synchronize()
            same = [T._bitwise(o, outs[0]) for o in outs[1:]]
            fails += not all(same)
            print(f"{a.tree} rep {rep} B={b}: loop2, graph, graph2 equal to loop bit for "
                  f"bit: {same}", flush=True)
    print(f"{a.tree}: {fails} of {2 * a.reps} runs not repeatable")


if __name__ == "__main__":
    main()
