"""Which operations of the student's vmapped loss/grad are nondeterministic
on the card, and what the deterministic one costs.

    python3 scripts/determinism_probe.py [--reps N]

At the main path's shape (8 sessions of the width-4.0 student, 8 frames of
256x256 each, random init from seed 0, labels from seed 1), two versions
of the loss/grad: ``before``, the bilinear upsample as
``F.interpolate(align_corners=False)`` under the process's cuDNN settings
(the port up to ROADMAP F13's repair), and ``after``, the port's
``SegWorld.loss_and_grad`` (the upsample as two products with fixed
weight matrices, cuDNN's deterministic algorithms scoped to the call).
Also each half of the repair alone, and ``after`` with cuDNN's benchmark
mode on. For each: the operations that
``torch.use_deterministic_algorithms(True, warn_only=True)`` reports
during one call and whether it is repeatable under that mode; whether
three calls on the same inputs give the same gradients bit for bit
(outside the mode); and its time per call (CUDA events around
``--reps`` calls after a warm-up), in turns before, after, the halves,
after benchmarked, after, before. TF32 is off for matrix products and
convolutions, as in ``chip_smoke.py``. Needs one card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import warnings
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import tree  # noqa: E402
from repro_torch.core.batched import stack_trees  # noqa: E402
from repro_torch.models.seg import student  # noqa: E402
from repro_torch.sim.seg_world import SegWorld  # noqa: E402

SESSIONS, FRAMES, HW, WIDTH = 8, 8, 256, 4.0


@contextlib.contextmanager
def interpolate_upsample():
    """The student's upsample as it was: ``F.interpolate``."""
    kept = student.linear_resize
    student.linear_resize = lambda x, size: F.interpolate(
        x, size=size, mode="bilinear", align_corners=False)
    try:
        yield
    finally:
        student.linear_resize = kept


def versions(cfg):
    """``before``, ``after`` and the two halves of the repair alone:
    ``interpolate_cudnn_deterministic`` (only cuDNN's flags scoped) and
    ``products_cudnn_default`` (only the upsample as products); and
    ``after_benchmarked``, ``after`` with cuDNN's benchmark mode on (the
    fastest deterministic algorithm by a timed search per shape)."""
    def loss_and_grad(interpolate: bool, cudnn_deterministic: bool,
                      benchmark: bool = False):
        def one(params, frames, labels):
            flags = (torch.backends.cudnn.flags(enabled=True, benchmark=benchmark,
                                                deterministic=True, allow_tf32=False)
                     if cudnn_deterministic else contextlib.nullcontext())
            with flags:
                grads, loss = grad_and_value(
                    lambda p: student.seg_loss(cfg, p, frames, labels))(params)
            return loss, grads

        batched = vmap(one)

        def call(*args):
            with interpolate_upsample() if interpolate else contextlib.nullcontext():
                return batched(*args)

        return call

    return {"before": loss_and_grad(True, False),
            "interpolate_cudnn_deterministic": loss_and_grad(True, True),
            "products_cudnn_default": loss_and_grad(False, False),
            "after": vmap(SegWorld(video=None, teacher=None, seg_cfg=cfg).loss_and_grad),
            "after_benchmarked": loss_and_grad(False, True, benchmark=True)}


def under_the_mode(fn, args) -> dict:
    """Under `use_deterministic_algorithms(True, warn_only=True)`: the
    messages it warns with in one call, and whether three calls then give
    the same gradients (the mode also swaps in deterministic versions of
    some operations silently)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn(*args)
            torch.cuda.synchronize()
            bits = same_bits(fn, args)
        finally:
            torch.use_deterministic_algorithms(False)
    return {"flagged": sorted({str(w.message).split(". ")[0] for w in caught}),
            "bitwise_under_the_mode": bits["bitwise"]}


def same_bits(fn, args, calls: int = 3) -> dict:
    """How many of ``calls - 1`` repeat calls differ from the first in some
    gradient bit, and the shapes of the gradient leaves that ever differ."""
    outs = [tree.leaves(fn(*args)[1]) for _ in range(calls)]
    torch.cuda.synchronize()
    differ = [[i for i, (a, b) in enumerate(zip(outs[0], o))
               if not torch.equal(a.contiguous().view(torch.uint8),
                                  b.contiguous().view(torch.uint8))]
              for o in outs[1:]]
    ever = sorted(set().union(*differ))
    return {"bitwise": not ever, "repeats_differing": sum(bool(d) for d in differ),
            "of_repeats": calls - 1, "grad_leaves_differing": len(ever),
            "of_leaves": len(outs[0]),
            "leaves_differing": [list(outs[0][i].shape[1:]) for i in ever]}


def ms_per_call(fn, args, reps: int) -> float:
    fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("determinism_probe: needs one NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = student.SegConfig(n_classes=5, width=WIDTH)
    params = stack_trees([student.make_student(cfg, seed=0, device=dev)] * SESSIONS)
    g = torch.Generator(device=dev).manual_seed(1)
    frames = torch.rand((SESSIONS, FRAMES, HW, HW, 3), generator=g, device=dev)
    labels = torch.randint(0, 5, (SESSIONS, FRAMES, HW, HW), generator=g, device=dev,
                           dtype=torch.int32)
    args = (params, frames, labels)
    fns = versions(cfg)
    out = {}
    for name, fn in fns.items():
        out[name] = {**under_the_mode(fn, args), **same_bits(fn, args)}
        r = out[name]
        print(f"{name}: flagged by use_deterministic_algorithms: "
              f"{json.dumps(r['flagged'])} (bit for bit under it: "
              f"{r['bitwise_under_the_mode']}); repeat calls bit for bit: {r['bitwise']} "
              f"({r['repeats_differing']} of {r['of_repeats']} repeats differ, in up to "
              f"{r['grad_leaves_differing']} of {r['of_leaves']} gradient leaves; their "
              f"shapes {r['leaves_differing']})", flush=True)
    times = {name: [] for name in fns}
    for name in ("before", "after", "interpolate_cudnn_deterministic",
                 "products_cudnn_default", "after_benchmarked", "after", "before"):
        times[name].append(ms_per_call(fns[name], args, a.reps))
    for name, ts in times.items():
        out[name]["ms"] = ts
    print(f"vmapped loss/grad at ({SESSIONS} sessions x {FRAMES} frames of {HW}x{HW}, width "
          f"{WIDTH}), ms a call, in turns before, after, the two halves, after "
          f"benchmarked, after, before: "
          + json.dumps(times))
    print("DETERMINISM " + json.dumps(out))


if __name__ == "__main__":
    main()
