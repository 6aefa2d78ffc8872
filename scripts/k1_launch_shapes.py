"""K1 (masked Adam) and the gradient-norm kernel at several launch shapes,
on the card: the measurements behind `kernels/masked_adam/ops.launch_shape`
and `kernels/grad_norm/ops.BLOCKS_PER_SM`.

    PYTHONPATH=src python3 scripts/k1_launch_shapes.py [--quick]

For each shape it prints K1's device time (chip_smoke's `device_ms`: a
median over calls queued behind a spin kernel) at the three sizes the
port runs it at: B = 1 and B = 8 sessions of the width-4.0 student
(334,405 float32 parameters, (B, 2613, 128) buffers) and Gemma 2B's
in-place bf16 step over 2,506,172,416 coordinates, with and without the
fused clip. Then the gradient norm at Gemma 2B's bf16 gradients for
several grids, beside its plain version and `torch.linalg.vector_norm`.
Every output is first held against its plain version (K1 bit for bit,
the norm within 1e-6 of a float64 norm). ``--quick`` times fewer shapes.
Prints the card's name and power limit first; needs one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import device_ms, peaks  # noqa: E402
from repro_torch.device import sm_count  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.grad_norm import ops as norm_ops  # noqa: E402
from repro_torch.kernels.grad_norm.ref import grad_norm_ref  # noqa: E402
from repro_torch.kernels.masked_adam import ops as adam_ops  # noqa: E402
from repro_torch.kernels.masked_adam.ref import clip_ref, masked_adam_ref  # noqa: E402

ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)
real_shape = adam_ops.launch_shape
STUDENT_ROWS, TRAIN_ROWS = 2613, 19_579_472  # 334,405 and 2,506,172,416 coordinates


def bufs(dev, b, rows, dts, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, rows, 128)
    p = torch.randn(shape, generator=g, device=dev).to(dts[0])
    grad = (torch.randn(shape, generator=g, device=dev) * 1e-2).to(dts[1])
    m = (torch.randn(shape, generator=g, device=dev) * 1e-3).to(dts[2])
    v = (torch.rand(shape, generator=g, device=dev) * 1e-4).to(dts[3])
    mask = torch.rand(shape, generator=g, device=dev) < 0.05
    return p, grad, m, v, mask


def k1_bitwise(args, bc, gn=None, clip=0.0):
    """The kernel on copies against clip_ref + masked_adam_ref; raise on a
    differing bit."""
    p, g, m, v, mask = (t.clone() for t in args)
    out = adam_ops.masked_adam_3d(p, g, m, v, mask, bc, **ADAM, gn=gn, clip=clip)
    g_want = args[1] if gn is None else clip_ref(args[1], gn, clip)
    want = masked_adam_ref(args[0], g_want, *args[2:], bc, **ADAM)
    torch.cuda.synchronize()
    for name, k, r in zip(("p", "m", "v", "u", "g"), (*out, g), (*want, g_want)):
        if not torch.equal(k.view(torch.uint8), r.view(torch.uint8)):
            raise AssertionError(f"K1 {name} differs from its plain version")


def shapes(vecs, sms, quick):
    out = {"now": real_shape(vecs, sms),
           "former (256, one vector a thread)": (256, -(-vecs // 256))}
    for t in (128, 64):
        out[f"({t}, one vector a thread)"] = (t, -(-vecs // t))
    if quick:
        out["(64, 8 x SMs blocks, grid-stride)"] = (64, min(sms * 8, -(-vecs // 64)))
        return out
    for t, ks in ((256, (1, 2, 4, 8)), (128, (2, 4, 8, 16)), (64, (4, 8, 16, 32))):
        for k in ks:
            out[f"({t}, {k} x {sms} blocks, grid-stride)"] = (t, min(sms * k, -(-vecs // t)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k1_launch_shapes: needs one NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    bw, _, _ = peaks(torch.cuda.get_device_name(0))
    sms = sm_count(dev)
    print(f"build {build.build_all():.1f} s; {sms} SMs")
    for name in ("masked_adam", "grad_norm"):
        r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                            "/dev/null", str(build.CSRC / f"{name}.cu")],
                           capture_output=True, text=True, timeout=300)
        print(f"ptxas {name}: " + " | ".join(l.strip() for l in r.stderr.splitlines()
                                             if "registers" in l or "spill" in l))
    rows = {}

    def k1_times(label, args, bc, nbytes, gn=None, clip=0.0, reps=20):
        vecs = args[0].numel() // 8
        for sname, (t, blocks) in shapes(vecs, sms, a.quick).items():
            adam_ops.launch_shape = lambda v, s, t=t, blocks=blocks: (t, blocks)
            if args[0].numel() < 1e8:
                k1_bitwise(args, bc, gn, clip)
            ms = device_ms(lambda: adam_ops.masked_adam_3d(*args, bc, **ADAM, gn=gn,
                                                           clip=clip,
                                                           out=(args[0], args[2], args[3],
                                                                u)), n=reps)
            rows.setdefault(label, {})[sname] = ms
            print(f"K1 {label} {sname}: {ms:.4f} ms (bound {1e3 * nbytes / bw:.4f})")
        adam_ops.launch_shape = real_shape

    for _ in range(3):  # the clocks up before the first timing
        device_ms(lambda: torch.cuda._sleep(1_000_000), n=5)
    # the student's sessions, float32 (chip_smoke's k1_phase)
    f32 = (torch.float32,) * 4
    for b in ((1, 8) if a.quick else (1, 8, 32, 128)):
        args = bufs(dev, b, STUDENT_ROWS, f32, 11)
        u = torch.empty(args[0].shape, device=dev)
        _, bc = adam_ops.bias_correction(torch.arange(b, dtype=torch.int32, device=dev),
                                         lr=1e-3, b1=0.9, b2=0.999)
        k1_bitwise(args, bc)
        gn = norm_ops.grad_norm([args[1]])
        k1_bitwise(args, bc, gn, 1e-3)
        k1_times(f"B={b} f32", args, bc, args[0].numel() * 33 + 4 * b)
        del args, u
    # Gemma 2B's in-place step: bf16 p, g, m; float32 v and u
    bf = (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32)
    args = bufs(dev, 1, TRAIN_ROWS, bf, 12)
    u = torch.empty(args[0].shape, device=dev)
    _, bc = adam_ops.bias_correction(torch.zeros(1, dtype=torch.int32, device=dev),
                                     lr=1e-3, b1=0.9, b2=0.999)
    n = args[0].numel()
    k1_times("train bf16, no clip", args, bc, n * 23 + 4, reps=5)
    half = torch.full((), 0.5, device=dev)  # scale 1: the buffers stay as they are
    k1_times("train bf16, clip", args, bc, n * 25 + 8, gn=half, clip=1.0, reps=5)

    # the gradient norm over the trainer's bf16 gradients
    g = args[1]
    del args, u
    torch.cuda.empty_cache()
    truth = torch.zeros((), dtype=torch.float64, device=dev)
    for chunk in g.view(-1).split(1 << 27):
        truth += chunk.double().square().sum()
    truth = truth.sqrt()
    norm = {}
    per_sm = norm_ops.BLOCKS_PER_SM
    for k in ((2, 4, 8, 16) if not a.quick else (per_sm,)):
        norm_ops.BLOCKS_PER_SM = k
        x1, x2 = norm_ops.grad_norm([g]), norm_ops.grad_norm([g])
        rel = float((x1.double() - truth).abs() / truth)
        same = torch.equal(x1, x2)
        ms = device_ms(lambda: norm_ops.grad_norm([g]), n=10)
        norm[k] = dict(ms=ms, rel=rel, same=same)
        print(f"grad_norm {k} blocks/SM: {ms:.4f} ms, rel err to float64 {rel:.3e}, "
              f"two calls equal {same}")
        if rel > 1e-6 or not same:
            raise AssertionError(f"grad_norm at {k} blocks/SM: {norm[k]}")
    norm_ops.BLOCKS_PER_SM = per_sm
    plain = grad_norm_ref([g])
    lib = torch.linalg.vector_norm(g, dtype=torch.float32)
    plain_ms = device_ms(lambda: grad_norm_ref([g]), n=3, reps=3)
    lib_ms = device_ms(lambda: torch.linalg.vector_norm(g, dtype=torch.float32), n=10)
    print(f"grad_norm plain {plain_ms:.4f} ms (rel err {float((plain.double() - truth).abs() / truth):.3e}), "
          f"torch.linalg.vector_norm {lib_ms:.4f} ms (rel err "
          f"{float((lib.double() - truth).abs() / truth):.3e}); bound "
          f"{1e3 * g.numel() * 2 / bw:.4f} ms")
    print("K1_SHAPES " + json.dumps(dict(card=smi, k1=rows, norm=norm, plain_ms=plain_ms,
                                         vector_norm_ms=lib_ms)))


if __name__ == "__main__":
    main()
