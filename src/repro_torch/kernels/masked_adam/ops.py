"""Wrappers for the fused masked-Adam kernel (``csrc/masked_adam.cu``).

`masked_adam_3d` is the kernel's own wrapper: one step over per-dtype
``(B, rows, 128)`` buffers. A CUDA tensor launches the kernel (or the
wrapper raises on what the kernel does not take); a CPU tensor takes the
plain version, `ref.masked_adam_ref`. `masked_adam_stacked` is the fused
training path's entry: a B-stacked ``(params, grads, state, mask)`` tree
runs as one launch per distinct param dtype over buffers laid out by
`repro_torch.kernels.stacking`. `masked_adam_flat` is the same step for
a caller that keeps p, m, v and the mask in that flat layout across
steps (the fused phase's K loop): only the gradients are flattened, one
``torch.cat`` per dtype group, and the outputs stay flat. Given ``out``,
`masked_adam_3d` writes p', m', v' and u into those buffers, which may be
p, m and v themselves (`core.masked_adam.FlatMaskedAdam`, the LLM
trainer's in-place step). Given ``gn``, the global gradient norm as a
float32 tensor of one value on the device (`kernels.grad_norm.ops.
grad_norm`), the step first applies the JAX trainer's clip to ``clip``
and its non-finite guard to g (`ref.clip_ref`) and writes the clipped
gradients over g, in the same launch.

The kernel's grid is one-dimensional over every session's 8-coordinate
vectors; `launch_shape` picks its block size and block count from the
work and the card's SMs.

A meta tensor (the dry run, `launch/dryrun.py`) passes the CUDA route's
checks and gets meta outputs of the shapes and dtypes that route
allocates (none when ``out`` is given); nothing is computed or launched.
Any other device raises.

A DTensor p (the dry run's sharded trace, `repro_torch.spmd`) runs
`masked_adam_3d` on each rank's shard through ``local_map``: the step is
elementwise, so g, m, v, the mask and ``out`` take p's placements, and bc
and gn are replicated.

``launches`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import spmd, tree
from repro_torch.device import sm_count
from repro_torch.kernels import build, stacking
from repro_torch.kernels.masked_adam.ref import clip_ref, masked_adam_ref

launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
             + [ctypes.c_float] + [ctypes.c_void_p] * 4
             + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_float] * 5
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])
THREADS = 64          # a block (at most csrc/masked_adam.cu kMaxThreads)
THREADS_PER_SM = 512  # the strided grid's
STRIDED_UP_TO = 10    # vectors a thread of the strided grid


def launch_shape(vecs: int, sms: int) -> tuple[int, int]:
    """``(threads, blocks)`` of K1's grid for ``vecs`` 8-coordinate
    vectors (all sessions) on a card with ``sms`` SMs, in blocks of
    `THREADS`. Up to `THREADS_PER_SM` threads an SM, one vector a thread
    (B = 1: ~5 blocks on every SM, where 256-thread blocks put one or two
    on each); above that and up to `STRIDED_UP_TO` vectors a thread, that
    grid strides over the rest (B = 8, 5 vectors a thread: no partial
    second wave); above that, one vector a thread again (B = 32 at 20
    vectors a thread, and Gemma 2B's step, where a strided thread's
    serial loads fall behind). `STRIDED_UP_TO` lies between those two
    measured sizes. Measured on an H100 by ``scripts/k1_launch_shapes.py``
    (PERF.md)."""
    per_thread = vecs / (sms * THREADS_PER_SM)
    if 1 < per_thread <= STRIDED_UP_TO:
        return THREADS, sms * THREADS_PER_SM // THREADS
    return THREADS, max(1, -(-vecs // THREADS))


def bias_correction(count, *, lr: float, b1: float, b2: float):
    """``(i, bc)`` for Adam step ``i = count + 1``:
    ``bc = lr * sqrt(1 - b2^i) / (1 - b1^i)`` in float32, per session."""
    i = count + 1
    i32 = i.to(torch.float32)
    return i, lr * torch.sqrt(1.0 - b2 ** i32) / (1.0 - b1 ** i32)


def _check_kernel_args(p, g, m, v, mask, bc, gn=None):
    bufs = {"p": p, "g": g, "m": m, "v": v, "mask": mask}
    for name, t in bufs.items():
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
        if t.dim() != 3 or t.shape[2] != stacking.LANES or t.shape != p.shape:
            raise ValueError(
                f"{name} must be (B, rows, {stacking.LANES}) like p "
                f"{tuple(p.shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous() or (t.device.type == "cuda" and t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if name != "mask" and t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} dtype {t.dtype} not in float32/bfloat16/"
                            "float16")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"mask dtype {mask.dtype} must be bool or uint8")
    if (bc.device != p.device or bc.dtype != torch.float32
            or bc.shape != (p.shape[0],) or not bc.is_contiguous()):
        raise ValueError(f"bc must be a contiguous float32 ({p.shape[0]},) "
                         f"tensor on {p.device}")
    if gn is not None and (gn.device != p.device or gn.dtype != torch.float32
                           or gn.numel() != 1):
        raise ValueError(f"gn must be one float32 value on {p.device}")


def masked_adam_3d(p, g, m, v, mask, bc, *, b1: float, b2: float,
                   eps: float, out=None, gn=None, clip: float = 0.0):
    """One fused masked-Adam step over ``(B, rows, 128)`` buffers; ``bc``
    is the (B,) float32 bias correction per session. Returns
    ``(p', m', v', u)`` with p', m', v' in their source dtypes and u in
    float32: new buffers, or the four of ``out`` (p', m', v' like p, m,
    v, u float32), which may be p, m and v themselves: each thread of the
    kernel reads its 8 coordinates of every input before it writes them,
    so the step can run in place (a 2.5B-parameter model's state has no
    room for a second copy). Given ``gn`` and a positive ``clip``, g is
    clipped first (`ref.clip_ref`) and the clipped gradients are written
    over g on every device; one without the other raises. A DTensor p
    steps each rank's shard (the module docstring)."""
    global launches
    if spmd.is_dtensor(p):
        kw = dict(b1=b1, b2=b2, eps=eps, clip=clip)
        pp, rep = p.placements, spmd.operand(p, ())[0]
        outs = () if out is None else tuple(out)

        def step(p, g, m, v, mask, bc, gn, *out):
            return masked_adam_3d(p, g, m, v, mask, bc, out=out or None, gn=gn, **kw)

        return spmd.local(step, (pp,) * 4,
                          (pp,) * 5 + (rep, None if gn is None else rep)
                          + (pp,) * len(outs))(p, g, m, v, mask, bc, gn, *outs)
    if (gn is not None) != (clip > 0):
        raise ValueError(f"gn and a positive clip go together (clip {clip}, gn "
                         f"{'given' if gn is not None else 'None'})")
    if p.device.type == "cpu":
        if gn is not None:
            g.copy_(clip_ref(g, gn, clip))
        new = masked_adam_ref(p, g, m, v, mask, bc, b1=b1, b2=b2, eps=eps)
        if out is None:
            return new
        for dst, src in zip(out, new):
            dst.copy_(src)
        return tuple(out)
    if p.device.type not in ("cuda", "meta"):
        raise ValueError(f"masked_adam_3d runs on cuda, cpu or meta, not {p.device}")
    _check_kernel_args(p, g, m, v, mask, bc, gn)
    if out is None:
        p_out, m_out, v_out = (torch.empty_like(t) for t in (p, m, v))
        u_out = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    else:
        p_out, m_out, v_out, u_out = out
        for src, dst in ((p, p_out), (m, m_out), (v, v_out), (p, u_out)):
            want = torch.float32 if dst is u_out else src.dtype
            if (dst.shape != p.shape or dst.dtype != want or dst.device != p.device
                    or not dst.is_contiguous()
                    or (dst.device.type == "cuda" and dst.data_ptr() % 16)):
                raise ValueError("out must hold contiguous, 16-byte aligned p', m', "
                                 "v' like p, m, v and a float32 u like p")
    if p.device.type == "meta":
        return p_out, m_out, v_out, u_out
    lib = build.load("masked_adam")
    fn = lib.masked_adam_3d
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    b, rows, lanes = p.shape
    threads, blocks = launch_shape(p.numel() // 8, sm_count(p.device))
    stream = torch.cuda.current_stream(p.device)
    err = fn(p.data_ptr(), _DTYPE_CODES[p.dtype],
             g.data_ptr(), _DTYPE_CODES[g.dtype],
             m.data_ptr(), _DTYPE_CODES[m.dtype],
             v.data_ptr(), _DTYPE_CODES[v.dtype],
             mask.data_ptr(), bc.data_ptr(), None if gn is None else gn.data_ptr(), clip,
             p_out.data_ptr(), m_out.data_ptr(), v_out.data_ptr(),
             u_out.data_ptr(), rows * lanes, b,
             b1, 1.0 - b1, b2, 1.0 - b2, eps, threads, blocks,
             p.device.index, stream.cuda_stream)
    build.check(lib, err, "masked_adam_3d launch")
    launches += 1
    return p_out, m_out, v_out, u_out


def masked_adam_stacked(params, grads, state, mask, *, lr=1e-3, b1=0.9,
                        b2=0.999, eps=1e-8):
    """One masked-Adam step for a B-stacked session group, as one
    `masked_adam_3d` call per param dtype over concatenated leaf buffers.

    ``params`` / ``grads`` / ``mask`` and ``state``'s moment trees all carry
    a leading session axis; ``state.count`` is (B,), so sessions at
    different Adam step counts get their own bias correction. Returns
    ``(params', state', u)`` with ``u`` float32; the returned leaves are
    views into the kernel's output buffers."""
    i, bc = bias_correction(state.count, lr=lr, b1=b1, b2=b2)
    plan = stacking.stack_plan(params)
    b = plan.b
    leaves = [tree.leaves(t) for t in (params, grads, state.m, state.v, mask)]
    outs = [[None] * len(leaves[0]) for _ in range(4)]
    for group in plan.groups:
        bufs = [stacking.flatten_group(ls, group, b) for ls in leaves]
        for buf, out in zip(masked_adam_3d(*bufs, bc.reshape(b), b1=b1,
                                           b2=b2, eps=eps), outs):
            stacking.unflatten_group(buf, group, b, plan.shapes, out=out)
    p_new, m_new, v_new, u = (tree.unflatten(plan.treedef, o) for o in outs)
    return p_new, type(state)(m_new, v_new, i), u


def masked_adam_flat(p, grads, m, v, mask, count, plan, *, lr=1e-3, b1=0.9,
                     b2=0.999, eps=1e-8):
    """One masked-Adam step over already-flat per-dtype buffers.

    ``p``, ``m``, ``v`` and ``mask`` are tuples of ``(B, rows, 128)``
    buffers, one per group of ``plan`` (`stacking.flatten_tree`);
    ``grads`` is the B-stacked gradient tree, flattened here; ``count`` is
    the (B,) Adam step count. Returns ``(p', m', v', u, count')``, the
    buffers as tuples in the same layout. The arithmetic is
    `masked_adam_stacked`'s, launch for launch: the flat layout is an
    exact re-layout, so the two agree bit for bit."""
    i, bc = bias_correction(count, lr=lr, b1=b1, b2=b2)
    bc = bc.reshape(plan.b)
    g = stacking.flatten_tree(grads, plan)
    outs = [masked_adam_3d(*bufs, bc, b1=b1, b2=b2, eps=eps)
            for bufs in zip(p, g, m, v, mask)]
    p_new, m_new, v_new, u = (tuple(o[j] for o in outs) for j in range(4))
    return p_new, m_new, v_new, u, i
