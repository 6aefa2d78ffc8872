"""Wrapper for the gradient-norm kernel (``csrc/grad_norm.cu``).

`grad_norm` takes the global L2 norm of a model's gradient buffers (the
dtype groups of `core.masked_adam.FlatMaskedAdam.g`) and returns it as a
0-dimensional float32 tensor on their device, without a host sync: masked
Adam (`kernels.masked_adam.ops.masked_adam_3d(..., gn=...)`) reads it
there. A CUDA tensor launches the kernel (or the wrapper raises on what
the kernel does not take); a CPU tensor takes the plain version,
`ref.grad_norm_ref`. The kernel sums in a fixed order, so two calls on
the same buffers give the same bits; its float64 partials make it closer
to the exact norm than the plain float32 sum.

A meta tensor (the dry run, `launch/dryrun.py`) passes the CUDA route's
checks and gets a meta norm, after allocating the route's workspace (as
many float64 partials as `launch_blocks` gives on an H100 SXM,
`device.H100_SMS`); nothing is computed or launched. Any other device raises.

A DTensor buffer (the dry run's sharded trace, `repro_torch.spmd`) is
summed where it lies: the wrapper squares its local shard's norm through
``local_map``, a partial sum over the mesh dims that shard the buffer
(replicated elsewhere), adds the buffers' squares, all-reduces the sum
and takes its root: the one collective a sharded clip issues.

``launches`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import spmd
from repro_torch.device import sm_count
from repro_torch.kernels import build
from repro_torch.kernels.grad_norm.ref import grad_norm_ref

launches = 0

THREADS = 256       # a block (csrc/grad_norm.cu kThreads)
BLOCKS_PER_SM = 4   # 1,024 threads an SM (2, 8, 16: slower on an H100)
MAX_BUFS = 8        # csrc/grad_norm.cu kMaxBufs
VEC = 8             # values a thread loads at once

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def launch_blocks(vecs: int, sms: int) -> int:
    """Blocks for ``vecs`` 8-value vectors on a card with ``sms`` SMs: one
    vector a thread while that is fewer than `BLOCKS_PER_SM` blocks on
    every SM, else a grid that fills every SM and strides over the rest."""
    return max(1, min(-(-vecs // THREADS), sms * BLOCKS_PER_SM))


def _check(bufs) -> None:
    if not 1 <= len(bufs) <= MAX_BUFS:
        raise ValueError(f"grad_norm takes 1 to {MAX_BUFS} buffers, got {len(bufs)}")
    dev = bufs[0].device
    for i, b in enumerate(bufs):
        if b.device != dev:
            raise ValueError(f"buffer {i} is on {b.device}, buffer 0 on {dev}")
        if b.dtype not in _DTYPE_CODES:
            raise TypeError(f"buffer {i} dtype {b.dtype} not in float32/bfloat16/float16")
        if (not b.is_contiguous() or b.numel() % VEC
                or (dev.type == "cuda" and b.data_ptr() % 16)):
            raise ValueError(f"buffer {i} must be contiguous, 16-byte aligned and hold a "
                             f"multiple of {VEC} values")


def grad_norm(bufs) -> torch.Tensor:
    """The global L2 norm of ``bufs`` (flat gradient buffers of float32,
    bfloat16 or float16, each a multiple of 8 values, 16-byte aligned), in
    float32: a 0-dimensional tensor on their device."""
    global launches
    bufs = tuple(bufs)
    if not bufs:
        raise ValueError("grad_norm takes at least one buffer")
    if any(spmd.is_dtensor(b) for b in bufs):
        from torch.distributed.tensor import Replicate

        # each shard's sum of squares: an operand with none of b's dims,
        # whose "gradient" placements are a partial sum over b's shards
        sq = [spmd.local(lambda b: grad_norm((b,)).square(),
                         spmd.operand(b, range(b.ndim), {})[1],
                         (spmd.operand(b, range(b.ndim))[0],))(b)
              for b in bufs]
        total = sq[0]
        for s in sq[1:]:
            total = total + s
        return total.redistribute(placements=[Replicate()] * total.device_mesh.ndim).sqrt()
    dev = bufs[0].device
    if dev.type == "cpu":
        return grad_norm_ref(bufs)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"grad_norm runs on cuda, cpu or meta, not {dev}")
    _check(bufs)
    vecs = [b.numel() // VEC for b in bufs]
    blocks = launch_blocks(sum(vecs), sm_count(dev))
    # the blocks' float64 partials, then the finished-block counter
    work = torch.empty(blocks + 1, dtype=torch.float64, device=dev)
    gn = torch.empty((), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return gn
    lib = build.load("grad_norm")
    fn = lib.grad_norm
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    n = len(bufs)
    ptrs = (ctypes.c_void_p * n)(*(b.data_ptr() for b in bufs))
    counts = (ctypes.c_longlong * n)(*vecs)
    dts = (ctypes.c_int * n)(*(_DTYPE_CODES[b.dtype] for b in bufs))
    stream = torch.cuda.current_stream(dev)
    err = fn(ptrs, counts, dts, n, work.data_ptr(), work.data_ptr() + 8 * blocks,
             gn.data_ptr(), blocks, dev.index, stream.cuda_stream)
    build.check(lib, err, "grad_norm launch")
    launches += 1
    return gn
