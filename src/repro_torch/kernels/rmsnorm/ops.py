"""Wrapper for the RMSNorm kernels (``csrc/rmsnorm.cu`` forward,
``csrc/rmsnorm_bwd.cu`` backward).

`rms_norm` normalises the last axis of ``x`` over any leading dims. A
CUDA tensor launches the kernel (or the wrapper raises on what the kernel
does not take); a CPU tensor takes the plain version, `ref.rms_norm_ref`.

The C entry point picks one of three variants from the rows, the width
and the alignment (`variant` names the one a call would take): a warp per
row on a persistent grid for many rows, a block per row with one 16-byte
chunk per thread for few rows (a decode step), and a block per row that
caches what fits in registers for the rest (ragged widths, unaligned
rows, very long rows).

Where autograd records (grad mode on and x or w requires grad), the call
goes through `RMSNorm`, a ``torch.autograd.Function`` that saves x and w;
its backward gives dx and dw through `rms_norm_bwd`: on CUDA tensors the
backward kernel (one launch of its C entry point: a row pass that writes
dx and per-block float32 dw partials, then a fixed-order column sum), or
the wrapper raises; on CPU tensors the plain version,
`ref.rms_norm_bwd_ref`. There is no other route. The row pass has two
variants, picked from the shape and the alignment as the forward's are
(`bwd_variant` names the one a call takes): a warp per row that holds the
row of x and dy in registers (rows of whole, aligned 16-byte chunks, at
most 2,048 bf16 or 1,024 float32 values), and a block per row for the
rest.

``launches`` counts forward kernel launches and ``bwd_launches`` backward
ones (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import rms_norm_bwd_ref, rms_norm_ref

launches = 0
bwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_VARIANT_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_int]
_BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                 ctypes.c_void_p]
VARIANTS = ("block_per_row", "split_row", "warp_per_row")
BWD_VARIANTS = ("block_per_row", "warp_per_row")
_BWD_PLAN_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_longlong, ctypes.c_int, ctypes.c_int]


def _check(x: torch.Tensor, w: torch.Tensor) -> int:
    """Raise on what the kernel does not take; the number of rows."""
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu, not {x.device}")
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODES or w.dtype not in _DTYPE_CODES:
        raise TypeError(f"x {x.dtype} and w {w.dtype} must be float32 or "
                        "bfloat16")
    if w.device != x.device or w.shape != (d,) or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous ({d},) tensor on {x.device}, "
                         f"got {tuple(w.shape)} on {w.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    rows = x.numel() // max(d, 1)
    if rows >= 2**31:
        raise ValueError(f"{rows} rows exceed the kernel's grid (2**31 - 1)")
    return rows


def variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel variant `rms_norm` takes for these CUDA tensors, one of
    `VARIANTS` (its output is a fresh buffer, so 16-byte aligned)."""
    rows = _check(x, w)
    lib = build.load("rmsnorm")
    fn = lib.rms_norm_variant
    fn.argtypes = _VARIANT_ARGTYPES
    fn.restype = ctypes.c_int
    v = fn(x.data_ptr(), _DTYPE_CODES[x.dtype], w.data_ptr(), _DTYPE_CODES[w.dtype],
           None, rows, x.shape[-1], x.device.index)
    if v < 0:
        raise RuntimeError(f"rms_norm_variant: cannot query {x.device}")
    return VARIANTS[v]


def _bwd_plan(fn_name: str, x, dy, dx) -> int:
    """The backward's C planner ``fn_name`` (its variant or its number of
    dw partial rows) for these CUDA tensors."""
    lib = build.load("rmsnorm_bwd")
    fn = getattr(lib, fn_name)
    fn.argtypes = _BWD_PLAN_ARGTYPES
    fn.restype = ctypes.c_int
    d = x.shape[-1]
    return fn(x.data_ptr(), _DTYPE_CODES[x.dtype], dy.data_ptr(),
              None if dx is None else dx.data_ptr(), x.numel() // max(d, 1), d,
              x.device.index)


def bwd_variant(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor) -> str:
    """The row-pass variant `rms_norm_bwd` takes for these CUDA tensors,
    one of `BWD_VARIANTS` (its dx is a fresh buffer, so 16-byte aligned)."""
    _check(x, w)
    return BWD_VARIANTS[_bwd_plan("rms_norm_bwd_variant", x, dy.contiguous(), None)]


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float):
    global launches
    if x.device.type == "cpu":
        return rms_norm_ref(x, w, eps)
    rows = _check(x, w)
    d = x.shape[-1]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build.load("rmsnorm")
    fn = lib.rms_norm
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device)
    err = fn(x.data_ptr(), _DTYPE_CODES[x.dtype], w.data_ptr(),
             _DTYPE_CODES[w.dtype], out.data_ptr(), rows, d, eps,
             x.device.index, stream.cuda_stream)
    build.check(lib, err, "rms_norm launch")
    launches += 1
    return out


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                 eps: float = 1e-6):
    """(dx, dw) of `rms_norm` at (x, w) for the output gradient dy: dx in
    x's dtype and shape, dw in w's. CUDA tensors launch the backward
    kernel or raise; CPU tensors take `ref.rms_norm_bwd_ref`."""
    global bwd_launches
    if x.device.type == "cpu":
        return rms_norm_bwd_ref(x, w, dy, eps)
    rows = _check(x, w)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    dy = dy.contiguous()
    d = x.shape[-1]
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    if x.numel() == 0:
        return dx, dw.zero_()
    part = torch.empty((_bwd_plan("rms_norm_bwd_blocks", x, dy, dx), d),
                       dtype=torch.float32, device=x.device)
    lib = build.load("rmsnorm_bwd")
    fn = lib.rms_norm_bwd
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device)
    err = fn(x.data_ptr(), _DTYPE_CODES[x.dtype], w.data_ptr(), _DTYPE_CODES[w.dtype],
             dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), part.data_ptr(), rows, d,
             eps, x.device.index, stream.cuda_stream)
    build.check(lib, err, "rms_norm_bwd launch")
    bwd_launches += 1
    return dx, dw


class RMSNorm(torch.autograd.Function):
    """`rms_norm` with its backward: saves x and w and hands them to
    `rms_norm_bwd`."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, dy, ctx.eps)
        return dx, dw, None


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2, -1) + eps) * (1 + w)`` in float32, in x's
    dtype; x (..., d) float32 or bfloat16, w (d,) float32 or bfloat16;
    differentiable through `RMSNorm` where autograd records."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNorm.apply(x, w, eps)
    return _forward(x, w, eps)
