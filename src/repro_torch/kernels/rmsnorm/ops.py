"""Wrapper for the RMSNorm kernel (``csrc/rmsnorm.cu``).

`rms_norm` normalises the last axis of ``x`` over any leading dims. A
CUDA tensor launches the kernel (or the wrapper raises on what the kernel
does not take); a CPU tensor takes the plain version, `ref.rms_norm_ref`.

The C entry point picks one of three variants from the rows, the width
and the alignment (`variant` names the one a call would take): a warp per
row on a persistent grid for many rows, a block per row with one 16-byte
chunk per thread for few rows (a decode step), and a block per row that
caches what fits in registers for the rest (ragged widths, unaligned
rows, very long rows).

``launches`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import rms_norm_ref

launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_VARIANT_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_int]
VARIANTS = ("block_per_row", "split_row", "warp_per_row")


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


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2, -1) + eps) * (1 + w)`` in float32, in x's
    dtype; x (..., d) float32 or bfloat16, w (d,) float32 or bfloat16."""
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
