"""Wrapper for the RWKV-6 wkv kernel (``csrc/wkv6.cu``).

`wkv6` runs the wkv recurrence over a whole sequence (RWKV-6's prefill
scan): given r, k, v and log w of shape (B, S, H, P) and the bonus u of
shape (H, P), it returns y (B, S, H, P) and the final state (B, H, P, P),
all float32. A CUDA tensor launches the kernel, one launch a call, or
the wrapper raises on what the kernel does not take: another dtype than
float32, tensors that are not contiguous, 16-byte aligned and on one
card, a head size other than 16, 32 or 64, or inputs that record
autograd (the kernel has no backward: the JAX package has no backward
kernel for this scan either, and no path on the card trains RWKV-6).
There is no fallback. A CPU tensor takes the plain version,
`ref.wkv6_ref` (the chunk loop), at ``chunk``; so does a meta tensor
(the dry run traces the loop as before). ``chunk`` sets only the plain
version's chunk: the kernel stages its own tiles and takes any S.

The kernel's tiling follows from the head size alone (``csrc/wkv6.cu``:
a block per row, head and 32 value columns, 8 x 2 state entries a lane);
there is no knob.

``launches`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wkv6.ref import wkv6_ref

launches = 0

HEAD_SIZES = (16, 32, 64)  # csrc/wkv6.cu's instantiations: the port's RWKV configs
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def check_inputs(r, k, v, logw, u) -> None:
    """Raise on what the kernel does not take (see the module's note)."""
    if r.dim() != 4:
        raise ValueError(f"wkv6 takes r, k, v, log w of shape (B, S, H, P), got {tuple(r.shape)}")
    B, S, H, P = r.shape
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if tuple(t.shape) != (B, S, H, P):
            raise ValueError(f"wkv6: {name} has shape {tuple(t.shape)}, r {(B, S, H, P)}")
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6: {name} is {t.dtype}; the kernel takes float32")
        if t.device != r.device:
            raise ValueError(f"wkv6: {name} is on {t.device}, r on {r.device}")
        if not t.is_contiguous() or (t.device.type == "cuda" and t.data_ptr() % 16):
            raise ValueError(f"wkv6: {name} must be contiguous and 16-byte aligned")
    if tuple(u.shape) != (H, P) or u.dtype != torch.float32 or u.device != r.device \
            or not u.is_contiguous():
        raise ValueError(f"wkv6: u must be a contiguous float32 (H, P) = {(H, P)} tensor "
                         f"on {r.device}, got {tuple(u.shape)} {u.dtype} on {u.device}")
    if P not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {P} not in {HEAD_SIZES}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, logw, u)):
        raise RuntimeError("wkv6: the inputs record autograd, and the kernel has no backward")


def wkv6(r, k, v, logw, u, chunk: int = 64):
    """The wkv recurrence over (B, S, H, P): (y, final state)."""
    global launches
    if r.device.type in ("cpu", "meta"):
        return wkv6_ref(r, k, v, logw, u, chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda, cpu or meta, not {r.device}")
    u = u.to(torch.float32).contiguous()
    check_inputs(r, k, v, logw, u)
    B, S, H, P = r.shape
    y = torch.empty_like(r)
    state = torch.empty((B, H, P, P), dtype=torch.float32, device=r.device)
    lib = build.load("wkv6")
    fn = lib.wkv6_forward
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(r.device)
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
             y.data_ptr(), state.data_ptr(), B, S, H, P, r.device.index,
             stream.cuda_stream)
    build.check(lib, err, "wkv6 launch")
    launches += 1
    return y, state
