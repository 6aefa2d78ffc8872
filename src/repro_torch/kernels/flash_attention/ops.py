"""Wrapper for the flash-attention kernels (``csrc/flash_attention.cu``
forward, ``csrc/flash_attention_bwd.cu`` backward), in the model's
``(B, S, KV, G, hd)`` layout (the JAX package's
`kernels/flash_attention/ops.flash_attention_pallas`).

The forward's route is chosen by the tensors' device and dtype, and none
falls back to another:

* a bfloat16 CUDA tensor launches the tensor-core kernel (``wgmma`` with
  TMA loads through tensor maps over the given strides), or the wrapper
  raises;
* a float32 CUDA tensor launches the CUDA-core kernel, or the wrapper
  raises;
* a CPU tensor takes the plain version, `ref.flash_attention_ref`.

Both kernels read q, k and v through their strides, so the model's
projections go in without a transpose, and write a contiguous output.
They take head dims 64, 112 (Zamba2-7B's), 128 and 256 (`HEAD_DIMS`).

Where autograd records (grad mode on and q, k or v requires grad), the
call goes through `FlashAttention`, a ``torch.autograd.Function``: its
forward runs the route above and also keeps the rows' log-sum-exp (the
kernels write it when given a buffer; the plain version computes it),
and its backward computes dq, dk and dv from q, k, v, the output and
that log-sum-exp. On CUDA tensors the backward launches the backward
kernels, routed by dtype as the forward is: bfloat16 on the tensor cores
(``wgmma`` and TMA, P and dS split into two bf16 terms), float32 on the
CUDA cores; a dtype or shape they do not take raises. On CPU tensors it
runs the plain version, `ref.flash_attention_bwd_ref`. There is no other
route: a CUDA input that requires grad gets its gradient from the kernel
or raises.

A meta tensor (``torch.device("meta")``: shapes and dtypes, no storage;
the dry run, `launch/dryrun.py`) gets meta outputs of exactly the shapes
and dtypes that the CUDA route allocates, and every workspace that route
allocates in torch (the backward's float32 per-q-head dK/dV partials and
its row terms D), after the CUDA route's checks; nothing is computed and
nothing is launched. It adds the work the kernel would do to
``meta_flops``: 4 hd FLOPs per live (q, k) pair per q head forward (QK^T
and PV), 10 hd backward (the scores again, dP, dV, dQ and dK). Any other
device raises.

A DTensor q (the dry run's sharded trace, `repro_torch.spmd`) runs the
same wrapper on local shards through ``local_map``: attention is local
per batch row and per head, so q keeps its shards of B, KV and G, k and
v those of B and KV (q's), and every other shard or partial sum is
gathered first; where q is sharded over G, each rank's dk and dv are
partial sums over its q heads.

``launches`` counts forward kernel launches of both routes (plain-version
calls do not count); ``launches_by_route`` counts them per route.
``bwd_launches`` and ``bwd_launches_by_route`` do the same for the
backward (one per backward call; its C entry point issues three kernels).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import spmd
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

launches = 0
bwd_launches = 0
# dtype -> (route name, C entry point)
ROUTES = {torch.bfloat16: ("bf16_wgmma", "flash_attention_fwd_bf16"),
          torch.float32: ("f32_cuda_cores", "flash_attention_fwd_f32")}
launches_by_route = {name: 0 for name, _ in ROUTES.values()}
# dtype -> (backward route name, dtype code of the C entry point)
BWD_ROUTES = {torch.bfloat16: ("bf16_wgmma", 1),
              torch.float32: ("f32_cuda_cores", 0)}
bwd_launches_by_route = {name: 0 for name, _ in BWD_ROUTES.values()}
meta_flops = 0  # FLOPs of the meta calls (the dry run's count)

# the head dims the kernels take: instantiations of both routes, but the
# bf16 route runs 112 as its 128 instantiation over 112-wide tensor maps
# (TMA zero-fills columns 112..127 and drops them on the store)
HEAD_DIMS = (64, 112, 128, 256)
TMA_Q_ROWS = 128            # q rows per block of the bf16 kernel
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_longlong)]
                 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                 + [ctypes.c_int, ctypes.c_void_p])


def reset_launches() -> None:
    """Set the totals and every per-route count, forward and backward, to
    0."""
    global launches, bwd_launches
    launches = bwd_launches = 0
    for counts in (launches_by_route, bwd_launches_by_route):
        for name in counts:
            counts[name] = 0


def live_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs that the mask keeps, over one head: query i
    sees key j where j <= i (causal) and i - j < window (window)."""
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _count_meta(q, k, causal, window, per_pair: int) -> None:
    global meta_flops
    b, sq, kv, g, hd = q.shape
    meta_flops += per_pair * hd * b * kv * g * live_pairs(sq, k.shape[1], causal, window)


def _check(q, k, v):
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B,Sq,KV,G,hd) and k, v (B,Skv,KV,hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, kv, _, hd = q.shape
    if k.shape[0] != b or k.shape[2] != kv or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of the kernel's {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in ROUTES:
            raise TypeError(f"q, k, v must share one dtype of float32/bfloat16, "
                            f"got {q.dtype}, {k.dtype}, {v.dtype}")
        vec = 16 // t.element_size()
        if (t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1])
                or (t.device.type == "cuda" and t.data_ptr() % 16)):
            raise ValueError(f"{name} must have a contiguous last axis, "
                             f"16-byte aligned rows and base, got strides "
                             f"{t.stride()}")
        if t.dtype == torch.bfloat16 and any(
                s <= 0 or s * 2 >= 2**40 for s, n in zip(t.stride(), t.shape)
                if n > 1):
            raise ValueError(f"{name}'s strides {t.stride()} do not fit a TMA "
                             f"tensor map (positive, under 2**40 bytes)")
    if max(q.shape[1], k.shape[1]) >= 2**31:
        raise ValueError("sequence too long for the kernel's int positions")
    if q.dtype == torch.bfloat16 and -(-q.shape[1] // TMA_Q_ROWS) > 65535:
        raise ValueError("sequence too long for the kernel's grid")


def _forward(q, k, v, causal, window, softcap, want_lse):
    """(out, lse): the route of the module docstring; lse (B, KV, G, Sq)
    float32 with ``want_lse``, else None."""
    global launches
    if q.device.type == "cpu":
        if want_lse:
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, return_lse=True)
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap), None
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not {q.device}")
    _check(q, k, v)
    route, entry = ROUTES[q.dtype]
    b, sq, kv, g, hd = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, kv, g, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if q.device.type == "meta":
        _count_meta(q, k, causal, window, 4)
        return out, lse
    lib = build.load("flash_attention")
    fn = getattr(lib, entry)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * 14)(
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *out.stride()[:4])
    stream = torch.cuda.current_stream(q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             hd, b, sq, k.shape[1], kv, g, strides,
             int(causal), int(window), float(softcap), hd**-0.5,
             None if lse is None else lse.data_ptr(),
             q.device.index, stream.cuda_stream)
    build.check(lib, err, f"flash_attention launch ({route})")
    launches += 1
    launches_by_route[route] += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of `flash_attention` at (q, k, v) for the output
    gradient ``do``, from its output ``o`` and row log-sum-exp ``lse``
    (B, KV, G, Sq) float32, each in its input's shape and dtype
    (contiguous). CUDA tensors launch the backward kernel or raise; CPU
    tensors take `ref.flash_attention_bwd_ref`."""
    global bwd_launches
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, softcap=softcap)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not {q.device}")
    _check(q, k, v)
    b, sq, kv, g, hd = q.shape
    skv = k.shape[1]
    o = o.contiguous()
    do = do.contiguous()
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be {tuple(q.shape)} {q.dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if (lse.shape != (b, kv, g, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 {(b, kv, g, sq)} "
                         f"tensor on {q.device}")
    route, code = BWD_ROUTES[q.dtype]
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((b, kv * g, sq), **f32)
    dk_part = torch.empty((b, kv * g, skv, hd), **f32)
    dv_part = torch.empty((b, kv * g, skv, hd), **f32)
    dq = torch.empty_like(o)
    dk = torch.empty((b, skv, kv, hd), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    if q.device.type == "meta":
        _count_meta(q, k, causal, window, 10)
        return dq, dk, dv
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = _BWD_ARGTYPES
    fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * 14)(
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *o.stride()[:4])
    stream = torch.cuda.current_stream(q.device)
    err = fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk_part.data_ptr(), dv_part.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             hd, b, sq, skv, kv, g, strides, int(causal), int(window),
             float(softcap), hd**-0.5, q.device.index, stream.cuda_stream)
    build.check(lib, err, f"flash_attention_bwd launch ({route})")
    bwd_launches += 1
    bwd_launches_by_route[route] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """`flash_attention` with its backward: saves q, k, v, the output and
    the rows' log-sum-exp, and hands them to `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _forward(q, k, v, causal, window, softcap, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (B,Sq,KV,G,hd); k, v: (B,Skv,KV,hd). Returns (B,Sq,KV,G,hd) in
    q's dtype: softmax attention with float32 scores and accumulation,
    ``hd**-0.5`` scaling, an optional tanh softcap and causal /
    sliding-window masks; differentiable through `FlashAttention` where
    autograd records. A DTensor q runs on local shards (the module
    docstring)."""
    if spmd.is_dtensor(q):
        (pq, gq), (pkv, gkv) = (spmd.operand(q, (0, 2, 3)),
                                spmd.operand(q, (0, 2, 3), {0: 0, 2: 2}))
        return spmd.local(
            lambda a, b, c: flash_attention(a, b, c, causal=causal, window=window,
                                            softcap=softcap),
            pq, (pq, pkv, pkv), (gq, gkv, gkv))(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap, want_lse=False)[0]
