"""Wrapper for the flash-attention kernels (``csrc/flash_attention.cu``), in
the model's ``(B, S, KV, G, hd)`` layout (the JAX package's
`kernels/flash_attention/ops.flash_attention_pallas`).

The route is chosen by the tensors' device and dtype, and none falls back
to another:

* a bfloat16 CUDA tensor launches the tensor-core kernel (``wgmma`` with
  TMA loads through tensor maps over the given strides), or the wrapper
  raises;
* a float32 CUDA tensor launches the CUDA-core kernel, or the wrapper
  raises;
* a CPU tensor takes the plain version, `ref.flash_attention_ref`.

Both kernels read q, k and v through their strides, so the model's
projections go in without a transpose, and write a contiguous output.
They take head dims 64, 112 (Zamba2-7B's), 128 and 256 (`HEAD_DIMS`).

``launches`` counts kernel launches of both routes (plain-version calls do
not count); ``launches_by_route`` counts them per route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

launches = 0
# dtype -> (route name, C entry point)
ROUTES = {torch.bfloat16: ("bf16_wgmma", "flash_attention_fwd_bf16"),
          torch.float32: ("f32_cuda_cores", "flash_attention_fwd_f32")}
launches_by_route = {name: 0 for name, _ in ROUTES.values()}

# the head dims the kernels take: instantiations of both routes, but the
# bf16 route runs 112 as its 128 instantiation over 112-wide tensor maps
# (TMA zero-fills columns 112..127 and drops them on the store)
HEAD_DIMS = (64, 112, 128, 256)
TMA_Q_ROWS = 128            # q rows per block of the bf16 kernel
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.POINTER(ctypes.c_longlong)]
             + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
             + [ctypes.c_int, ctypes.c_void_p])


def reset_launches() -> None:
    """Set the total and every per-route count to 0."""
    global launches
    launches = 0
    for name in launches_by_route:
        launches_by_route[name] = 0


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
                or t.data_ptr() % 16):
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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (B,Sq,KV,G,hd); k, v: (B,Skv,KV,hd). Returns (B,Sq,KV,G,hd) in
    q's dtype: softmax attention with float32 scores and accumulation,
    ``hd**-0.5`` scaling, an optional tanh softcap and causal /
    sliding-window masks."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v)
    route, entry = ROUTES[q.dtype]
    b, sq, kv, g, hd = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
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
             q.device.index, stream.cuda_stream)
    build.check(lib, err, f"flash_attention launch ({route})")
    launches += 1
    launches_by_route[route] += 1
    return out
