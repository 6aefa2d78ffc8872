"""Wrappers for the bit-pattern top-k kernel (``csrc/topk_mask.cu``).

`topk_threshold_bits` is the kernel's own wrapper: per-session exact
threshold bits over a ``(B, rows, 128)`` buffer of |u| bit patterns. A
CUDA tensor launches the kernel (or the wrapper raises on what the kernel
does not take); a CPU tensor takes the plain version,
`ref.topk_threshold_bits_ref`. `stacked_topk_masks` is the selection
path's entry: it lays a B-stacked |u| tree out into that buffer, finds the
thresholds, and builds the masks with a float ``|u| >= thr`` compare on
the original leaves, so the masks equal the sort path's by construction.

The kernel is an exact radix select: one launch per digit of
`DIGIT_BITS` (bits 30..0, widest first), each over many blocks per
session, with histograms, counters and prefixes in scratch that the
wrapper allocates zeroed. Any digit schedule returns the counting
search's bits; `tests/test_torch_topk_radix.py` follows this one in numpy.

Size: the kernel streams each session's bits from global memory on every
pass, so it has no on-chip budget; its counts are 32-bit ints, so it
takes fewer than ``2**31`` coordinates per session, and the wrapper
raises above that, and for ``k`` above the coordinates of a session. The
selection path hands it at most `repro_torch.core.selection._SMALL` per
session and takes bisection above.

``launches`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import tree
from repro_torch.kernels import build, stacking
from repro_torch.kernels.topk_mask.ref import abs_bits, topk_threshold_bits_ref

_MAX_PER_SESSION = 2**31 - 1  # the kernel's int counts
_MAX_SESSIONS = 65535         # the grid's y dimension
DIGIT_BITS = (11, 10, 10)     # the kernel's digits, from bit 30 down

launches = 0

_DIGITS = ctypes.c_int * len(DIGIT_BITS)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, _DIGITS, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = build.load("topk_mask")
    lib.topk_threshold_bits.argtypes = _ARGTYPES
    lib.topk_threshold_bits.restype = ctypes.c_int
    lib.topk_scratch_words.argtypes = [_DIGITS, ctypes.c_int]
    lib.topk_scratch_words.restype = ctypes.c_longlong
    lib.topk_blocks_per_session.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int]
    lib.topk_blocks_per_session.restype = ctypes.c_int
    return lib


def blocks_per_session(bits: torch.Tensor) -> int:
    """Blocks per session of the kernel's grid for this CUDA buffer."""
    b, rows, lanes = bits.shape
    return _lib().topk_blocks_per_session(rows * lanes, b, bits.device.index)


def topk_threshold_bits(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Exact per-session threshold bits, (B,) int32, for ``bits`` of shape
    ``(B, rows, 128)`` int32 (|u| bit patterns, zero-padded)."""
    global launches
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if bits.device.type == "cpu":
        return topk_threshold_bits_ref(bits, k)
    if bits.device.type != "cuda":
        raise ValueError(f"topk_threshold_bits runs on cuda or cpu, not "
                         f"{bits.device}")
    if (bits.dtype != torch.int32 or bits.dim() != 3
            or bits.shape[2] != stacking.LANES):
        raise ValueError(f"bits must be (B, rows, {stacking.LANES}) int32, "
                         f"got {tuple(bits.shape)} {bits.dtype}")
    if not bits.is_contiguous() or bits.data_ptr() % 16:
        raise ValueError("bits must be contiguous and 16-byte aligned")
    b, rows, lanes = bits.shape
    n = rows * lanes
    if n > _MAX_PER_SESSION:
        raise ValueError(f"{n} coordinates per session overflow "
                         f"the kernel's int counts (at most {_MAX_PER_SESSION})")
    if k > n:
        raise ValueError(f"k = {k} exceeds the {n} coordinates of a session")
    if b > _MAX_SESSIONS:
        raise ValueError(f"{b} sessions exceed the kernel's grid ({_MAX_SESSIONS})")
    out = torch.empty(b, dtype=torch.int32, device=bits.device)
    lib = _lib()
    digits = _DIGITS(*DIGIT_BITS)
    scratch = torch.zeros(b * lib.topk_scratch_words(digits, len(DIGIT_BITS)),
                          dtype=torch.int32, device=bits.device)
    stream = torch.cuda.current_stream(bits.device)
    err = lib.topk_threshold_bits(bits.data_ptr(), n, k, b, digits, len(DIGIT_BITS),
                                  scratch.data_ptr(), out.data_ptr(),
                                  bits.device.index, stream.cuda_stream)
    build.check(lib, err, "topk_threshold_bits launch")
    launches += 1
    return out


def selection_count(per_session: int, frac: float) -> int:
    """``k = max(int(frac * n), 1)``, n summed over every dtype group."""
    return max(int(frac * per_session), 1)


def abs_bits_buffer(u_stacked):
    """The ``(B, rows, 128)`` int32 |u| bit buffer of a B-stacked tree:
    every leaf, in the float32 plan's group order, zero-padded."""
    # the plan of the float32 view of the tree: one group, flatten order
    plan = stacking.stack_plan(tree.tree_map(
        lambda l: torch.empty(l.shape, dtype=torch.float32, device="meta"),
        u_stacked))
    (group,) = plan.groups
    return stacking.flatten_group(tree.leaves(u_stacked), group, plan.b,
                                  transform=abs_bits), group.n


def masks_from_threshold(u_stacked, thr_bits: torch.Tensor):
    """The stacked bool masks ``|u| >= thr`` (float compare) for per-session
    threshold bits ``thr_bits`` (B,) int32."""
    thr = thr_bits.view(torch.float32)

    def leaf_mask(l):
        t = thr.reshape((-1,) + (1,) * (l.dim() - 1))
        return torch.abs(l.to(torch.float32)) >= t

    return tree.tree_map(leaf_mask, u_stacked)


def stacked_topk_masks(u_stacked, frac: float):
    """Per-session gradient-guided masks for a B-stacked update tree, from
    one threshold launch. Same threshold as the sort path
    (``sort(|u|)[N-k]``, exactly) and the same float compare, so the masks
    are byte-identical to it."""
    bits, n = abs_bits_buffer(u_stacked)
    thr_bits = topk_threshold_bits(bits, selection_count(n, frac))
    return masks_from_threshold(u_stacked, thr_bits)
