"""Plain PyTorch version of the bit-pattern top-k kernel: the same
counting search, as tensor ops. The CPU path runs it, and the card's
kernel is held against it bit for bit.

The |u| bit patterns have their sign bit cleared, so they fit a
non-negative int32 and compare as int32 exactly as they would as uint32.
The search starts at bit 30: in int32 the bit-31 candidate is negative,
and ``bits >= INT_MIN`` would hold everywhere.
"""
from __future__ import annotations

import torch


def abs_bits(u: torch.Tensor) -> torch.Tensor:
    """float32 bit patterns of ``|u|`` as int32 (sign bit clear)."""
    return torch.abs(u.to(torch.float32)).view(torch.int32)


def topk_threshold_bits_ref(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Per-session threshold bits for a ``(B, ...)`` int32 |u|-bit buffer:
    the bit pattern of ``sort(|u|)[N-k]`` over each session, as (B,) int32.
    Zero padding never counts (every candidate is >= 1)."""
    flat = bits.reshape(bits.shape[0], -1)
    thr = torch.zeros(flat.shape[0], dtype=torch.int32, device=flat.device)
    for bit in range(30, -1, -1):
        cand = thr | (1 << bit)
        cnt = (flat >= cand[:, None]).sum(dim=1)
        thr = torch.where(cnt >= k, cand, thr)
    return thr


def topk_threshold_sort_ref(u_leaves, k: int) -> float:
    """The sort-path ground truth for ONE session's leaves."""
    flat = torch.cat([torch.abs(l.to(torch.float32)).reshape(-1)
                      for l in u_leaves])
    return float(torch.sort(flat).values[flat.numel() - k])
