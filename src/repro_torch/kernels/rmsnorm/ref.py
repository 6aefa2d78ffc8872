"""Plain PyTorch version of the RMSNorm kernel: the JAX package's
`models/layers.rms_norm`, ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in
float32, cast back to x's dtype. The CPU path runs it, and the card's
kernel is held against it."""
from __future__ import annotations

import torch


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
    return out.to(dt)
