"""Plain PyTorch versions of the RMSNorm kernels: the JAX package's
`models/layers.rms_norm`, ``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in
float32, cast back to x's dtype, and its backward written out (the JAX
package differentiates the forward with ``jax.value_and_grad`` and has no
backward kernel). The CPU path runs them, and the card's kernels are held
against them."""
from __future__ import annotations

import torch


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
    return out.to(dt)


def rms_norm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-6):
    """(dx, dw) of `rms_norm_ref` at (x, w) for the output gradient dy, in
    float32, dx in x's dtype and dw in w's:

        r  = rsqrt(mean(x^2) + eps)
        dx = r (1 + w) dy - x r^3 mean((1 + w) dy x)
        dw = sum over rows of dy x r
    """
    d = x.shape[-1]
    x32 = x.to(torch.float32).reshape(-1, d)
    dy32 = dy.to(torch.float32).reshape(-1, d)
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    gw = (1.0 + w.to(torch.float32)) * dy32
    c = torch.mean(gw * x32, dim=-1, keepdim=True)
    dx = r * gw - x32 * (r * r * r) * c
    dw = torch.sum(dy32 * x32 * r, dim=0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(w.dtype)
