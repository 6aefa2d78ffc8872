"""Plain PyTorch version of the fused masked-Adam kernel: the float32
expression of `repro_torch.core.masked_adam.masked_adam_update`, over the
kernel's stacked buffers. The CPU path runs it, and the card's kernel is
held against it bit for bit."""
from __future__ import annotations

import torch


def masked_adam_ref(p, g, m, v, mask, bc, *, b1: float, b2: float,
                    eps: float):
    """One step over ``(B, ...)`` buffers with ``bc`` of shape (B,).
    Returns ``(p', m', v', u)``: p', m', v' in their source dtypes and u
    in float32."""
    bc = bc.reshape((-1,) + (1,) * (p.dim() - 1))
    g32 = g.to(torch.float32)
    m_new = b1 * m.to(torch.float32) + (1.0 - b1) * g32
    v_new = b2 * v.to(torch.float32) + (1.0 - b2) * (g32 * g32)
    u = bc * m_new / torch.sqrt(v_new + eps)
    p_new = (p.to(torch.float32) - u * mask.to(torch.float32)).to(p.dtype)
    return p_new, m_new.to(m.dtype), v_new.to(v.dtype), u
