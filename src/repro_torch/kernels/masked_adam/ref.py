"""Plain PyTorch version of the fused masked-Adam kernel: the float32
expression of `repro_torch.core.masked_adam.masked_adam_update`, over the
kernel's stacked buffers, and the JAX trainer's clip that the kernel can
apply first (`clip_ref`). The CPU path runs them, and the card's kernel
is held against them bit for bit."""
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


def clip_ref(g, gn, clip: float):
    """The JAX trainer's global-norm clip and non-finite guard
    (`src/repro/launch/train.py:59-69`) of a gradient buffer ``g``, given
    the global norm ``gn`` (float32, one value): ``scale = min(1, clip /
    max(gn, 1e-9))`` in float32 (a true division, as the kernel's
    ``__fdiv_rn``), then ``g * scale`` in float32 where both ``gn`` and
    that coordinate are finite and 0 elsewhere (a ``where``: 0 * nan is
    nan), cast back to g's dtype."""
    gn = gn.reshape(())
    scale = torch.clamp(torch.full_like(gn, clip) / torch.clamp(gn, min=1e-9), max=1.0)
    ok = torch.isfinite(gn)
    return torch.where(ok & torch.isfinite(g), g.to(torch.float32) * scale,
                       0.0).to(g.dtype)
