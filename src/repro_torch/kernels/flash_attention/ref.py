"""Plain PyTorch version of the flash-attention kernel: the JAX package's
`kernels/flash_attention/ref.py`, a naive softmax over the whole score
matrix with the finite ``NEG_INF = -1e30`` for masked scores, in the
model's ``(B, S, KV, G, hd)`` layout. The CPU path runs it, and the
card's kernel is held against it. Its score matrix is
``B*H*Sq*Skv`` float32, so it takes O(S^2) memory."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B,Sq,KV,G,hd); k, v: (B,Skv,KV,hd). Returns (B,Sq,KV,G,hd) in
    q's dtype."""
    Sq, hd = q.shape[1], q.shape[-1]
    Skv = k.shape[1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32),
                     k.to(torch.float32))
    s.mul_(hd**-0.5)
    if softcap:
        s.div_(softcap).tanh_().mul_(softcap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    s.masked_fill_(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    return out.to(q.dtype)
