"""Plain PyTorch versions of the flash-attention kernels.

`flash_attention_ref` is the JAX package's `kernels/flash_attention/ref.py`,
a naive softmax over the whole score matrix with the finite ``NEG_INF =
-1e30`` for masked scores, in the model's ``(B, S, KV, G, hd)`` layout.
The CPU path runs it, and the card's forward kernel is held against it.
Its score matrix is ``B*H*Sq*Skv`` float32, so it takes O(S^2) memory.

`flash_attention_bwd_ref` is the backward kernel's plain version: the
explicit formulas for dq, dk and dv from the forward's output and its
row log-sum-exp, not autograd. The JAX package differentiates its plain
attention with ``jax.value_and_grad`` and has no backward kernel; the
formulas are that gradient written out.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(q, k, *, causal, window, softcap, keep_tanh=False):
    """float32 scores (B, KV, G, Sq, Skv): scaled, softcapped and masked;
    tanh(s / softcap) with ``keep_tanh`` (else None); and the mask.

    Where autograd records (grad mode on and an input requires grad), the
    softcap and the mask are applied out of place, so that backward can
    read the tensors they were applied to; otherwise in place, which saves
    a score matrix of memory. Both forms run the same operations in the
    same order, so their values are equal bit for bit."""
    Sq, hd = q.shape[1], q.shape[-1]
    Skv = k.shape[1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.to(torch.float32),
                     k.to(torch.float32))
    s.mul_(hd**-0.5)
    records = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad)
    t = None
    if softcap:
        if records or keep_tanh:
            t = torch.tanh(s / softcap)
            s = softcap * t
        else:
            s.div_(softcap).tanh_().mul_(softcap)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    if records:
        s = s.masked_fill(~mask, NEG_INF)
    else:
        s.masked_fill_(~mask, NEG_INF)
    return s, (t if keep_tanh else None), mask


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        return_lse=False):
    """q: (B,Sq,KV,G,hd); k, v: (B,Skv,KV,hd). Returns (B,Sq,KV,G,hd) in
    q's dtype and, with ``return_lse``, the float32 row log-sum-exp of
    the masked scores, (B, KV, G, Sq), which the backward reads."""
    s, _, _ = _scores(q, k, causal=causal, window=window, softcap=softcap)
    lse = torch.logsumexp(s, dim=-1) if return_lse else None
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32)).to(q.dtype)
    return (out, lse) if return_lse else out


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=0,
                            softcap=0.0):
    """dq, dk, dv of `flash_attention_ref` at (q, k, v) for the output
    gradient ``do``, from its output ``o`` and row log-sum-exp ``lse``
    (B, KV, G, Sq), in float32, each returned in its input's dtype:

        P   = exp(s - lse)
        dV  = sum_g P^T dO
        dP  = dO V^T,   D = rowsum(dO * O)
        dS  = P * (dP - D) * (1 - tanh^2(s_raw / softcap) with a softcap),
              0 where masked
        dQ  = hd^-0.5 * dS K,   dK = hd^-0.5 * sum_g dS^T Q

    A masked score is -1e30, so its P is 0 unless its whole row is
    masked; such a row is uniform over its keys in the forward, and here
    too."""
    hd = q.shape[-1]
    with torch.no_grad():
        s, t, mask = _scores(q, k, causal=causal, window=window, softcap=softcap,
                              keep_tanh=True)
        p = torch.exp(s - lse.to(torch.float32)[..., None])
        del s
        do32 = do.to(torch.float32)
        dv = torch.einsum("bkgqs,bqkgh->bskh", p, do32)
        dp = torch.einsum("bqkgh,bskh->bkgqs", do32, v.to(torch.float32))
        d = torch.einsum("bqkgh,bqkgh->bkgq", do32, o.to(torch.float32))
        ds = p.mul_(dp.sub_(d[..., None]))
        del dp
        ds.masked_fill_(~mask, 0.0)
        if softcap:
            ds.mul_(1.0 - t * t)
        ds.mul_(hd**-0.5)
        dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.to(torch.float32))
        dk = torch.einsum("bkgqs,bqkgh->bskh", ds, q.to(torch.float32))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
