"""Plain PyTorch version of the RWKV-6 wkv kernel: the chunked scan of
the JAX package's `models/ssm/rwkv6._wkv_chunked` (a `lax.scan` there, a
Python loop over time chunks here). The CPU path runs it, and the card's
kernel is held against it.

Within a chunk the in-chunk keys contribute through causal decay
products, the carried state through one matrix product. The decay is per
channel, so a chunk's decay products are (B, Lc, Lc, H, P), as in the
JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.models.ssm.mamba2 import chunk_len


def wkv6_ref(r, k, v, logw, u, chunk: int):
    """Chunked wkv. r,k,v,logw: (B,S,H,P) float32; u: (H,P). The chunk
    is the largest divisor of S up to ``chunk`` (`mamba2.chunk_len`).
    Returns y (B,S,H,P) float32 and the final state (B,H,P,P)."""
    B, S, H, P = r.shape
    Lc = chunk_len(S, chunk)
    u = u.to(torch.float32)
    strict = torch.ones((Lc, Lc), dtype=torch.bool, device=r.device).tril(-1)
    above = ~strict[None, :, :, None, None]
    y = torch.empty_like(r)
    S_prev = torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
    records = torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, logw))
    for c0 in range(0, S, Lc):
        sl = slice(c0, c0 + Lc)
        ri, ki, vi, wi = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]  # (B,Lc,H,P)
        cum_w = torch.cumsum(wi, dim=1)  # inclusive log decay
        # intra: y_i += sum_{j<i} r_i * exp(cum_w_{i-1} - cum_w_j) k_j * v_j
        #        + r_i * diag(u) k_i v_i  (bonus, j == i)
        # dec (B,i,j,H,P): exp overflows to inf on and above the diagonal,
        # where it is replaced by 0. In place, except where autograd
        # records: exp's backward reads its output, which the in-place
        # mask and products would overwrite. There the exponent is masked
        # to -inf first (the same values; a zero gradient, not 0 * inf).
        seg = cum_w[:, :, None] - cum_w[:, None, :]
        if records:
            dec = torch.exp((seg - wi[:, :, None]).masked_fill(above, -torch.inf))
            att = (dec * ri[:, :, None] * ki[:, None]).sum(-1)  # (B,i,j,H)
        else:
            dec = seg.sub_(wi[:, :, None]).exp_()
            dec.masked_fill_(above, 0.0)
            att = dec.mul_(ri[:, :, None]).mul_(ki[:, None]).sum(-1)
        del seg, dec
        y_intra = torch.einsum("bijh,bjhp->bihp", att, vi)
        bonus = (ri * u * ki).sum(-1)  # (B,Lc,H)
        y_intra = y_intra + bonus[..., None] * vi
        # inter: carried state, decayed from chunk start to i-1
        y_inter = torch.einsum("bihp,bhpq->bihq", ri * torch.exp(cum_w - wi), S_prev)
        # state update
        decay_to_end = torch.exp(cum_w[:, -1:] - cum_w)
        S_chunk = torch.einsum("bjhp,bjhq->bhpq", ki * decay_to_end, vi)
        S_prev = S_prev * torch.exp(cum_w[:, -1])[..., None] + S_chunk
        y[:, sl] = y_intra + y_inter
    return y, S_prev
