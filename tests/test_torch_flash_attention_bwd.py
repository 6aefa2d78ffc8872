"""The rounding design of K4-bwd's bf16 route (`csrc/flash_attention_bwd.cu`,
the wgmma kernels), emulated on the CPU and held to the card's contract.

The card runs the kernels themselves (`tests/test_torch_kernels_cuda.py`);
this file checks, on a host without one, that their arithmetic can meet
the contract at all: `wgmma_bwd_emulation` follows the kernels' tiles
(128-row q tiles over 64-row kv tiles for dQ, 64-row kv tiles over 64-row
q tiles for dK and dV, only the live ones), S and dP as float32 sums of
exact bf16 products chained over 16-column k-steps, P and dS in float32
as the kernels compute them, each split into `TERMS` bf16 terms for the
second products, every 16-row k-step of every term added into a float32
accumulator, dK and dV as per-q-head float32 partials summed over G in
order, the results rounded to bf16.

The contract is the card test's `_close_bf16_or_f32`: one bf16 ulp plus
1e-4 of the largest |value|. It holds against the port's plain backward
(`flash_attention_bwd_ref`), both fed the plain forward's bf16 output and
log-sum-exp, as the kernel is fed the forward kernel's; and against
``jax.vjp`` of the JAX package's attention reference in float64 when the
emulation is fed the forward's float32 output. (Fed the bf16 output, the
plain backward and the emulation alike miss the float64 gradient by up
to ~19x that tolerance on dQ and dK: D = rowsum(dO * O) takes O's
rounding.) This is where the split count was chosen: with one bf16 term
(2^-9 relative) dQ, dK and dV miss the contract in every case below; two
terms (2^-17) meet it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as attention_ref_jax
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from test_torch_flash_attention import _bf16_parts

TERMS = 2  # bf16 terms of P and dS in the kernels' second products
BQ, BK = 128, 64  # q rows of a dQ block; rows of every other tile

CASES = [  # B, Sq, Skv, KV, G, hd, causal, window, softcap
    (1, 300, 300, 1, 8, 256, True, 0, 0.0),    # Gemma 2B's heads, ragged S
    (1, 200, 200, 2, 2, 256, True, 0, 50.0),   # softcap
    (1, 260, 260, 2, 2, 64, True, 64, 30.0),   # window and softcap
    (2, 130, 70, 2, 2, 64, False, 0, 20.0),    # Sq > Skv, non-causal
    (1, 100, 230, 2, 2, 112, False, 0, 0.0),   # Sq < Skv, hd 112
    (1, 233, 100, 1, 8, 64, True, 0, 0.0),     # Sq > Skv, causal, G = 8
    (1, 96, 96, 2, 2, 112, True, 20, 50.0),    # a row's first live tile fully masked
]


def _steps(a, b, acc=None):
    """acc + a b^T over the last axis, 16 columns at a time: each k-step's
    products exact (float64 sums of products of bf16 values), the steps
    added in float32, as the tensor cores chain them."""
    for c in range(0, a.shape[-1], 16):
        step = (a[..., c:c + 16].double() @ b[..., c:c + 16].double().transpose(-1, -2)).float()
        acc = step if acc is None else acc + step
    return acc


def _accumulate(acc, a, x, terms):
    """acc + a x, the kernels' second product: a (float32, K = 64 columns)
    split into ``terms`` bf16 terms, x bf16 values; every 16-row k-step of
    every term added into the float32 accumulator."""
    for kk in range(0, a.shape[-1], 16):
        xs = x[..., kk:kk + 16, :].double()
        for part in _bf16_parts(a[..., kk:kk + 16], terms):
            acc = acc + (part.double() @ xs).float()
    return acc


def wgmma_bwd_emulation(q, k, v, o, lse, do, *, causal, window, softcap, terms=TERMS):
    """dq, dk, dv (bf16) as the bf16 wgmma kernels compute them, from bf16
    q (B, Sq, KV, G, hd), k, v (B, Skv, KV, hd), the forward's output o and
    row log-sum-exp lse (B, KV, G, Sq), and dO."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    pq, pk = -(-Sq // BQ) * BQ, -(-Skv // BK) * BK

    def heads(t, rows, pad):  # (B, S, KV[, G], hd) -> (B, KV, G or 1, pad, hd), zero rows
        t = t.float()
        t = t.permute(0, 2, 3, 1, 4) if t.dim() == 5 else t.permute(0, 2, 1, 3)[:, :, None]
        out = torch.zeros(*t.shape[:3], pad, hd)
        out[..., :rows, :] = t
        return out

    qf, dof, of = heads(q, Sq, pq), heads(do, Sq, pq), heads(o, Sq, pq)
    kf, vf = heads(k, Skv, pk), heads(v, Skv, pk)
    L = torch.zeros(B, KV, G, pq)
    L[..., :Sq] = lse
    D = (dof * of).sum(-1)  # float32, 0 past Sq
    scale = np.float32(hd ** -0.5)

    def probs(s, qi, kj, lq):
        """P and the softcap's factor 1 - t^2 (1 without one) of raw
        scores s at query positions qi and key positions kj."""
        x, fac = s * scale, 1.0
        if softcap:
            t = torch.tanh(x * np.float32(1 / softcap))
            x, fac = np.float32(softcap) * t, 1.0 - t * t
        live = (qi < Sq) & (kj < Skv)
        if causal:
            live = live & (qi >= kj)
        if window > 0:
            live = live & (qi - kj < window)
        return torch.where(live, torch.exp(x - lq), torch.tensor(0.0)), fac

    dq = torch.zeros(B, KV, G, pq, hd)
    for q0 in range(0, Sq, BQ):
        qi = torch.arange(q0, q0 + BQ)[:, None]
        hi = -(-Skv // BK)
        if causal:
            hi = min(hi, (min(q0 + BQ, Sq) - 1) // BK + 1)
        lo = max(q0 - window + 1, 0) // BK if window > 0 else 0
        rows = slice(q0, q0 + BQ)
        acc = torch.zeros(B, KV, G, BQ, hd)
        for k0 in range(lo * BK, hi * BK, BK):
            kt, vt = kf[..., k0:k0 + BK, :], vf[..., k0:k0 + BK, :]
            dp = _steps(dof[..., rows, :], vt)
            s = _steps(qf[..., rows, :], kt)
            p, fac = probs(s, qi, torch.arange(k0, k0 + BK)[None, :], L[..., rows, None])
            ds = p * (dp - D[..., rows, None]) * fac
            acc = _accumulate(acc, ds, kt, terms)
        dq[..., rows, :] = acc * scale

    dk_part, dv_part = torch.zeros(B, KV, G, pk, hd), torch.zeros(B, KV, G, pk, hd)
    for k0 in range(0, Skv, BK):
        kj = torch.arange(k0, k0 + BK)[:, None]
        lo = k0 // BK if causal else 0
        hi = -(-Sq // BK)
        if window > 0:
            hi = min(hi, (min(k0 + BK, Skv) - 1 + window - 1) // BK + 1)
        kt, vt = kf[..., k0:k0 + BK, :], vf[..., k0:k0 + BK, :]
        acc_k, acc_v = torch.zeros(B, KV, G, BK, hd), torch.zeros(B, KV, G, BK, hd)
        for q0 in range(lo * BK, hi * BK, BK):
            cols = slice(q0, q0 + BK)
            st = _steps(kt, qf[..., cols, :])    # S^T: kv rows, q columns
            dpt = _steps(vt, dof[..., cols, :])  # dP^T
            pt, fac = probs(st, torch.arange(q0, q0 + BK)[None, :], kj, L[..., None, cols])
            dst = (pt * fac) * (dpt - D[..., None, cols])
            acc_v = _accumulate(acc_v, pt, dof[..., cols, :], terms)
            acc_k = _accumulate(acc_k, dst, qf[..., cols, :], terms)
        dk_part[..., k0:k0 + BK, :] = acc_k * scale
        dv_part[..., k0:k0 + BK, :] = acc_v
    dk, dv = dk_part[:, :, 0], dv_part[:, :, 0]
    for g in range(1, G):  # the reduce kernel's order
        dk, dv = dk + dk_part[:, :, g], dv + dv_part[:, :, g]
    dq = dq[..., :Sq, :].permute(0, 3, 1, 2, 4)
    dk, dv = (t[..., :Skv, :].permute(0, 2, 1, 3) for t in (dk, dv))
    return tuple(t.contiguous().to(torch.bfloat16) for t in (dq, dk, dv))


def _within_contract(got, want) -> bool:
    """One bf16 ulp of ``want`` plus 1e-4 of its largest |value|: the card
    test's `_close_bf16_or_f32` for bf16."""
    g, w = got.double(), want.double()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    return bool(((g - w).abs() <= ulp + 1e-4 * float(w.abs().max())).all())


def _inputs(B, Sq, Skv, KV, G, hd, causal, window, softcap, seed=5):
    """(q, k, v, o, lse, dO) with N(0, 1) bf16 q, k, v, dO and the plain
    forward's bf16 output and log-sum-exp; the options; and the forward's
    float32 output and log-sum-exp."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.normal(size=(B, Sq, KV, G, hd))).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, Skv, KV, hd))).to(torch.bfloat16)
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    f32 = flash_attention_ref(q.float(), k.float(), v.float(), return_lse=True, **kw)
    return (q, k, v, o, lse, do), kw, f32


def _jax_grads(q, k, v, do, kw):
    """dq, dk, dv of the JAX package's attention reference by ``jax.vjp``,
    in float64, in the port's layouts."""
    B, Sq, KV, G, hd = q.shape
    qn, kn, vn, don = (t.double().numpy() for t in (q, k, v, do))
    with jax.enable_x64(True):
        qj = qn.transpose(0, 2, 3, 1, 4).reshape(B, KV * G, Sq, hd)
        kj, vj = kn.transpose(0, 2, 1, 3), vn.transpose(0, 2, 1, 3)
        doj = don.transpose(0, 2, 3, 1, 4).reshape(B, KV * G, Sq, hd)
        vjp = jax.jit(lambda a, b, c, d: jax.vjp(
            lambda x, y, z: attention_ref_jax(x, y, z, **kw), a, b, c)[1](d))
        dq, dk, dv = (np.asarray(t) for t in vjp(qj, kj, vj, jnp.asarray(doj)))
    return (torch.from_numpy(dq.reshape(B, KV, G, Sq, hd).transpose(0, 3, 1, 2, 4).copy()),
            torch.from_numpy(dk.transpose(0, 2, 1, 3).copy()),
            torch.from_numpy(dv.transpose(0, 2, 1, 3).copy()))


@pytest.mark.parametrize("B,Sq,Skv,KV,G,hd,causal,window,softcap", CASES)
def test_wgmma_bwd_design_meets_the_contract(B, Sq, Skv, KV, G, hd, causal, window,
                                             softcap):
    args, kw, (o32, lse32) = _inputs(B, Sq, Skv, KV, G, hd, causal, window, softcap)
    q, k, v, _, _, do = args
    got = wgmma_bwd_emulation(*args, **kw)
    plain = flash_attention_bwd_ref(*args, **kw)
    for name, a, p in zip(("dq", "dk", "dv"), got, plain):
        assert a.shape == p.shape and bool(torch.isfinite(a.float()).all())
        assert _within_contract(a, p), f"{name} against the plain backward"
    got = wgmma_bwd_emulation(q, k, v, o32, lse32, do, **kw)
    for name, a, t in zip(("dq", "dk", "dv"), got, _jax_grads(q, k, v, do, kw)):
        assert _within_contract(a, t), f"{name} against jax.vjp"


def test_one_bf16_term_misses_the_contract():
    """Why the kernels split P and dS into two terms: with one, every
    gradient misses the contract on Gemma 2B's heads."""
    args, kw, _ = _inputs(*CASES[0])
    plain = flash_attention_bwd_ref(*args, **kw)
    got = wgmma_bwd_emulation(*args, **kw, terms=1)
    assert not any(_within_contract(a, p) for a, p in zip(got, plain))
