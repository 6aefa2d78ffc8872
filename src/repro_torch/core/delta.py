"""Sparse model-update codec (§3.1.2, downlink payload).

A ModelDelta carries the new values of masked coordinates as fp16, plus
one global gzip'd bit-vector marking their positions — the paper's wire
format. Leaves are concatenated in flatten order (sorted dict keys), the
JAX package's order, so the bytes of a delta are the same in both
packages for the same params and mask.

With `core.timing` on, the two encoders record stages ``encode_solo`` and
``encode_stacked`` (key ``(B,)``) with the wire bytes they produced, as
in the JAX package.
"""
from __future__ import annotations

import gzip
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import timing

_TORCH_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                 "float32": torch.float32}


@dataclass
class ModelDelta:
    values: np.ndarray  # concatenated masked values (value_dtype)
    packed_mask: bytes  # gzip'd packed bit-vector over the flat param space
    n_total: int  # total parameter count (for unpacking)
    value_dtype: str = "float16"

    # --- wire accounting -------------------------------------------------
    @property
    def value_bytes(self) -> int:
        return self.values.nbytes

    @property
    def mask_bytes(self) -> int:
        return len(self.packed_mask)

    @property
    def total_bytes(self) -> int:
        return self.value_bytes + self.mask_bytes


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _pack_mask_bits(flat_m: np.ndarray) -> bytes:
    """gzip'd packed bit-vector over one flat bool mask — the wire format.

    mtime=0 pins the 4-byte gzip MTIME header field: the wire encoding is
    a pure function of the mask."""
    return gzip.compress(np.packbits(flat_m).tobytes(), compresslevel=6,
                         mtime=0)


# (structure, wire dtype) keys already encoded stacked: the first call per
# key lands in the timing's first-call bucket
_STACK_SEEN: set = set()


def encode_delta(params_new, mask, value_dtype="float16") -> ModelDelta:
    """One session's delta: masked values gathered leaf by leaf on the
    host, then cast to ``value_dtype``."""
    if not timing.enabled():
        return _encode_delta(params_new, mask, value_dtype)
    t0 = time.perf_counter()
    d = _encode_delta(params_new, mask, value_dtype)
    # host work (the pulls synchronise the device): no first-call split
    timing.record("encode_solo", time.perf_counter() - t0,
                  nbytes=d.total_bytes)
    return d


def _encode_delta(params_new, mask, value_dtype) -> ModelDelta:
    p_leaves = tree.leaves(params_new)
    m_leaves = tree.leaves(mask)
    n_total = sum(l.numel() for l in p_leaves)
    flat_m = np.concatenate([_to_numpy(m).reshape(-1).astype(bool)
                             for m in m_leaves]) if m_leaves else np.zeros(0, bool)
    picked = [_to_numpy(p).reshape(-1)[_to_numpy(m).reshape(-1).astype(bool)]
              for p, m in zip(p_leaves, m_leaves)]
    values = (np.concatenate(picked) if picked
              else np.zeros((0,))).astype(value_dtype)
    return ModelDelta(values=values, packed_mask=_pack_mask_bits(flat_m),
                      n_total=n_total, value_dtype=value_dtype)


def encode_delta_stack(params_stacked, mask_stacked, n_sessions: int,
                       value_dtype="float16") -> list[ModelDelta]:
    """B sessions' deltas from stacked trees in one device round trip.

    The cast to ``value_dtype`` and the flattening run on the device over
    the whole stack, then ONE pull each lands ``(B, n_total)`` values and
    mask bits on the host. Each delta is byte-identical to
    ``encode_delta(params_b, mask_b, value_dtype)``: the cast commutes
    with the gather elementwise."""
    dt = _TORCH_DTYPES[str(value_dtype)]
    p_leaves = tree.leaves(params_stacked)
    n_total = sum(l[0].numel() for l in p_leaves)
    on = timing.enabled()
    if on:
        key = (tree.struct(params_stacked), str(value_dtype))
        first = key not in _STACK_SEEN
        _STACK_SEEN.add(key)
        t0 = time.perf_counter()
    vals = _to_numpy(torch.cat([l.reshape(l.shape[0], -1).to(dt)
                                for l in p_leaves], dim=1))
    bits = _to_numpy(torch.cat([l.reshape(l.shape[0], -1).to(torch.bool)
                                for l in tree.leaves(mask_stacked)], dim=1))
    out = [ModelDelta(values=vals[b][bits[b]],
                      packed_mask=_pack_mask_bits(bits[b]),
                      n_total=n_total, value_dtype=value_dtype)
           for b in range(n_sessions)]
    if on:
        timing.record("encode_stacked", time.perf_counter() - t0,
                      first=first, key=(n_sessions,),
                      nbytes=sum(d.total_bytes for d in out))
    return out


def apply_delta(params_old, delta: ModelDelta):
    """Edge-side: overwrite masked coordinates with streamed values. Returns
    a new tree; ``params_old`` is not modified."""
    flat_m = np.unpackbits(
        np.frombuffer(gzip.decompress(delta.packed_mask), np.uint8)
    )[: delta.n_total].astype(bool)
    leaves, treedef = tree.flatten(params_old)
    out, off_p, off_v = [], 0, 0
    vals = delta.values
    for leaf in leaves:
        n = leaf.numel()
        m = flat_m[off_p: off_p + n]
        k = int(m.sum())
        flat = leaf.detach().reshape(-1).clone()
        if k:
            idx = torch.from_numpy(np.nonzero(m)[0]).to(leaf.device)
            new = torch.from_numpy(vals[off_v: off_v + k]).to(leaf.device)
            flat[idx] = new.to(leaf.dtype)
        out.append(flat.reshape(leaf.shape))
        off_p += n
        off_v += k
    if off_p != delta.n_total or off_v != vals.size:
        raise ValueError(f"delta covers {delta.n_total} coords / {vals.size} "
                         f"values, tree has {off_p} / used {off_v}")
    return tree.unflatten(treedef, out)


def full_model_bytes(params, value_dtype="float16") -> int:
    """Wire cost of a naive full-model update (the paper's 3.2 Mbps case)."""
    return sum(l.numel() for l in tree.leaves(params)) * np.dtype(value_dtype).itemsize
