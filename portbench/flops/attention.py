"""Operations and bytes of one attention call (the port's K4), from its
shapes: 4 hd operations for each live (query, key) pair of each query
head (Q K^T and P V; the softmax left out), and q, k and v read once and
the output written once, in bfloat16. Under the causal mask the queries
are the last Sq of Skv positions: query i sees Skv - Sq + i + 1 keys."""
from __future__ import annotations


def pairs(Sq: int, Skv: int, causal: bool) -> int:
    if not causal:
        return Sq * Skv
    return sum(min(Skv, Skv - Sq + i + 1) for i in range(Sq))


def cost(call: dict, elem_bytes: int = 2) -> tuple[int, int]:
    """(operations, bytes) of one call: q (B, Sq, H, hd), k and v (B,
    Skv, KV, hd), the output (B, Sq, H, hd)."""
    B, H, KV, hd, Sq, Skv = (call[k] for k in ("B", "H", "KV", "hd", "Sq", "Skv"))
    flops = 4 * hd * H * B * pairs(Sq, Skv, call["causal"])
    nbytes = elem_bytes * B * hd * (2 * Sq * H + 2 * Skv * KV)
    return flops, nbytes
