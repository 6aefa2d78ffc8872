"""Drifting synthetic token streams (a numpy copy of the JAX package's
`data/tokens.py`; the port keeps its own) — the LLM-world analogue of the video
generator: a Markov source whose transition structure rotates slowly over
time, so a one-time-adapted student decays and a continually-adapted one
tracks (same phenomenology the paper exploits for video)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class StreamConfig:
    vocab_size: int = 512
    order_states: int = 64  # latent Markov states
    drift_period: float = 600.0  # seconds for a full structure rotation
    tokens_per_second: float = 64.0
    temperature: float = 0.7
    seed: int = 0


class TokenStream:
    def __init__(self, cfg: StreamConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        k, v = cfg.order_states, cfg.vocab_size
        self.state_emit_a = rng.normal(size=(k, v)).astype(np.float32)
        self.state_emit_b = rng.normal(size=(k, v)).astype(np.float32)
        self.trans = rng.dirichlet(0.3 * np.ones(k), size=k).astype(np.float32)
        self.tok2state = rng.integers(0, k, size=v)

    def _emit_logits(self, state: np.ndarray, t: float) -> np.ndarray:
        # structure drifts by interpolating between two emission tables
        phase = 0.5 * (1 + np.sin(2 * np.pi * t / self.cfg.drift_period))
        return (1 - phase) * self.state_emit_a[state] + phase * self.state_emit_b[state]

    def sample(self, rng: np.random.Generator, batch: int, seq: int, t: float):
        """Returns (tokens (B,S+1) int32): context + next-token labels are
        tokens[:, :-1] / tokens[:, 1:]."""
        cfg = self.cfg
        state = rng.integers(0, cfg.order_states, size=batch)
        out = np.empty((batch, seq + 1), np.int64)
        out[:, 0] = rng.integers(0, cfg.vocab_size, size=batch)
        for i in range(1, seq + 1):
            logits = self._emit_logits(state, t) / cfg.temperature
            logits -= logits.max(axis=-1, keepdims=True)
            p = np.exp(logits)
            p /= p.sum(axis=-1, keepdims=True)
            cum = np.cumsum(p, axis=-1)
            r = rng.random((batch, 1))
            out[:, i] = (r < cum).argmax(axis=-1)
            state = self.tok2state[out[:, i]]
        return out.astype(np.int32)
