"""The closed-loop traffic driver, which every mix under this folder
with ``"driver": "closed_loop"`` names.

One caller sends a batch of requests, waits for every answer, and sends
the next: a slow call delays the ones after it, as in a server whose
pool takes the next batch when the last is done. A mix gives the batch
(``batch``), the prompt tokens of each request (``prompt_tokens``), the
frames its cross-attention reads (``memory_positions``, 0 for none) and
the tokens decoded after the prefill's (``new_tokens``). Call i's
inputs are drawn on the device from a generator seeded with
`call_seed` (seed, i): token ids uniform over the vocabulary, frames
N(0, 1) in the compute dtype. Every seed gets the same sizes.
"""
from __future__ import annotations

import hashlib
import time

import torch


def call_seed(seed: int, i: int) -> int:
    """A 63-bit seed for call ``i`` of run ``seed`` (i = -1: the warm-up)."""
    digest = hashlib.sha256(f"portbench-inputs:{seed}:{i}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


class Traffic:
    def __init__(self, mix: dict, model: dict, seed: int, device, dtype: torch.dtype):
        self.batch = int(mix["batch"])
        self.prompt_tokens = int(mix["prompt_tokens"])
        self.memory_positions = int(mix["memory_positions"])
        self.new_tokens = int(mix["new_tokens"])
        if min(self.batch, self.prompt_tokens) < 1 or min(self.memory_positions,
                                                          self.new_tokens) < 0:
            raise ValueError(f"traffic sizes out of range: {mix}")
        self.vocab, self.d_model = int(model["vocab_size"]), int(model["d_model"])
        self.seed, self.device, self.dtype = seed, device, dtype

    @property
    def positions_per_call(self) -> int:
        """Input positions a call prefills: prompt tokens and frames."""
        return self.batch * (self.prompt_tokens + self.memory_positions)

    @property
    def tokens_per_call(self) -> int:
        """Tokens a call returns: the prefill's, then one a decode step."""
        return self.batch * (self.new_tokens + 1)

    def inputs(self, i: int):
        """Call i's (prompt (B, S) int64, memory (B, Sm, d) or None)."""
        gen = torch.Generator(device=self.device).manual_seed(call_seed(self.seed, i))
        prompt = torch.randint(0, self.vocab, (self.batch, self.prompt_tokens),
                               generator=gen, device=self.device)
        memory = None
        if self.memory_positions:
            memory = torch.randn((self.batch, self.memory_positions, self.d_model),
                                 generator=gen, device=self.device, dtype=self.dtype)
        return prompt, memory

    def drive(self, call, seconds: float):
        """``call(i)`` for i = 0, 1, ... back to back, until the first
        call that ends ``seconds`` or more after the first began. Returns
        (the calls' records, the window's seconds: from the first call's
        start to the last one's end)."""
        records = []
        t0 = time.perf_counter()
        while True:
            records.append(call(len(records)))
            window = time.perf_counter() - t0
            if window >= seconds:
                return records, window
