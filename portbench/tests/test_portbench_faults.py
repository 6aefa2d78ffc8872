"""Whole runs of the harness on the CPU, the look for a card skipped,
with the timed path broken underneath: each fault a cell can have makes
``correct`` false, and the same run unbroken is correct."""
from __future__ import annotations

import copy

import pytest
import torch

from portbench import harness

import repro_torch.models.transformer as tfm  # noqa: E402

DECODE = "whisper-smoke.transcribe_tiny"
PREFILL = "rwkv6-smoke.prefill_tiny"


def _run(root, cell):
    return harness.run_cell(harness.Bench(root), cell, 2**31 + 3, 0.05, False, "cpu")


def _logits_altered(monkeypatch):
    """Every step's logits rolled by one along the vocabulary where the
    model produces them: the served tokens follow them."""
    step, prefill = tfm.decode_step, tfm.prefill

    def decode_step(cfg, params, caches, tokens, pos):
        logits, caches = step(cfg, params, caches, tokens, pos)
        return logits.roll(1, dims=-1), caches

    monkeypatch.setattr(tfm, "decode_step", decode_step)
    monkeypatch.setattr(tfm, "prefill", lambda *a, **k: (lambda r: (r[0].roll(1, dims=-1),
                                                                   r[1]))(prefill(*a, **k)))


def _state_unchanged(monkeypatch):
    """Each decode step's cache writes lost: the step runs on a copy."""
    step = tfm.decode_step
    monkeypatch.setattr(tfm, "decode_step",
                        lambda cfg, params, caches, tokens, pos:
                        (step(cfg, params, copy.deepcopy(caches), tokens, pos)[0], caches))


def _chunk_state_unchanged(monkeypatch):
    """The wkv chunk loop's carried state left at its start: each chunk
    sees none of the chunks before it."""
    from repro_torch.models.ssm import rwkv6

    scan = rwkv6._wkv_chunked

    def chunked(r, k, v, logw, u, chunk):
        parts = [scan(*(a[:, i:i + chunk] for a in (r, k, v, logw)), u, chunk)
                 for i in range(0, r.shape[1], chunk)]
        return torch.cat([p[0] for p in parts], dim=1), parts[-1][1]

    monkeypatch.setattr(rwkv6, "_wkv_chunked", chunked)


def _half_batch(monkeypatch):
    """The prefill runs the first half of the rows only; the second half
    gets the first half's results."""
    prefill = tfm.prefill

    def half(cfg, params, tokens, cache_len, memory=None):
        h = tokens.shape[0] // 2
        logits, caches = prefill(cfg, params, tokens[:h], cache_len,
                                 None if memory is None else memory[:h])
        caches = {b: {k: torch.cat([t, t], dim=1) for k, t in c.items()} for b, c in
                  caches.items()}
        return torch.cat([logits, logits]), caches

    monkeypatch.setattr(tfm, "prefill", half)


class _ArgmaxPlusOne:
    """`torch` for `launch.serve`, its argmax moved to the next id."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def argmax(x, dim):
        return (torch.argmax(x, dim=dim) + 1) % x.shape[dim]


def _token_altered(monkeypatch):
    """The served tokens moved to the next id where they are produced,
    their logits left as computed: the prefill's in `serve`, each decode
    step's in its step."""
    import repro_torch.launch.serve as serve_mod

    monkeypatch.setattr(serve_mod, "torch", _ArgmaxPlusOne())
    make = serve_mod.make_serve_step

    def make_serve_step(model):
        step = make(model)

        def serve_step(params, caches, batch):
            tok, caches, logits = step(params, caches, batch)
            return (tok + 1) % logits.shape[-1], caches, logits
        return serve_step

    monkeypatch.setattr(serve_mod, "make_serve_step", make_serve_step)


FAULTS = [(DECODE, _token_altered), (PREFILL, _token_altered), (DECODE, _logits_altered),
          (PREFILL, _logits_altered), (DECODE, _state_unchanged),
          (PREFILL, _chunk_state_unchanged), (DECODE, _half_batch), (PREFILL, _half_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_makes_run_incorrect(smoke_root, monkeypatch, cell, fault):
    assert _run(smoke_root, cell)["correct"]
    fault(monkeypatch)
    r = _run(smoke_root, cell)
    assert not r["correct"], r["checks"]
    if fault is _token_altered:  # the logits are right: the token check alone fails
        assert r["checks"]["logits_rel"]["value"] <= r["checks"]["logits_rel"]["limit"]
        assert r["checks"]["token_excess"]["value"] > 0
