"""The port's span recorder (`repro_torch.core.timing.span`, `spans`) on
the served path, on the CPU: the span tree of one smoke-config `serve`
call, nothing recorded and no clock read while spans are off, and the
served tokens and logits the same with spans on and off."""
from __future__ import annotations

from collections import Counter

import pytest
import torch

import repro_torch.launch.serve as serve_mod
from repro_torch.configs import get_smoke
from repro_torch.core import timing
from repro_torch.models.registry import build

B, S, N = 2, 8, 3  # batch, prompt tokens, decode steps


def _inputs(arch: str):
    cfg = get_smoke(arch)
    gen = torch.Generator().manual_seed(0)
    params = build(cfg).init(gen, "cpu")
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    memory = None
    if cfg.num_xattn_tokens:
        memory = torch.randn((B, cfg.num_xattn_tokens, cfg.d_model), generator=gen)
    return cfg, params, prompt, memory


def _serve(arch: str):
    cfg, params, prompt, memory = _inputs(arch)
    return cfg, serve_mod.serve(cfg, params, prompt, N, "cpu", memory=memory)


def _tree(records) -> list[tuple]:
    """(name, parent's name) of each record, in the order they began."""
    return [(r.name, None if r.parent is None else records[r.parent].name) for r in records]


@pytest.mark.parametrize("arch,scan", [("whisper-large-v3", None), ("rwkv6-3b", "rwkv6"),
                                       ("zamba2-7b", "mamba2")])
def test_one_serve_call_span_tree(arch, scan):
    with timing.spans() as records:
        cfg, r = _serve(arch)
    tree = _tree(records)
    counts = Counter(tree)
    assert tree[0] == ("serve.call", None) and tree[1] == ("serve.prefill", "serve.call")
    assert {rec.call for rec in records} == {0}
    assert records[0].attrs == {"batch": B, "prompt_tokens": S, "new_tokens": N,
                                "memory_positions": cfg.num_xattn_tokens}
    assert counts[("serve.prefill", "serve.call")] == 1
    assert counts[("serve.decode_step", "serve.call")] == N
    if arch == "whisper-large-v3":  # an encoder; self and cross attention in each layer
        assert counts[("transformer.encode", "serve.prefill")] == 1
        for name in ("attention.decode_self", "attention.decode_cross"):
            assert counts[(name, "serve.decode_step")] == cfg.num_layers * N
    else:
        chunked, step = {"rwkv6": ("rwkv6.wkv_chunked", "rwkv6.wkv_step"),
                         "mamba2": ("mamba2.ssd_chunked", "mamba2.ssd_step")}[scan]
        layers = sum(kind in ("rwkv", "mamba") for kind in cfg.pattern) * cfg.num_groups
        assert counts[(chunked, "serve.prefill")] == layers
        assert counts[(step, "serve.decode_step")] == layers * N
    assert len(records) == sum(counts.values())
    for rec in records:
        assert rec.device_ms is None  # no CUDA events on the CPU
        assert rec.start_ns <= rec.end_ns
        if rec.parent is not None:
            parent = records[rec.parent]
            assert parent.start_ns <= rec.start_ns and rec.end_ns <= parent.end_ns
    # serve.prefill lies inside the interval prefill_ms times, the steps inside the decode's
    ms = {name: sum(rec.end_ns - rec.start_ns for rec in records if rec.name == name) / 1e6
          for name in ("serve.prefill", "serve.decode_step")}
    assert 0 < ms["serve.prefill"] <= r["prefill_ms"] * 1.01
    assert 0 < ms["serve.decode_step"] <= r["decode_ms_per_token"] * N * 1.01


def test_spans_off_record_nothing_and_read_no_clock(monkeypatch):
    """Off, `span` is one shared object: no clock read, no record built,
    and a `serve` call leaves nothing for a later recording."""
    assert timing.span("a") is timing.span("b", batch=2)

    class NoClock:
        def time_ns(self):
            raise AssertionError("a span read the clock while spans were off")

    def no_record(*a, **k):
        raise AssertionError("a span built a record while spans were off")

    monkeypatch.setattr(timing, "time", NoClock())
    monkeypatch.setattr(timing, "Span", no_record)
    _serve("whisper-large-v3")
    _serve("rwkv6-3b")
    monkeypatch.undo()
    with timing.spans() as records:
        pass
    assert records == []


def test_spans_blocks_do_not_nest_and_end_on_error():
    with pytest.raises(ValueError):
        with timing.spans() as records:
            with timing.span("outer"):
                with pytest.raises(RuntimeError):
                    with timing.spans():
                        pass
                raise ValueError
    assert [r.name for r in records] == ["outer"] and records[0].end_ns > 0
    assert timing.span("after") is timing.span("again")  # off again


class _KeepLogits:
    """The step factories `serve` calls, wrapped to keep every step's logits."""

    def __init__(self, monkeypatch):
        self.logits = []
        make_prefill, make_serve = serve_mod.make_prefill_step, serve_mod.make_serve_step

        def make_prefill_step(model, cache_len):
            step = make_prefill(model, cache_len)

            def prefill_step(params, batch):
                logits, caches = step(params, batch)
                self.logits.append(logits.clone())
                return logits, caches
            return prefill_step

        def make_serve_step(model):
            step = make_serve(model)

            def serve_step(params, caches, batch):
                tok, caches, logits = step(params, caches, batch)
                self.logits.append(logits.clone())
                return tok, caches, logits
            return serve_step

        monkeypatch.setattr(serve_mod, "make_prefill_step", make_prefill_step)
        monkeypatch.setattr(serve_mod, "make_serve_step", make_serve_step)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "rwkv6-3b"])
def test_serve_is_the_same_with_spans_on_and_off(monkeypatch, arch):
    keep = _KeepLogits(monkeypatch)
    _, off = _serve(arch)
    logits_off, keep.logits = keep.logits, []
    with timing.spans():
        _, on = _serve(arch)
    assert torch.equal(on["tokens"], off["tokens"]) and on["finite"] == off["finite"]
    assert len(keep.logits) == len(logits_off) == N + 1
    assert all(torch.equal(a, b) for a, b in zip(keep.logits, logits_off))
    assert set(on) == set(off) and on["launches"] == off["launches"]
    assert on["prefill_ms"] > 0 and on["decode_ms_per_token"] > 0
