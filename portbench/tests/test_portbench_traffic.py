"""The traffic: each seed's inputs are the same on every draw, calls and
seeds differ, and every seed gets the same sizes."""
from __future__ import annotations

import json

import pytest
import torch
from portbench_scratch import REPO

from portbench import harness

BENCH = harness.Bench(REPO)
MIXES = sorted({w["traffic"] for w in BENCH.spec["workloads"]})
SMALL = {"vocab_size": 512, "d_model": 8}


@pytest.mark.parametrize("name", MIXES)
def test_mix_deterministic(name):
    mix = BENCH.data("traffic", name)
    mix = dict(mix, memory_positions=min(mix["memory_positions"], 16))
    driver = BENCH.module("traffic", mix["driver"])

    def draw(seed, i):
        return driver.Traffic(mix, SMALL, seed, torch.device("cpu"), torch.bfloat16).inputs(i)

    big = 2**31 + 12345
    a, b = draw(big, 3), draw(big, 3)
    assert torch.equal(a[0], b[0]) and a[0].shape == (mix["batch"], mix["prompt_tokens"])
    assert (a[1] is None) == (mix["memory_positions"] == 0)
    if a[1] is not None:
        assert torch.equal(a[1], b[1]) and a[1].dtype == torch.bfloat16
    other_call, other_seed = draw(big, 4), draw(big + 1, 3)
    assert not torch.equal(a[0], other_call[0]) and not torch.equal(a[0], other_seed[0])
    assert other_seed[0].shape == a[0].shape
    assert int(a[0].max()) < SMALL["vocab_size"]


def test_mix_rejects_bad_sizes():
    driver = BENCH.module("traffic", "closed_loop")
    with pytest.raises(ValueError):
        driver.Traffic({"batch": 0, "prompt_tokens": 4, "memory_positions": 0,
                        "new_tokens": 0}, SMALL, 1, torch.device("cpu"), torch.float32)


def test_drive_closes_after_the_window():
    driver = BENCH.module("traffic", "closed_loop")
    t = driver.Traffic(json.loads('{"batch": 1, "prompt_tokens": 1, "memory_positions": 0, '
                                  '"new_tokens": 0}'), SMALL, 1, torch.device("cpu"),
                       torch.float32)
    calls, window = t.drive(lambda i: i, 0.0)
    assert calls == [0] and window >= 0.0


def test_weights_deterministic():
    table = BENCH.module("reference", "rwkv6").weights(
        {"d_model": 32, "d_ff": 64, "vocab_size": 50, "num_layers": 2, "ssm_head_dim": 16})
    a = harness.draw_weights(table, 2**31 + 5, "cpu", torch.bfloat16)
    b = harness.draw_weights(table, 2**31 + 5, "cpu", torch.bfloat16)
    for (pa, ta), (pb, tb) in zip(harness.walk(a), harness.walk(b)):
        assert pa == pb and torch.equal(ta, tb) and ta.dtype == torch.bfloat16
    w0 = a["groups"]["b0"]["rwkv"]["tm"]["decay_w0"].float()
    assert -4.5 < float(w0.mean()) < -2.5  # drawn at its mean and spread
