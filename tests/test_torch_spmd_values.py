"""The sharded program on values: the dry run's steps on DTensors
(`launch.dryrun.sharded_step`, the program whose collectives it counts)
run across four CPU processes in a gloo process group on a (2, 2)
("data", "model") mesh, with smoke weights from a seed, and held against
the plain single-process steps on the same inputs
(`scripts/spmd_values.py`, loaded here).

Every architecture of the comparison with XLA runs its train step (the
loss, every gradient, the clip's global norm and the params after the
masked Adam step), its prefill (logits and caches), a decode step and a
batch-1 long-context decode step whose cache is sharded over its
positions (the next token, the logits and the caches). So the flash-
decoding combine, the cache write on the owning shard, the vocabulary-
parallel logsumexp and lookup, the sharded optimizer and clip, the MoE
dispatch (the slots one program keeps, across the ranks' tokens) and the
scans' operand contracts all run on values. The MoE configs run also at
their own capacity factor on a skewed batch, where slots drop
(`spmd_values.CAPPED`).

The weights are float64 (Zamba2's float32: its Mamba2 scan takes no
float64), but several stages compute in float32 by design on both sides:
RoPE, the decode attention, the loss's softmax, masked Adam's arithmetic.
Summed in another order across shards, a float64 value can round to
another float32, so outputs agree to float32's precision, not float64's:
`TOL` bounds each output's largest difference relative to its largest
value. The measured worst at these shapes, on torch 2.13 and 2.11 alike,
is 3.5e-6 for outputs (Mixtral's decode logits), 8.2e-6 for gradients
and 1.3e-5 for the params after one Adam step (where a gradient is near
Adam's eps, its first update is about lr times its sign, and moves with
the gradient's last bits). A wrong placement, a lost partial sum or a
shard written to the wrong place is off by a whole term: 1e-3 of the
params, or the gradient's own size (on torch 2.11, DTensor's backward of
the loss's sharded logsumexp was off by 3x to 1e5x before
`spmd.logsumexp` took its own).
"""
import importlib.util
from pathlib import Path

import pytest

_spec = importlib.util.spec_from_file_location(
    "spmd_values", Path(__file__).resolve().parents[1] / "scripts" / "spmd_values.py")
spmd_values = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(spmd_values)

STEPS = ("train", "prefill", "decode", "decode_long")
TOL = {"grads": 1e-4, "params": 1e-4}  # the rest: 1e-5; "tok" and "keep" exactly
WANT = {"train": {"loss", "gn", "grads", "params"}, "prefill": {"logits", "caches"},
        "decode": {"tok", "logits", "caches"}, "decode_long": {"tok", "logits", "caches"}}
MOE = {"mixtral_8x22b", "mixtral_8x22b:capped", "moonshot_v1_16b_a3b:capped"}


@pytest.fixture(scope="module")
def rows():
    return spmd_values.run_world()


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("arch", spmd_values.ARCHS + spmd_values.CAPPED)
def test_sharded_step_matches_the_plain_step(rows, arch, step):
    """Every output within its tolerance; the MoE layers' keep masks
    (every layer's, recompute included) bit for bit. At the MoE configs'
    own capacity factor (ROADMAP F20) the single process drops slots in
    every step but the batch-1 decode, whose one token's k experts are
    distinct."""
    mine = [r for r in rows if r["arch"] == arch and r["step"] == step]
    assert {r["out"].split("[")[0] for r in mine} == WANT[step] | (
        {"keep"} if arch in MOE else set())
    for r in mine:
        kind = r["out"].split("[")[0]
        if kind in ("tok", "keep"):
            assert r["max_abs"] == 0, r
        else:
            assert r["max_abs"] <= TOL.get(kind, 1e-5) * r["scale"], r
        if kind == "keep" and arch in spmd_values.CAPPED and step != "decode_long":
            assert r["dropped"] > 0, r
