"""The comparison that decides a run's ``correct``.

Once the window has closed, a sample of the requests it finished, drawn
from the seed among the rows whose logits the window's calls kept, is
run through the configuration's plain float32 reference, teacher-forced
with the tokens the port served: its prompt (and its frames, drawn again
from the seed) and every served token but the last, with logits at each
position that served one. Two numbers are compared:

* ``logits_rel``: the largest relative difference, |port - ref| / |ref|
  over the vocabulary, of the logits the port computed at a served
  position (the prefill's and every decode step's, as its step factories
  returned them) against the reference's;
* ``token_excess``: at each served position, the gap by which the served
  token's reference logit lies below the reference's best, less twice
  the largest |port - ref| there, the largest over the sample, in
  float64. A token that is the argmax of the logits the port computed
  has a gap of at most twice their largest error (its own logit's and
  the best one's), so this is at most 0 exactly; a token altered after
  its logits were computed reads its whole gap.

``token_gap``, the gap itself (the widest over the sample), is recorded
beside them and not compared: near-ties in random weights make it swing
from seed to seed in the port and the control alike.

The control puts the reference, computed with every product's operands
in float8 e4m3 (`reference.common.Precision`), in the port's place: its
gap is that of the token it puts first, and its relative difference is
its own logits'.
"""
from __future__ import annotations

import random
from collections import defaultdict

import torch

from portbench.reference.common import Precision, exact_float32


def sample(seed: int, calls, n: int) -> list[tuple[int, int]]:
    """``n`` (call position, row) pairs, drawn from the seed among the
    rows the calls kept logits for."""
    pool = [(ci, row) for ci, call in enumerate(calls) for row in call.rows]
    return sorted(random.Random(f"portbench-check:{seed}").sample(pool, min(n, len(pool))))


def _gaps(ref, tokens):
    """(R, P) float64: each position's best reference logit less the
    token's."""
    ref = ref.double()
    return ref.amax(dim=-1) - ref.gather(-1, tokens[..., None]).squeeze(-1)


def _excess(ref, port, tokens):
    err = (port.double() - ref.double()).abs().amax(dim=-1)
    return (_gaps(ref, tokens) - 2.0 * err).amax()


def _rel(got, ref):
    return ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).amax()


@torch.no_grad()
def readings(session, calls, n: int, ref_batch: int, control: bool = False) -> dict:
    """{"logits_rel", "token_excess", "token_gap", "requests",
    "positions"} over ``n`` sampled requests of ``calls``; the control's
    own beside them (``control_logits_rel``, ``control_token_gap``) when
    ``control``."""
    picks = sample(session.seed, calls, n)
    by_call = defaultdict(list)
    for ci, row in picks:
        by_call[ci].append(row)
    rows = []  # (tokens (T,), memory (Sm, d) | None, served (n+1,), port logits (n+1, V))
    for ci, rs in by_call.items():
        call = calls[ci]
        prompt, memory = session.traffic.inputs(call.index)
        for row in rs:
            served = call.tokens[row].to(device=prompt.device, dtype=torch.long)
            rows.append((torch.cat([prompt[row], served[:-1]]),
                         None if memory is None else memory[row], served,
                         call.logits[call.rows.index(row)]))
    S = session.traffic.prompt_tokens
    out = defaultdict(float)
    out["token_excess"] = -float("inf")
    with exact_float32():
        for b in range(0, len(rows), ref_batch):
            block = rows[b:b + ref_batch]
            tokens = torch.stack([r[0] for r in block])
            memory = None if block[0][1] is None else torch.stack([r[1] for r in block])
            served = torch.stack([r[2] for r in block])
            port = torch.stack([r[3] for r in block]).float()
            ref = session.reference.logits(session.params, session.model, tokens, memory, S - 1)
            out["token_gap"] = max(out["token_gap"], float(_gaps(ref, served).amax()))
            out["token_excess"] = max(out["token_excess"], float(_excess(ref, port, served)))
            out["logits_rel"] = max(out["logits_rel"], float(_rel(port, ref)))
            if control:
                low = session.reference.logits(session.params, session.model, tokens, memory,
                                               S - 1, Precision("fp8"))
                out["control_token_gap"] = max(out["control_token_gap"],
                                               float(_gaps(ref, low.argmax(-1)).amax()))
                out["control_logits_rel"] = max(out["control_logits_rel"], float(_rel(low, ref)))
            del ref
    out["requests"] = len(rows)
    out["positions"] = len(rows) * (session.traffic.new_tokens + 1)
    return dict(out)
