"""End-to-end AMS distillation trainer for the model zoo (the JAX package's
`launch/train.py`).

The server continually adapts a *student* LM to a drifting token stream by
distillation against the stream's next tokens, and streams its updates
as gradient-guided sparse deltas: Algorithm 1/2 on transformer trees
instead of convnets. Phases of K steps (``--phase-len``): the first phase
trains a random mask, each later one the γ-fraction of coordinates with
the largest last update of the phase before; each step clips the global
gradient norm and guards against non-finite gradients as the JAX trainer
does; each phase ends with the delta encoded for the downlink.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 200 --device cpu

trains the smoke config on the CPU; without ``--device`` it runs on the
card. The flags and the printed lines are the JAX CLI's. `train` is the
loop behind it: the caller hands it the params, the token stream and, if
it likes, the first mask, so a test or `chip_smoke.py` can inject them.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import get_smoke
from repro_torch.core import selection
from repro_torch.core.delta import encode_delta
from repro_torch.core.masked_adam import FlatMaskedAdam
from repro_torch.data.tokens import StreamConfig, TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import build


class TrainResult(NamedTuple):
    losses: list      # each step's loss (float)
    masks: list       # each phase's mask tree
    deltas: list      # each phase's `ModelDelta`, encoded at its end
    state: FlatMaskedAdam  # the trained params (``state.params``) and Adam state


def train(cfg: ModelConfig, params, stream: TokenStream, *, steps: int, phase_len: int,
          batch: int, seq: int, gamma: float = 0.05, lr: float = 1e-3, clip: float = 1.0,
          nprng: np.random.Generator | None = None, first_mask=None,
          mask_gen: torch.Generator | None = None, memory=None, log=None,
          clock=None) -> TrainResult:
    """Train ``params`` (a tree on the device the run is on; copied once
    into the flat optimizer state, so the caller may drop it) for
    ``steps`` steps in phases of ``phase_len``.

    Each step samples ``batch`` sequences of ``seq + 1`` tokens from
    ``stream`` with ``nprng`` (default ``np.random.default_rng(0)``, the
    JAX CLI's) at stream time ``2 * step``: tokens ``[:, :-1]``, labels
    ``[:, 1:]``. The first phase trains ``first_mask`` if given, else a
    random γ mask drawn from ``mask_gen`` (default a CPU generator seeded
    with 0); every later phase the gradient-guided mask of the last
    update. ``memory`` feeds cross-attention. ``log(step, loss,
    downlink_bytes, state)``, where given, is called after every step
    (``state.grads`` still holds the step's clipped gradients);
    ``clock(stage)`` returns a context manager around each stage (the
    step's ``forward_backward``, ``clip`` and ``adam``, and ``sample``,
    ``select`` and ``encode``)."""
    dev = tree.leaves(params)[0].device
    stage = clock or (lambda name: contextlib.nullcontext())
    nprng = np.random.default_rng(0) if nprng is None else nprng
    mask_gen = torch.Generator().manual_seed(0) if mask_gen is None else mask_gen
    model = build(cfg)
    state = FlatMaskedAdam(params)
    del params
    step = make_train_step(model, lr=lr, clip=clip, clock=clock)
    losses, masks, deltas = [], [], []
    u_prev, total_down = None, 0
    for it in range(steps):
        if it % phase_len == 0:  # new phase: select I_n (Algorithm 2 line 1)
            with stage("select"):
                if u_prev is None:
                    mask = (first_mask if first_mask is not None
                            else selection.random_mask(mask_gen, state.params, gamma))
                else:
                    mask = selection.gradient_guided_mask(u_prev, gamma)
                state.set_mask(mask)
            masks.append(mask)
        with stage("sample"):
            data = stream.sample(nprng, batch, seq, it * 2.0)
            b = {"tokens": torch.from_numpy(data[:, :-1]).to(dev),
                 "labels": torch.from_numpy(data[:, 1:]).to(dev)}
            if memory is not None:
                b["memory"] = memory
        u_prev, loss = step(state, b)
        losses.append(float(loss))
        if (it + 1) % phase_len == 0:  # end of phase: stream the delta
            with stage("encode"):
                deltas.append(encode_delta(state.params, state.mask))
            total_down += deltas[-1].total_bytes
        if log is not None:
            log(it, losses[-1], total_down, state)
    return TrainResult(losses, masks, deltas, state)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--phase-len", type=int, default=10, help="K iterations per phase")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--gamma", type=float, default=0.05)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--clip", type=float, default=1.0, help="global grad-norm clip")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    params = build(cfg).init(torch.Generator().manual_seed(0), dev)
    stream = TokenStream(StreamConfig(vocab_size=cfg.vocab_size, seed=1))
    memory = None
    if cfg.num_xattn_tokens:  # the JAX package's CLI stub
        memory = 0.1 * torch.ones((args.batch, cfg.num_xattn_tokens, cfg.d_model),
                                  device=dev)
    t0 = time.time()

    def log(it, loss, down, _state):
        if it % args.log_every == 0:
            print(f"step {it:5d} loss {loss:.4f} "
                  f"downlink {down/1e3:.1f} KB  ({time.time()-t0:.1f}s)")

    r = train(cfg, params, stream, steps=args.steps, phase_len=args.phase_len,
              batch=args.batch, seq=args.seq, gamma=args.gamma, lr=args.lr,
              clip=args.clip, memory=memory, log=log)
    total_down = sum(d.total_bytes for d in r.deltas)
    print(f"done: final loss {r.losses[-1]:.4f}, total downlink {total_down/1e3:.1f} KB, "
          f"{args.steps} steps in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
