"""AMS server (Algorithm 1) — one session per edge device.

The session owns the server-side copy of the student, the Adam moments, the
training buffer, and the ASR/ATR controllers. It is generic over a `Task`
adapter (the loss/grad callable, the teacher and the φ-score loss).

Difference from the JAX package's session: random masks (the first
gradient-guided phase's, and every phase of the ``"random"`` strategy)
come from a `torch.Generator`; the first gradient-guided phase takes
``first_mask`` instead when the caller injects one (the parity tests
replay the JAX package's phase-0 mask that way).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import selection
from repro_torch.core.atr import ATRController
from repro_torch.core.buffer import ReplayBuffer
from repro_torch.core.delta import ModelDelta, encode_delta
from repro_torch.core.masked_adam import (
    init_momentum,
    init_state,
    masked_adam_update,
    momentum_update,
)
from repro_torch.core.sampler import ASRController
from repro_torch.device import host_to_device


@dataclass(frozen=True)
class AMSConfig:
    """Paper defaults (§4.1): T_horizon=240s, T_update=10s, K=20, γ=5%,
    Adam(1e-3, 0.9, 0.999); ASR r∈[0.1,1] fps, δt=10s."""

    t_update: float = 10.0
    t_horizon: float = 240.0
    k_iters: int = 20
    batch_size: int = 8
    gamma: float = 0.05
    strategy: str = "gradient_guided"
    optimizer: str = "adam"  # "momentum" = Just-In-Time's optimizer
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    momentum: float = 0.9
    value_dtype: str = "float16"
    # ASR
    phi_target: float = 0.25
    asr_eta: float = 0.5
    r_min: float = 0.1
    r_max: float = 1.0
    asr_delta_t: float = 10.0
    # ATR (Appendix D)
    atr_enabled: bool = False
    atr_delta: float = 2.0
    atr_gamma0: float = 0.25
    atr_gamma1: float = 0.35


@dataclass
class Task:
    """Adapter binding AMS to a concrete model/task.

    loss_and_grad(params, frames, labels) -> (loss, grads), on tensors
    teacher(frames) -> labels, from a host (N, H, W, C) batch; a numpy
        array or a tensor on any device
    phi_loss(label_now, label_prev) -> float  (task loss for the φ-score)
    """

    loss_and_grad: Callable
    teacher: Callable
    phi_loss: Callable


class AMSSession:
    def __init__(self, task: Task, cfg: AMSConfig, params0, seed: int = 0,
                 first_mask=None):
        self.task = task
        self.cfg = cfg
        self.params = params0
        self.device = tree.leaves(params0)[0].device
        if cfg.optimizer == "adam":
            self.opt_state: Any = init_state(params0)
        else:
            self.opt_state = init_momentum(params0)
        self.buffer = ReplayBuffer(horizon=cfg.t_horizon)
        self.asr = ASRController(
            phi_target=cfg.phi_target, eta=cfg.asr_eta, r_min=cfg.r_min,
            r_max=cfg.r_max, delta_t=cfg.asr_delta_t,
        )
        self.atr = ATRController(
            tau_min=cfg.t_update, delta=cfg.atr_delta,
            gamma0=cfg.atr_gamma0, gamma1=cfg.atr_gamma1, t_update=cfg.t_update,
        )
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator().manual_seed(seed)
        self.first_mask = first_mask
        self.u_prev = None  # last full optimizer update (phase n-1)
        self.phase = 0
        self.last_label = None
        self.next_train_time = 0.0
        self.t_update = cfg.t_update
        # telemetry
        self.history: list = []

    # ---------------- inference phase (Algorithm 1, lines 5-9) -----------
    def receive_frames(self, frames, t_now: float) -> None:
        """Label new sample frames with the teacher; feed buffer + φ-score.

        The teacher runs ONCE over the stacked batch (one launch instead of
        one per frame); the φ-score ingest stays sequential — it compares
        consecutive labels, so order matters."""
        frames = list(frames)
        if not frames:
            self.asr.maybe_update(t_now)
            return
        labels = self.task.teacher(np.stack(frames))
        if isinstance(labels, torch.Tensor):
            labels = labels.cpu().numpy()
        for frame, label in zip(frames, np.asarray(labels)):
            self._ingest(frame, label, t_now)
        self.asr.maybe_update(t_now)

    def receive_labeled(self, frames, labels, t_now: float) -> None:
        """Same as receive_frames but labels were produced upstream (the
        oracle teacher of the simulation world labels by frame index)."""
        for frame, label in zip(frames, labels):
            self._ingest(frame, np.asarray(label), t_now)
        self.asr.maybe_update(t_now)

    def _ingest(self, frame, label, t_now: float) -> None:
        if self.last_label is not None:
            self.asr.observe(self.task.phi_loss(label, self.last_label))
        self.last_label = label
        self.buffer.add(frame, label, t_now)

    # ---------------- training phase (Algorithm 1, lines 10-17) ----------
    def _select_mask(self):
        cfg = self.cfg
        if cfg.strategy == "gradient_guided" and self.u_prev is None:
            # first phase: uniform random (paper §3.1.2), or the injected one
            if self.first_mask is not None:
                return self.first_mask
            return selection.random_mask(self.gen, self.params, cfg.gamma)
        return selection.make_mask(cfg.strategy, params=self.params,
                                   u_prev=self.u_prev, frac=cfg.gamma,
                                   rng=self.gen)

    def _select_mask_or_defer(self):
        """`_select_mask` with the gradient-guided selection left pending:
        it is a pure function of ``u_prev``, so the fused pipeline batches
        B of them into one stacked selection. Returns None for "deferred";
        every other strategy, and the first gradient-guided phase, returns
        its concrete mask."""
        if self.cfg.strategy == "gradient_guided" and self.u_prev is not None:
            return None
        return self._select_mask()

    def _prepare_phase(self, t_now: float):
        """Host-side phase setup: select the coordinate mask and draw all K
        replay minibatches. Returns ``(mask, frames, labels)`` with
        frames/labels stacked as (K, batch, ...) numpy arrays, or None when
        there is nothing to train on."""
        prep = self._prepare_phase_deferred(t_now)
        if prep is None:
            return None
        mask, frames, labels = prep
        if mask is None:
            mask = selection.gradient_guided_mask(self.u_prev, self.cfg.gamma)
        return mask, frames, labels

    def _prepare_phase_deferred(self, t_now: float):
        """`_prepare_phase` for the fused pipeline: identical RNG
        consumption and batch shapes, but a gradient-guided mask slot is
        returned as None (deferred) so `core.batched` can run one stacked
        selection for the whole group."""
        cfg = self.cfg
        if len(self.buffer) == 0:
            return None
        mask = self._select_mask_or_defer()
        batches = []
        for _ in range(cfg.k_iters):
            batch = self.buffer.sample(self.rng, cfg.batch_size, t_now)
            if batch is None:  # empty horizon window: no train
                return None
            batches.append(batch)
        frames = np.stack([b[0] for b in batches])
        labels = np.stack([b[1] for b in batches])
        return mask, frames, labels

    def _run_phase_prepared(self, t_now: float, mask, frames,
                            labels) -> ModelDelta:
        """The sequential K-iteration loop over prepared batches."""
        cfg = self.cfg
        frames = host_to_device(frames, self.device)
        labels = host_to_device(labels, self.device)
        params, opt_state, u = self.params, self.opt_state, None
        for k in range(cfg.k_iters):
            loss, grads = self.task.loss_and_grad(params, frames[k], labels[k])
            if cfg.optimizer == "adam":
                params, opt_state, u = masked_adam_update(
                    params, grads, opt_state, mask,
                    lr=cfg.lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                )
            else:
                params, opt_state, u = momentum_update(
                    params, grads, opt_state, mask, lr=cfg.lr,
                    momentum=cfg.momentum,
                )
        return self._commit_phase(t_now, params, opt_state, u, float(loss), mask)

    def _commit_phase(self, t_now: float, params, opt_state, u, loss: float,
                      mask, delta: ModelDelta | None = None) -> ModelDelta:
        """Adopt a finished phase's state and produce the wire delta — shared
        tail of the sequential and fused paths. A fused group encodes the
        whole stack's deltas in one batched device round trip and passes
        each session's slice in as ``delta``."""
        cfg = self.cfg
        self.params, self.opt_state, self.u_prev = params, opt_state, u
        self.phase += 1
        if delta is None:
            delta = encode_delta(params, mask, cfg.value_dtype)
        # ATR: stretch/reset T_update from the ASR rate (Appendix D)
        if cfg.atr_enabled:
            self.t_update = self.atr.update(self.asr.rate)
        self.next_train_time = t_now + self.t_update
        self.history.append(
            {"t": t_now, "loss": float(loss), "bytes": delta.total_bytes,
             "rate": self.asr.rate, "t_update": self.t_update}
        )
        return delta

    def train_phase(self, t_now: float) -> ModelDelta | None:
        prep = self._prepare_phase(t_now)
        if prep is None:
            return None
        return self._run_phase_prepared(t_now, *prep)

    @property
    def sampling_rate(self) -> float:
        return self.asr.rate
