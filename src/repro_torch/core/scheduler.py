"""Multi-session server scheduling (Appendix E).

Round-robin over sessions, one inference+training step per turn, one session
on the GPU at a time (the paper's strategy — minimizes context switching).
The GPU is modeled by a busy-until clock with per-operation costs calibrated
to the paper's V100 numbers (teacher inference 200-300 ms/frame; K=20 student
iterations per phase). The defaults stay that V100 calibration on every
card the port runs on: they are the modeled side of the engine's drift
audit (`serving.obs.drift_report`), which sets them against the wall-clock
the fused stages really take on the device at hand."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable


@dataclass(frozen=True)
class GPUCostModel:
    teacher_infer_s: float = 0.25  # per frame (paper: 200-300 ms on V100)
    train_iter_s: float = 0.05  # per student minibatch iteration
    # cross-client batched labeling (serving runtime): one launch labels the
    # whole backlog, amortizing per-frame cost to a fraction of the solo rate
    label_batch_overhead_s: float = 0.05
    label_batch_discount: float = 0.5
    # top-gamma% delta selection + entropy coding runs on the device after a
    # phase (paper §3.1.2); 0.0 keeps it free (unmodeled)
    delta_comp_s_per_mb: float = 0.0
    # gradient-guided coordinate selection (bisection/sort launch) per
    # session; 0.0 keeps the selection stage unmodeled
    select_s: float = 0.0
    # fused post-train update pipeline (core.batched + core.delta): a fused
    # grant's B selections run as one stacked launch and its B deltas as one
    # batched device->host encode — a setup charge plus discounted marginal
    # riders, mirroring train_batch_s. Applies only when the update path is
    # priced at all (select_s or delta_comp_s_per_mb nonzero).
    update_setup_s: float = 0.02
    update_discount: float = 0.4
    # fused cross-session training (core.batched): B co-resident sessions'
    # phases run as one stacked vmap launch — a setup charge plus a
    # sublinear per-session marginal cost (no B x K dispatch overhead, better
    # device occupancy). B=1 is exactly the solo cost, so an unfused engine
    # is bit-identical.
    train_batch_setup_s: float = 0.05
    train_batch_discount: float = 0.45

    @property
    def phase_s(self) -> float:  # K=20 iterations
        return 20 * self.train_iter_s

    def phase_cost_s(self, n_frames: int, k_iters: int) -> float:
        return n_frames * self.teacher_infer_s + k_iters * self.train_iter_s

    def label_batch_s(self, n_frames: int) -> float:
        if n_frames <= 0:
            return 0.0
        return (self.label_batch_overhead_s
                + n_frames * self.teacher_infer_s * self.label_batch_discount)

    def train_batch_s(self, n_sessions: int, k_iters: int) -> float:
        """One fused launch training ``n_sessions`` co-resident sessions for
        ``k_iters`` iterations each: a stacking setup charge, the first
        session at full price, and each additional rider at a discounted
        *marginal* cost (the stacked lifecycle replaces B x K loss/grad and
        optimizer launches with K and fills the device better). Exactly the sequential
        cost at B=1, so an unfused engine stays bit-identical."""
        if n_sessions <= 0:
            return 0.0
        solo = k_iters * self.train_iter_s
        if n_sessions == 1:
            return solo
        return (self.train_batch_setup_s + solo
                + (n_sessions - 1) * solo * self.train_batch_discount)

    def delta_comp_s(self, nbytes: int) -> float:
        """GPU time to select/compress one ModelDelta of ``nbytes``."""
        if nbytes <= 0:
            return 0.0
        return self.delta_comp_s_per_mb * nbytes / 1e6

    def update_solo_s(self, nbytes: int) -> float:
        """One session's post-train update production: coordinate selection
        plus delta compression (0.0 when both stages are unmodeled)."""
        return self.select_s + self.delta_comp_s(nbytes)

    def update_batch_s(self, bytes_list) -> float:
        """One fused update launch producing ``len(bytes_list)`` deltas:
        the stacked selection + batched encode replace B serial
        select/gather/pack round-trips, so the primary pays full price and
        each rider a discounted marginal cost after a stacking setup charge.
        B=1 is exactly `update_solo_s`, and an unpriced pipeline (all solo
        costs zero) stays free — no setup charge appears out of nowhere, so
        default-cost engines are bit-identical."""
        costs = [self.update_solo_s(b) for b in bytes_list]
        if not costs or sum(costs) <= 0.0:
            return 0.0
        if len(costs) == 1:
            return costs[0]
        return (self.update_setup_s + costs[0]
                + self.update_discount * sum(costs[1:]))


def next_in_turn(waiting: Iterable[int], turn: int, n_clients: int) -> int | None:
    """The round-robin successor: among ``waiting`` client ids, the first one
    at or after the ``turn`` pointer (mod n). Shared by RoundRobinScheduler
    and the serving engine's fair policy so both implement the same order."""
    waiting = list(waiting)
    if not waiting:
        return None
    n = max(n_clients, max(waiting) + 1, 1)
    return min(waiting, key=lambda c: ((c - turn) % n, c))


@dataclass
class RoundRobinScheduler:
    """Busy-clock scheduler for polling callers (the legacy tick-loop
    style). The event-driven serving engine does not use this class — its
    fair policy is `serving.policies.FairRoundRobin` — but both derive
    their turn order from `next_in_turn` above, so the ring semantics
    cannot silently diverge."""

    cost: GPUCostModel = field(default_factory=GPUCostModel)
    gpu_free_at: float = 0.0
    turn: int = 0
    n_clients: int = 0
    waiting_timeout: float = 5.0  # s without re-polling before a waiter is dropped
    # telemetry
    busy_s: float = 0.0
    served: int = 0
    deferred: int = 0
    _waiting: dict = field(default_factory=dict)  # client id -> last poll time

    def try_acquire(self, t_now: float, n_frames: int, k_iters: int,
                    client: int | None = None) -> bool:
        """One session's turn: label n_frames + run a training phase.

        With a ``client`` id, grants are round-robin over the clients
        currently asking: the GPU goes to the waiting client closest after
        the ``turn`` pointer, and the pointer advances past each grant — so
        poll order cannot starve late-indexed clients. Clients that never ask
        are skipped rather than holding the ring, and a waiter that stops
        re-polling (crash, disconnect) is expired after ``waiting_timeout``
        so it cannot block everyone else's grants forever. Without an id
        (legacy single-queue callers), any request is granted when the GPU
        is free. Returns False (deferred) if the GPU is busy or it isn't
        our turn."""
        if client is not None:
            self.n_clients = max(self.n_clients, client + 1)
            self._waiting[client] = t_now  # refresh liveness on every poll
        if t_now < self.gpu_free_at:
            self.deferred += 1
            return False
        if client is not None:
            for c, last_poll in list(self._waiting.items()):
                if t_now - last_poll > self.waiting_timeout:
                    del self._waiting[c]
            nxt = next_in_turn(self._waiting, self.turn, self.n_clients)
            if nxt != client:
                self.deferred += 1
                return False
            del self._waiting[client]
            # unwrapped on purpose: next_in_turn reduces mod the *current*
            # client count, which may still be growing at this point
            self.turn = client + 1
        dur = self.cost.phase_cost_s(n_frames, k_iters)
        self.gpu_free_at = max(self.gpu_free_at, t_now) + dur
        self.busy_s += dur
        self.served += 1
        return True

    def utilization(self, t_now: float) -> float:
        return self.busy_s / max(t_now, 1e-9)
