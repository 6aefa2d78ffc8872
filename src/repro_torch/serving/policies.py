"""Pluggable (session, gpu) scheduling policies for the serving engine.

A policy answers one question: some devices in the pool just went idle and
several sessions have work queued — which sessions run next, and on which
GPU? The primitive is still a ranking (`pick`: who is most deserving), but
the engine-facing surface is `assign`, which maps the ready queue onto the
free devices of a `resources.GPUPool`:

* `FairRoundRobin` — the paper's Appendix E strategy: a rotating turn
  pointer over waiting sessions (shares `next_in_turn` with
  `core.scheduler.RoundRobinScheduler`). Ties — several queued requests
  from the turn-winning client — break deterministically by request age,
  so multi-GPU runs reproduce regardless of queue arrival order.
* `EarliestDeadlineFirst` — each request carries a deadline (its session's
  next T_update boundary); the most overdue phase runs first.
* `GainAware` — ATR-style cycle reclamation generalized to the scheduler:
  rank sessions by recent scene dynamics (the ASR φ-signal, via sampling
  rate) times staleness, so dynamic feeds preempt near-static ones while a
  growing staleness term keeps static feeds from starving outright.
* `AffinityAware` — GainAware's ranking, placement-aware: a candidate's
  score is discounted by the weight-migration time the pool would charge
  on that device (zero where the session is already resident), by the
  device's modeled phase-time excess on heterogeneous pools, and by its
  stream backlog (dual-stream engine path) — so sessions stick to the
  fastest idle GPU holding their state and the pool's overhead taxes are
  mostly avoided rather than mostly paid.

The three base policies are deliberately affinity-*blind* in placement
(lowest-numbered free device) — they still pay the pool's migration charge
whenever they bounce a session across devices, which is exactly the gap
`AffinityAware` closes. Every policy's `coalesce` is cost-aware: a fused
grant's spare seats go to ready requests whose staging cost on the granted
device is zero or beaten by the fused stack's marginal train discount.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.scheduler import next_in_turn


@dataclass
class GPURequest:
    """A queued "label my backlog + run one training phase" request."""

    client: int
    t_request: float  # when the request became ready at the server
    n_frames: int  # unlabeled frames riding along
    k_iters: int
    deadline: float  # t_request + the session's current T_update
    phi: float  # recent φ-score signal (~0 static feed, ~1+ dynamic)
    t_update: float  # session's current update period (ATR-stretched)
    state_bytes: int = 0  # session training state (weights+opt+buffer)
    gpu: int | None = None  # device the grant landed on (engine fills)
    upload_nbytes: int = 0  # uplink bytes already spent carrying the frames
    # (a tail-dropped victim's upload was wasted air time — the engine's
    # dropped_frame_bytes counter reads this field at eviction)


@dataclass(frozen=True)
class Assignment:
    """One (request, device) pairing chosen by a policy."""

    req: GPURequest
    gpu: int


class SchedulingPolicy:
    name = "base"

    def pick(self, t_now: float, ready: list[GPURequest]) -> GPURequest:
        """Rank the ready queue: who is most deserving of the next grant?"""
        raise NotImplementedError

    def rank(self, t_now: float, *, clients: np.ndarray,
             t_request: np.ndarray, deadline: np.ndarray, phi: np.ndarray,
             t_update: np.ndarray, limit: int | None = None) -> np.ndarray:
        """Vectorized ranking over parallel request-field arrays (the
        engine's fleet path): return up to ``limit`` positions, best first
        — the exact sequence repeated `pick` would produce over the
        corresponding `GPURequest` list, which stays the reference (and
        the non-fleet) path. Assumes at most one request per client, which
        the engine's ready set guarantees. Policies without an array form
        (or with stateful pick logic that can't be replayed) simply don't
        override this, and the engine keeps the pick-loop."""
        raise NotImplementedError

    def place(self, t_now: float, req: GPURequest, free: list[int],
              pool) -> int:
        """Which free device serves ``req``. Base policies are affinity-
        blind: lowest-numbered free device (they pay whatever migration
        the pool charges)."""
        return min(free)

    def assign(self, t_now: float, ready: list[GPURequest],
               free: list[int], pool) -> list[Assignment]:
        """Map the ready queue onto the free devices: repeatedly pick the
        top-ranked request and place it, until requests or devices run out.
        With one device this degenerates to a single `pick`."""
        ready, free = list(ready), list(free)
        out: list[Assignment] = []
        while ready and free:
            req = self.pick(t_now, ready)
            gid = self.place(t_now, req, free, pool)
            out.append(Assignment(req=req, gpu=gid))
            ready.remove(req)
            free.remove(gid)
        return out

    def evict(self, t_now: float, overfull: list[GPURequest]) -> GPURequest:
        """Saturation: the backlog is over capacity; choose the request to
        drop. Default drops the newest arrival (tail drop)."""
        return max(overfull, key=lambda r: (r.t_request, r.client))

    def coalesce(self, t_now: float, granted: Assignment,
                 ready: list[GPURequest], pool,
                 max_fuse: int) -> list[GPURequest]:
        """Riders for a fused grant: additional ready requests that can train
        on ``granted.gpu`` in the SAME stacked launch (`core.batched`).
        Riders share the grant's iteration count, so one stacked lifecycle
        covers them. Candidate selection is *cost-aware*: a rider is taken
        when staging it on the granted device is cheaper than the fused
        stack's marginal discount — resident (or first-touch) riders stage
        for free and always qualify, while a
        foreign-resident or host-spilled session may now buy its way in
        when its migration time is smaller than the solo-vs-marginal train
        saving its seat unlocks. The stack (primary + riders) is bounded by
        ``max_fuse`` AND by the device's ``residency_cap`` — HBM that holds
        only N session states cannot co-train more than N, and a larger
        stack would LRU-evict its own members mid-launch. Rider *order* is a
        policy decision (`_rider_order`); base policies take the oldest."""
        limit = max_fuse - 1
        cap = getattr(pool, "residency_cap", None)
        if cap is not None:
            limit = min(limit, cap - 1)
        if limit <= 0:
            return []
        cost = pool.device(granted.gpu).cost
        k = granted.req.k_iters
        solo_s = k * cost.train_iter_s
        candidates = sorted((r for r in ready if r.k_iters == k),
                            key=self._rider_order(t_now))
        riders: list[GPURequest] = []
        stack = 1
        for r in candidates:
            if len(riders) >= limit:
                break
            mig = pool.migration_s(r.client, granted.gpu, r.state_bytes)
            saving = solo_s - (cost.train_batch_s(stack + 1, k)
                               - cost.train_batch_s(stack, k))
            if mig == 0.0 or mig < saving:
                riders.append(r)
                stack += 1
        return riders

    def _rider_order(self, t_now: float):
        """Sort key ranking rider candidates (best first)."""
        return lambda r: (r.t_request, r.client)


class FairRoundRobin(SchedulingPolicy):
    name = "fair"

    def __init__(self):
        self.turn = 0
        self.n_clients = 0

    def pick(self, t_now: float, ready: list[GPURequest]) -> GPURequest:
        self.n_clients = max([self.n_clients] + [r.client + 1 for r in ready])
        nxt = next_in_turn([r.client for r in ready], self.turn, self.n_clients)
        # unwrapped on purpose: next_in_turn reduces mod the current count,
        # which grows as later-indexed clients issue their first requests
        self.turn = nxt + 1
        # several queued requests from the winning client are possible under
        # saturation; serve oldest-first so the choice is a function of the
        # requests, not of queue arrival order (multi-GPU reproducibility)
        return min((r for r in ready if r.client == nxt),
                   key=lambda r: (r.t_request, r.deadline, r.n_frames))

    def rank(self, t_now: float, *, clients: np.ndarray,
             t_request: np.ndarray, deadline: np.ndarray, phi: np.ndarray,
             t_update: np.ndarray, limit: int | None = None) -> np.ndarray:
        # repeated pick over a fixed ready set IS ring order from the turn
        # pointer: the winner is the ring-first waiting client, and the next
        # pick starts just past it — which is the next one in the same ring
        # order (distinct clients have distinct ring positions, so one
        # argsort replays the whole rotation). The turn advances as if the
        # taken prefix had been picked one by one.
        n = max(self.n_clients, int(clients.max()) + 1, 1)
        self.n_clients = n
        order = np.argsort((clients - self.turn) % n, kind="stable")
        if limit is not None:
            order = order[:limit]
        if len(order):
            self.turn = int(clients[order[-1]]) + 1
        return order


class EarliestDeadlineFirst(SchedulingPolicy):
    name = "edf"

    def pick(self, t_now: float, ready: list[GPURequest]) -> GPURequest:
        return min(ready, key=lambda r: (r.deadline, r.client, r.t_request))

    def rank(self, t_now: float, *, clients: np.ndarray,
             t_request: np.ndarray, deadline: np.ndarray, phi: np.ndarray,
             t_update: np.ndarray, limit: int | None = None) -> np.ndarray:
        # lexsort keys are least-significant first: (deadline, client,
        # t_request) ascending, same tuple `pick` minimizes
        order = np.lexsort((t_request, clients, deadline))
        return order if limit is None else order[:limit]


@dataclass
class GainAware(SchedulingPolicy):
    """score = recent φ-signal + staleness_weight * waited / T_update.

    The first term routes cycles to dynamic scenes (where a training phase
    buys the most accuracy); the second grows linearly while a request sits
    queued, so even a frozen feed is served after a bounded wait — the same
    reclamation/backstop structure as ATR's slowdown mode. Under saturation
    the same score drives eviction: a static feed's queued request is the
    one sacrificed, not whichever arrival happened to find the queue full."""

    staleness_weight: float = 0.5
    name: str = field(default="gain", init=False)

    def _score(self, t_now: float, r: GPURequest) -> float:
        waited = max(t_now - r.t_request, 0.0)
        return r.phi + self.staleness_weight * waited / max(r.t_update, 1e-9)

    def pick(self, t_now: float, ready: list[GPURequest]) -> GPURequest:
        # max score; ties broken by client id for determinism
        return max(ready, key=lambda r: (self._score(t_now, r), -r.client,
                                         -r.t_request))

    def rank(self, t_now: float, *, clients: np.ndarray,
             t_request: np.ndarray, deadline: np.ndarray, phi: np.ndarray,
             t_update: np.ndarray, limit: int | None = None) -> np.ndarray:
        # same expression as `_score`, elementwise (same IEEE ops, so the
        # scores — and any ties — are bit-identical to the pick loop)
        waited = np.maximum(t_now - t_request, 0.0)
        score = phi + self.staleness_weight * waited / np.maximum(t_update,
                                                                  1e-9)
        # descending score, then ascending client and t_request — the
        # ascending lexsort of (-score, client, t_request)
        order = np.lexsort((t_request, clients, -score))
        return order if limit is None else order[:limit]

    def evict(self, t_now: float, overfull: list[GPURequest]) -> GPURequest:
        return min(overfull, key=lambda r: (self._score(t_now, r), r.client))

    def _rider_order(self, t_now: float):
        """Gain-ranked riders: the stacked launch's extra slots go to the
        highest-value eligible requests, not merely the oldest."""
        return lambda r: (-self._score(t_now, r), r.client)


@dataclass
class AffinityAware(GainAware):
    """Gain-aware ranking with cost-aware (request, device) placement.

    Jointly scores (request, device) pairs: the gain score minus every
    modeled second that running *there* — rather than on the best possible
    device — would cost, normalized by the request's update period (one
    period of overhead cancels one unit of φ). Three penalty terms:

    * migration — the staging time the pool would charge on that device
      (zero where the session is already resident), weighted by
      ``migration_weight``;
    * heterogeneity — on pools with asymmetric `GPUCostModel`s, the excess
      of that device's modeled phase time (labeling + solo training) over
      the cheapest device's; zero everywhere on a homogeneous pool, so this
      term changes nothing for homogeneous sweeps, weighted by
      ``compute_weight``;
    * stream backlog — how long that device's streams defer a train launch
      (`GPUPool.train_ready_wait_s`; nonzero only under the dual-stream
      engine path, where a label stream can run ahead of the grants),
      weighted by ``stream_weight``.

    A resident pairing on the fastest, idlest device costs nothing, so
    sessions gravitate there; a dynamic feed can still justify paying any
    of the three when its score gap is large enough."""

    migration_weight: float = 1.0
    compute_weight: float = 1.0
    stream_weight: float = 1.0
    name: str = field(default="affinity", init=False)

    def assign(self, t_now: float, ready: list[GPURequest],
               free: list[int], pool) -> list[Assignment]:
        def phase_s(r, g):
            c = pool.device(g).cost
            return (c.label_batch_s(r.n_frames)
                    + c.train_batch_s(1, r.k_iters))

        ready, free = list(ready), list(free)
        # hoisted once per assign() call — nothing below charges the pool,
        # so phase times and stream waits are invariants; only the
        # per-request floor moves as the free list shrinks
        phase = {(id(r), g): phase_s(r, g) for r in ready for g in free}
        wait = {g: pool.train_ready_wait_s(g, t_now) for g in free}
        out: list[Assignment] = []
        while ready and free:
            floor = {id(r): min(phase[id(r), g] for g in free) for r in ready}

            def net(pair):
                r, g = pair
                mig = pool.migration_s(r.client, g, r.state_bytes)
                het = phase[id(r), g] - floor[id(r)]
                overhead = (self.migration_weight * mig
                            + self.compute_weight * het
                            + self.stream_weight * wait[g])
                score = (self._score(t_now, r)
                         - overhead / max(r.t_update, 1e-9))
                return (score, -r.client, -r.t_request, -g)

            req, gid = max(((r, g) for r in ready for g in free), key=net)
            out.append(Assignment(req=req, gpu=gid))
            ready.remove(req)
            free.remove(gid)
        return out


POLICIES = {
    "fair": FairRoundRobin,
    "edf": EarliestDeadlineFirst,
    "gain": GainAware,
    "affinity": AffinityAware,
}


def make_policy(name_or_policy) -> SchedulingPolicy:
    if isinstance(name_or_policy, SchedulingPolicy):
        return name_or_policy
    try:
        return POLICIES[name_or_policy]()
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {name_or_policy!r}; "
            f"choose from {sorted(POLICIES)}") from None
