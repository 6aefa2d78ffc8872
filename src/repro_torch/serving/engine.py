"""Event-driven AMS serving runtime (Appendix E at scale).

Replaces the per-frame tick loop of `sim.multiclient` with a discrete-event
simulation: N sessions share a *pool* of GPUs (`resources.GPUPool`) and a
modeled network, and nothing advances except by popping the next event. The
lifecycle of one update period, in events:

    sample    (edge)   frame captured at the ASR rate into the device outbox
    upload    (edge)   every T_update the outbox ships over the rate-limited
                       uplink (H.264 buffer bytes -> link occupancy)
    request   (server) the batch lands; admission control either queues a
                       GPURequest or drops it (saturation telemetry)
    <grants>           whenever any device idles, the scheduling policy maps
                       the ready queue onto the free devices as (session,
                       gpu) assignments; each granted device stages the
                       session's state if it is not resident (migration time
                       on that device's clock), labels the queued backlog in
                       one batched teacher launch, then runs the session's
                       K-iteration training phase. With ``fuse_train > 1``
                       the grant also takes ready *riders* whose staging is
                       cheaper than the fused-stack discount: the whole stack
                       trains as ONE fused vmap lifecycle (`core.batched`)
                       priced sublinearly by `GPUCostModel.train_batch_s`
    label_seg (gpu g)  [dual-stream path] one frame batch of a labeling
                       launch completes on g's label stream; the labels land
                       in the owning session's replay buffer
    gpu_done  (gpu g)  the phase ends on device g; the fresh ModelDelta is
                       compressed on g's clock (delta_comp_s, optional) and
                       ships over the client's downlink, followed by the ASR
                       rate-control message (asr_ctrl_bytes, optional)
    gpu_free  (gpu g)  g finishes compressing and rejoins the free set
    delta     (edge)   the — by now stale — delta lands and swaps in via the
                       double-buffered EdgeClient
    rate_ctrl (edge)   the ASR's new sampling rate takes effect on-device
    eval      (edge)   mIoU of the client-side weights against the teacher

Device time is charged through `resources.StreamModel`: every work item —
teacher labeling, solo/fused training, migration, delta compression — lands
on a named per-device stream (``label`` or ``train``). The default model
(serialized streams, no preemption) is the single busy clock and takes
a legacy fast path that reproduces it bit-for-bit. With ``overlap`` the two
streams run concurrently (bounded ``slowdown`` while both are busy), so a
cross-client labeling batch no longer serializes against the fused train
launch it feeds; with ``preempt`` an in-flight labeling launch is split at a
frame-batch boundary when a train grant needs its labels (or, serialized,
the clock) sooner — the remainder requeues behind the grant at a modeled
preemption cost, so train-phase latency no longer inherits the tail of
whoever's labeling.

Defaults give the single-GPU engine: ``n_gpus=1`` means one device, nothing
to migrate to, no `gpu_free`/`rate_ctrl` events (compression and the rate
message are off until their knobs are set), and the policy's `assign`
degenerates to the old single `pick`. Eval still reads ground truth directly
(it is measurement, not traffic). Everything else — who gets which GPU, when
bytes move, how stale a delta is — is modeled.

Chaos mode (``cfg.faults``, `serving.faults.FaultPlan`) adds the failure
events: ``upload_retry`` (a lost/deferred frame batch retries with
exponential backoff + deterministic jitter, bounded by ``max_retries``),
``delta_retx`` (a lost delta retransmits ONLY if the server has not
produced a newer one — supersede semantics; the edge keeps inferring on
its stale model meanwhile), ``crash``/``recover`` (a device dies: its
residents spill, its in-flight grant is killed and the armed ``watchdog``
requeues the fused group on a survivor via the normal migration
machinery), and admission sheds load while the whole pool is down. The
default `FaultPlan.none()` arms none of it and is bit-identical.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core import timing
from repro_torch.core.batched import update_pipeline_info
from repro_torch.core.scheduler import GPUCostModel
from repro_torch.serving.events import EventQueue
from repro_torch.serving.faults import FaultInjector, FaultPlan
from repro_torch.serving.fleet import FleetState
from repro_torch.serving.obs import (PID_SERVER, TID_DOWN, MetricsRegistry,
                               drift_report)
from repro_torch.serving.policies import (Assignment, GPURequest, SchedulingPolicy,
                                    make_policy)
from repro_torch.serving.resources import GPUPool, MigrationModel, StreamModel
from repro_torch.serving.session import train_many


def _phi_of(session) -> float:
    """Scene-dynamics signal for scheduling; falls back to the sampling rate
    for sessions that don't expose a φ EMA."""
    return getattr(session, "phi_signal", session.sampling_rate)


@dataclass(frozen=True)
class ServingConfig:
    duration: float = 120.0
    max_queue: int = 16  # server backlog cap per-request admission
    admission_util_cap: float | None = None  # projected per-GPU-load cap
    batch_labeling: bool = True
    sample_eps: float = 1e-6  # floor on sampling rate when scheduling
    # ---- pool knobs (n_gpus=1 + defaults == the single-GPU engine) -------
    n_gpus: int = 1
    migration: MigrationModel = field(default_factory=MigrationModel)
    residency_cap: int | None = None  # sessions resident per device (None: HBM unbounded)
    # ---- fidelity knobs (0 == unmodeled) ---------------------------------
    asr_ctrl_bytes: int = 0  # rate-control message on the downlink
    # ---- fused cross-session training (core.batched) ---------------------
    # max sessions per stacked train launch: a granted device also takes up
    # to fuse_train-1 ready "riders" whose staging cost is beaten by the
    # fused-stack discount, and runs the whole stack as one vmap
    # lifecycle priced by `GPUCostModel.train_batch_s`. 1 == coalescing
    # off.
    fuse_train: int = 1
    # fused post-train update pipeline: a fused grant's B deltas are
    # produced by ONE stacked selection launch + ONE batched encode, priced
    # by the amortized `GPUCostModel.update_batch_s` instead of B serial
    # `update_solo_s` charges. No-op until the update path is priced
    # (select_s / delta_comp_s_per_mb), so defaults stay bit-identical;
    # False keeps the per-session pricing (the A/B lever for benchmarks).
    fuse_updates: bool = True
    # ---- dual-stream device model (resources.StreamModel) ----------------
    # label vs train stream interaction per device. The default (serialized,
    # no preemption) is the single busy clock, bit-for-bit.
    streams: StreamModel = field(default_factory=StreamModel)
    # ---- fault injection (serving.faults) --------------------------------
    # seeded chaos schedule: link loss/outages, rate-trace replay, device
    # crash/slowdown windows. The default `FaultPlan.none()` disables every
    # hook — the engine's schedule is bit-identical to the fault-free code.
    faults: FaultPlan = field(default_factory=FaultPlan)
    # ---- device placement (resources.GPUPool) ----------------------------
    # "torch" binds every pool slot to a CUDA card and fused grant math
    # runs on the granted slot's card (raises without CUDA); "modeled"
    # (default) binds nothing and places nothing.
    device_backend: str = "modeled"
    # per-client phase offsets for fleet-wide FaultPlan rate traces: each
    # client's cyclic bandwidth replay starts at a deterministic
    # client-id-hashed point in the trace period, so fleet-wide fades
    # decorrelate instead of synchronizing every uplink. False (default)
    # replays every link in phase.
    trace_phase_per_client: bool = False


@dataclass
class _Segment:
    """One frame batch on a device's label stream — the preemption quantum.

    Created when a backlog's unlabeled frames are put on a stream (either
    as a grant's own labeling or as cross-client prefetch). Carries its
    scheduled completion ``bound``; requeued segments get a fresh bound in
    their new launch."""

    client: int
    idxs: list
    bound: float = 0.0  # absolute completion time in its current launch
    done: bool = False
    preempts: int = 0  # times this batch was requeued by someone else's cut


@dataclass
class _LabelLaunch:
    """One batched labeling launch charged on a device's label stream."""

    gid: int
    start: float
    end: float
    segs: list
    cut: float | None = None  # preemption boundary: segments past it requeued

    def live_at(self, t: float) -> bool:
        return self.cut is None and self.end > t


@dataclass
class _Backlog:
    """Server-side state for one queued request."""

    req: GPURequest
    idxs: list  # frame indices not yet put on a label stream
    segment: _Segment | None = None  # labeling segment, once scheduled


class ServingEngine:
    def __init__(self, sessions, policy: str | SchedulingPolicy = "fair",
                 cost: GPUCostModel | None = None,
                 cfg: ServingConfig | None = None,
                 pool: GPUPool | None = None,
                 tracer=None):
        if isinstance(sessions, FleetState):
            # fleet mode: struct-of-arrays storage; `self.sessions` is a
            # lazy sequence of per-client flyweight views, so every scalar
            # path below runs unchanged against the arrays
            self.fleet = sessions
            self.sessions = sessions.views()
        else:
            self.fleet = None
            self.sessions = list(sessions)
        self.policy = make_policy(policy)
        self.cost = cost or GPUCostModel()
        self.cfg = cfg or ServingConfig()
        self.pool = pool or GPUPool(
            n_gpus=self.cfg.n_gpus, cost=self.cost,
            migration=self.cfg.migration,
            residency_cap=self.cfg.residency_cap,
            streams=self.cfg.streams,
            device_backend=self.cfg.device_backend)
        self.q = EventQueue()
        self._queue: list[_Backlog] = []
        self._active: set[int] = set()  # clients mid-phase on some device
        self._label_sched: dict[int, list[_LabelLaunch]] = {
            d.gid: [] for d in self.pool.devices}
        self._handlers = {
            "sample": self._on_sample, "eval": self._on_eval,
            "upload": self._on_upload, "request": self._on_request,
            "gpu_done": self._on_gpu_done, "gpu_free": self._on_gpu_free,
            "label_seg": self._on_label_seg,
            "delta": self._on_delta, "rate_ctrl": self._on_rate_ctrl,
            "upload_retry": self._on_upload_retry,
            "delta_retx": self._on_delta_retx,
            "crash": self._on_crash, "recover": self._on_recover,
            "watchdog": self._on_watchdog}
        # fleet mode only: handlers for cohort events (Event.client is an
        # ndarray of client ids sharing one (time, kind))
        self._batch_handlers = {
            "sample": self._on_sample_batch, "eval": self._on_eval_batch,
            "upload": self._on_upload_batch,
            "request": self._on_request_batch}
        # vectorized policy path: one `rank` call over parallel request
        # arrays replaces the per-grant pick loop. Only sound when the
        # policy keeps the base `assign`/`place` (AffinityAware's joint
        # assignment, for one, must keep its own loop)
        self._ranked_assign = (
            self.fleet is not None
            and type(self.policy).assign is SchedulingPolicy.assign
            and type(self.policy).place is SchedulingPolicy.place
            and type(self.policy).rank is not SchedulingPolicy.rank)
        # fault injection (serving.faults). Like tracing, every hook is
        # behind the `_chaos` flag, so a fault-free plan does no extra work,
        # pushes no extra events, and keeps the schedule bit-identical
        self._chaos = self.cfg.faults.active
        self._inj = FaultInjector(self.cfg.faults) if self._chaos else None
        self._grant_gen = 0  # monotone grant ids (crash/watchdog matching)
        self._live_grants: dict[int, dict] = {}  # gen -> in-flight grant
        self._grant_on: dict[int, int] = {}  # gid -> gen of its live grant
        self._delta_seq: dict[int, int] = {}  # client -> freshest delta id
        self._last_delta_arrival: dict[int, float] = {}  # staleness telemetry
        if self._chaos:
            plan = self.cfg.faults
            # trace_phase_per_client decorrelates the fleet-wide replay:
            # each client's link starts at a deterministic id-hashed point
            # of the cyclic trace (network.RateTrace.for_client); off
            # (default) every link replays in phase, bit-identical to the
            # unphased engine (for_client(0-offset) is `is`-same object)
            phased = self.cfg.trace_phase_per_client
            for s in self.sessions:
                if plan.up_rate_trace is not None:
                    s.net.up.trace = (plan.up_rate_trace.for_client(s.idx)
                                      if phased else plan.up_rate_trace)
                if plan.down_rate_trace is not None:
                    s.net.down.trace = (plan.down_rate_trace.for_client(s.idx)
                                        if phased else plan.down_rate_trace)
        # flight recorder (serving.obs.Tracer). None = tracing off: every
        # emission site is behind an `is not None` check, so the disabled
        # engine does no extra work and its schedule is bit-identical
        self.tracer = tracer
        if tracer is not None:
            tracer.setup_engine(self.pool, self.sessions, self.cfg)
            self.pool.tracer = tracer
            for s in self.sessions:
                # a sample_clients subset leaves unsampled links untraced —
                # their transfers take the no-tracer fast path, zero spans
                if tracer.traces_client(s.idx):
                    s.net.tracer = tracer
                    s.net.client = s.idx
        self._grant_spans: dict = {}  # gid -> open device-grant span
        self._grant_seq = 0  # stable grant ids (span nesting + flows)
        # telemetry: every counter lives in the registry, and the results
        # dict is assembled from it — `obs.MetricsRegistry` is the single
        # source (same keys/values as the historical inline dict)
        m = self.metrics = MetricsRegistry()
        self.served = m.counter("phases_served")
        self.deferred = m.counter("phases_deferred")
        self.dropped_requests = m.counter("dropped_requests")
        self.label_batches = m.counter("label_batches")
        self.labels_total = m.counter("labels_total")
        self.max_backlog = m.gauge("max_backlog", 0)
        self.fused_launches = m.counter("fused_launches")  # >= 1 rider
        self.fused_sessions = m.counter("fused_sessions")
        # update-pipeline telemetry (post-train selection + delta encode)
        self.update_batched_launches = m.counter(
            "update_pipeline.batched_launches")
        self.update_batched_sessions = m.counter(
            "update_pipeline.batched_sessions")
        self.update_s_charged = m.counter(
            "update_pipeline.update_s_charged", 0.0)
        self.update_s_sequential = m.counter(
            "update_pipeline.update_s_sequential", 0.0)
        # request conservation (the chaos gate's books must balance:
        # enqueued == granted + dropped + unserved backlog, always)
        self.requests_enqueued = m.counter("requests_enqueued")
        self.requests_granted = m.counter("requests_granted")
        # wasted uplink: a tail-dropped victim's frames already crossed the
        # air — their bytes were spent for nothing (saturation telemetry)
        self.dropped_frame_bytes = m.counter("dropped_frame_bytes")
        # chaos telemetry (all zero in fault-free runs)
        self.chaos_upload_retries = m.counter("chaos.upload_retries")
        self.chaos_uploads_lost = m.counter("chaos.uploads_lost")
        self.chaos_uploads_abandoned = m.counter("chaos.uploads_abandoned")
        self.chaos_upload_bytes_wasted = m.counter(
            "chaos.upload_bytes_wasted")
        self.chaos_deltas_lost = m.counter("chaos.deltas_lost")
        self.chaos_deltas_retransmitted = m.counter(
            "chaos.deltas_retransmitted")
        self.chaos_retransmitted_bytes = m.counter(
            "chaos.retransmitted_bytes")
        self.chaos_deltas_superseded = m.counter("chaos.deltas_superseded")
        self.chaos_superseded_bytes = m.counter("chaos.superseded_bytes")
        self.chaos_deltas_abandoned = m.counter("chaos.deltas_abandoned")
        self.chaos_requests_shed = m.counter("chaos.requests_shed")
        self.chaos_grants_killed = m.counter("chaos.grants_killed")
        self.chaos_grants_recovered = m.counter("chaos.grants_recovered")
        self.chaos_sessions_recovered = m.counter(
            "chaos.sessions_recovered")
        self.chaos_watchdog_fires = m.counter("chaos.watchdog_fires")
        self.chaos_slowed_grants = m.counter("chaos.slowed_grants")

    # ---- admission control ---------------------------------------------
    def _admit_sessions(self) -> None:
        """Project each session's steady-state GPU demand against the pool's
        aggregate budget (``admission_util_cap`` per device). Instead of
        rejecting whichever sessions happen to be indexed last (the
        single-GPU rule), admission is gain-aware: sessions are considered in
        descending-φ order, so when the pool is oversubscribed it is the
        lowest-φ (near-static) sessions that get *parked* — they run
        inference-only on stale weights; their accuracy decay is the
        saturation signal, not a crash."""
        if self.fleet is not None:
            self._admit_fleet()
            return
        cap = self.cfg.admission_util_cap
        budget = None if cap is None else cap * self.pool.n
        rho = []
        for s in self.sessions:
            est_frames = s.sampling_rate * s.t_update
            # project with the batched per-frame labeling rate. Slightly
            # conservative on purpose: the launch overhead amortizes across
            # co-queued sessions at service time, which can't be known here
            if self.cfg.batch_labeling:
                label_s = self.cost.label_batch_s(est_frames)
            else:
                label_s = est_frames * self.cost.teacher_infer_s
            fuse = max(self.cfg.fuse_train, 1)
            if fuse > 1:
                # project the amortized per-session share of a full fused
                # launch — the same sublinear cost the grants will pay
                train_s = self.cost.train_batch_s(fuse, s.k_iters) / fuse
            else:
                train_s = s.k_iters * self.cost.train_iter_s
            # post-train update production (selection + delta encode) runs
            # on the same train stream; priced amortized when fused grants
            # will batch it (zero while the update path is unmodeled)
            hint = getattr(s, "delta_bytes_hint", 0)
            if fuse > 1 and self.cfg.fuse_updates:
                update_s = self.cost.update_batch_s([hint] * fuse) / fuse
            else:
                update_s = self.cost.update_solo_s(hint)
            # overlap-aware projection: concurrent streams demand less than
            # the serialized sum (serialized: exactly label_s + train_s)
            demand = self.cfg.streams.stream_demand_s(label_s,
                                                      train_s + update_s)
            rho.append(demand / max(s.t_update, 1e-9))
        if budget is None:  # index order: keeps the load sum bit-identical
            order = range(len(self.sessions))
        else:
            order = sorted(range(len(self.sessions)),
                           key=lambda i: (-_phi_of(self.sessions[i]), i))
        load = 0.0
        full = False
        for i in order:
            s = self.sessions[i]
            # strict priority: once the budget refuses a session, everything
            # ranked below it is parked too — "the parked set is the lowest-φ
            # suffix" is an invariant, not a tendency (no skip-ahead where a
            # small near-static session trains while a dynamic one is parked)
            if full or (budget is not None and load + rho[i] > budget):
                s.admitted = False  # parked
                full = True
            else:
                s.admitted = True
                load += rho[i]
        self.offered_load = load

    def _admit_fleet(self) -> None:
        """`_admit_sessions` over the fleet arrays. Demand is priced once
        per *unique* (rate, T_update, K, delta-hint) row using the same
        scalar cost-model calls the per-object loop makes — bit-identical
        by construction, no float-formula mirroring — then scattered back.
        Parking is one stable argsort by (-φ, idx) plus a cumsum: the
        parked set is a *suffix* of a total strict-priority order and the
        load sum is sequential, so an argpartition (no total order, pairwise
        sums) could not reproduce the per-object books."""
        f, cfg = self.fleet, self.cfg
        cap = cfg.admission_util_cap
        budget = None if cap is None else cap * self.pool.n
        cols = np.column_stack([f.sampling_rate, f.t_update,
                                f.k_iters.astype(np.float64),
                                f.delta_bytes.astype(np.float64)])
        rows, inv = np.unique(cols, axis=0, return_inverse=True)
        fuse = max(cfg.fuse_train, 1)
        rho_u = np.empty(len(rows))
        for j, (s_rate, t_upd, k, hint) in enumerate(rows):
            k, hint = int(k), int(hint)
            est_frames = s_rate * t_upd
            if cfg.batch_labeling:
                label_s = self.cost.label_batch_s(est_frames)
            else:
                label_s = est_frames * self.cost.teacher_infer_s
            if fuse > 1:
                train_s = self.cost.train_batch_s(fuse, k) / fuse
            else:
                train_s = k * self.cost.train_iter_s
            if fuse > 1 and cfg.fuse_updates:
                update_s = self.cost.update_batch_s([hint] * fuse) / fuse
            else:
                update_s = self.cost.update_solo_s(hint)
            demand = cfg.streams.stream_demand_s(label_s,
                                                 train_s + update_s)
            rho_u[j] = demand / max(t_upd, 1e-9)
        rho = rho_u[inv]
        if budget is None:
            f.admitted[:] = True
            # cumsum is a sequential scan — same IEEE addition order as the
            # per-object `load += rho[i]` loop (np.sum's pairwise tree isn't)
            self.offered_load = float(np.cumsum(rho)[-1]) if len(rho) else 0.0
            return
        order = np.argsort(-f.phi, kind="stable")  # (-φ, idx) ascending
        csum = np.cumsum(rho[order])
        over = csum > budget
        first_bad = int(np.argmax(over)) if over.any() else len(order)
        adm = np.zeros(f.n, dtype=bool)
        adm[order[:first_bad]] = True
        f.admitted[:] = adm
        self.offered_load = float(csum[first_bad - 1]) if first_bad else 0.0

    # ---- event handlers ------------------------------------------------
    def _on_sample(self, ev) -> None:
        s = self.sessions[ev.client]
        s.capture(ev.time)
        nxt = ev.time + 1.0 / max(s.edge_sampling_rate, self.cfg.sample_eps)
        if nxt < self.cfg.duration:
            self.q.push(nxt, "sample", ev.client)

    def _on_eval(self, ev) -> None:
        s = self.sessions[ev.client]
        s.evaluate(ev.time)
        nxt = ev.time + s.eval_interval_s
        if nxt < self.cfg.duration:
            self.q.push(nxt, "eval", ev.client)

    def _on_upload(self, ev) -> None:
        self._upload_one(ev.time, ev.client)

    def _upload_one(self, t: float, client: int) -> None:
        s = self.sessions[client]
        idxs = s.take_outbox()
        nbytes = s.upload_bytes(len(idxs))
        if self._chaos:
            self._try_upload(t, client, idxs, nbytes, 0)
        else:
            arrival = s.net.send_up(t, nbytes)
            self.q.push(arrival, "request", client, (idxs, nbytes))
        nxt = t + s.t_update
        if nxt < self.cfg.duration:
            self.q.push(nxt, "upload", client)

    def _try_upload(self, t: float, client: int, idxs, nbytes: int,
                    attempt: int) -> None:
        """Chaos uplink path: an outage defers the send (no link occupancy),
        a lost transfer burns the link and retries with exponential backoff
        + deterministic jitter; past ``max_retries`` the batch is abandoned
        (the edge keeps sampling — degradation, not a stall)."""
        inj, plan = self._inj, self.cfg.faults
        s = self.sessions[client]
        if inj.outage_until("up", client, t) is not None:
            if attempt >= plan.max_retries:
                self.chaos_uploads_abandoned.inc()
                self.dropped_frame_bytes.inc(nbytes)
                return
            self.chaos_upload_retries.inc()
            retry_t = (t + plan.detect_timeout_s
                       + inj.backoff_s(client, attempt))
            self.q.push(retry_t, "upload_retry", client,
                        (idxs, nbytes, attempt + 1))
            return
        what = "frames" if attempt == 0 else "retry"
        arrival = s.net.send_up(t, nbytes, what=what)
        if inj.transfer_lost("up", client):
            # the bytes crossed the air and vanished: wasted uplink
            self.chaos_uploads_lost.inc()
            self.chaos_upload_bytes_wasted.inc(nbytes)
            if attempt >= plan.max_retries:
                self.chaos_uploads_abandoned.inc()
                self.dropped_frame_bytes.inc(nbytes)
                return
            self.chaos_upload_retries.inc()
            retry_t = (arrival + plan.detect_timeout_s
                       + inj.backoff_s(client, attempt))
            self.q.push(retry_t, "upload_retry", client,
                        (idxs, nbytes, attempt + 1))
            return
        self.q.push(arrival, "request", client, (idxs, nbytes))

    def _on_upload_retry(self, ev) -> None:
        idxs, nbytes, attempt = ev.payload
        self._try_upload(ev.time, ev.client, idxs, nbytes, attempt)

    def _on_request(self, ev) -> None:
        s = self.sessions[ev.client]
        idxs, nbytes = ev.payload
        req = GPURequest(client=ev.client, t_request=ev.time,
                         n_frames=len(idxs), k_iters=s.k_iters,
                         deadline=ev.time + s.t_update,
                         phi=_phi_of(s), t_update=s.t_update,
                         state_bytes=getattr(s, "state_bytes", 0),
                         upload_nbytes=int(nbytes))
        self._enqueue(ev.time, req, list(idxs))

    # ---- fleet cohort handlers ------------------------------------------
    # A cohort event carries an ndarray of client ids sharing one (time,
    # kind); the handlers update whole array slices and re-group the
    # follow-on events into cohorts by their (identical-within-group) next
    # timestamps. Every expression mirrors its scalar twin operand-for-
    # operand, and every cohort is pushed in ascending client order, so the
    # (time, seq) pop sequence — and therefore the schedule — is the one
    # the per-object engine produces.
    def _push_cohorts(self, times: np.ndarray, kind: str,
                      clients: np.ndarray, payload_arrays=None) -> None:
        """Push per-client events grouped into cohorts of equal timestamp,
        ascending in time (matching the seq order a scalar loop over the
        same clients would assign)."""
        if not len(times):
            return
        order = np.argsort(times, kind="stable")
        st = times[order]
        cuts = np.flatnonzero(st[1:] != st[:-1]) + 1
        for grp in np.split(order, cuts):
            payload = (None if payload_arrays is None
                       else tuple(a[grp] for a in payload_arrays))
            self.q.push(float(times[grp[0]]), kind, clients[grp], payload)

    def _on_sample_batch(self, t: float, clients: np.ndarray,
                         payload=None) -> None:
        f = self.fleet
        f.outbox_depth[clients] += 1
        nxt = t + 1.0 / np.maximum(f.effective_rate(clients),
                                   self.cfg.sample_eps)
        live = nxt < self.cfg.duration
        if live.any():
            self._push_cohorts(nxt[live], "sample", clients[live])

    def _on_eval_batch(self, t: float, clients: np.ndarray,
                       payload=None) -> None:
        f = self.fleet
        vals = np.maximum(0.2, 0.9 - f.dynamics[clients]
                          * (t - f.last_update_t[clients]))
        f.record_mious(clients, vals)
        nxt = t + f.eval_interval_s[clients]
        live = nxt < self.cfg.duration
        if live.any():
            self._push_cohorts(nxt[live], "eval", clients[live])

    def _on_upload_batch(self, t: float, clients: np.ndarray,
                         payload=None) -> None:
        f = self.fleet
        if self._chaos or self.tracer is not None or f.any_link_traces:
            # chaos retries and trace spans interleave per-client pushes
            # whose seq assignment the cohort math can't reproduce — take
            # the exact scalar lane instead (same code as per-object)
            for c in clients.tolist():
                self._upload_one(t, c)
            return
        depth = f.outbox_depth[clients].copy()
        f.outbox_depth[clients] = 0
        nbytes = 256 + depth * f.frame_bytes[clients]
        f.up_bytes[clients] += nbytes  # ledger + Link.bytes_carried in one
        f.up_transfers[clients] += 1
        start = np.maximum(t, f.up_busy[clients])
        rate = f.up_kbps[clients]
        tx = np.divide(nbytes * 8.0, rate * 1e3,
                       out=np.zeros(len(clients)), where=rate > 0)
        busy = start + tx
        f.up_busy[clients] = busy
        self._push_cohorts(busy + f.prop_delay_s[clients], "request",
                           clients, (depth, nbytes))
        nxt = t + f.t_update[clients]
        live = nxt < self.cfg.duration
        if live.any():
            self._push_cohorts(nxt[live], "upload", clients[live])

    def _on_request_batch(self, t: float, clients: np.ndarray,
                          payload) -> None:
        depths, nbytes = payload
        cl = clients.tolist()
        dp = depths.tolist()
        nb = nbytes.tolist()
        # bulk tail-drop: with the base (tail-drop) evict rule, no tracer
        # and no chaos, a full queue whose worst entry still precedes
        # (t, next client) makes every remaining cohort member its own
        # victim — account them all at once instead of building a
        # GPURequest each just to drop it. (The per-object path's
        # `_refresh_phi` before evict is a no-op for stub fleets: φ is a
        # configured constant, never an EMA.)
        fast_drop = (self.tracer is None and not self._chaos
                     and type(self.policy).evict is SchedulingPolicy.evict)
        n = len(cl)
        for i in range(n):
            if fast_drop and len(self._queue) >= self.cfg.max_queue:
                worst = max((b.req.t_request, b.req.client)
                            for b in self._queue)
                if worst < (t, cl[i]):
                    k = n - i
                    self.requests_enqueued.inc(k)
                    if not self.pool.has_free():
                        self.deferred.inc(k)
                    self.dropped_requests.inc(k)
                    self.dropped_frame_bytes.inc(int(sum(nb[i:])))
                    return
            c = cl[i]
            s = self.sessions[c]
            req = GPURequest(client=c, t_request=t, n_frames=dp[i],
                             k_iters=s.k_iters, deadline=t + s.t_update,
                             phi=_phi_of(s), t_update=s.t_update,
                             state_bytes=getattr(s, "state_bytes", 0),
                             upload_nbytes=int(nb[i]))
            self._enqueue(t, req, [0] * dp[i])

    def _enqueue(self, t: float, req: GPURequest, idxs: list) -> None:
        """Admission for a server-side request — fresh arrivals and
        watchdog-recovered requeues both land here, so the conservation
        books (enqueued == granted + dropped + backlog) balance by
        construction."""
        self.requests_enqueued.inc()
        if self._chaos and self.pool.n_alive() == 0:
            # the whole pool is down: shed at admission instead of queueing
            # unboundedly behind devices that cannot drain the backlog
            self.chaos_requests_shed.inc()
            self.dropped_requests.inc()
            self.dropped_frame_bytes.inc(req.upload_nbytes)
            return
        if not self.pool.has_free():
            self.deferred.inc()
        if len(self._queue) >= self.cfg.max_queue:
            # saturated: the policy chooses the sacrifice (tail drop by
            # default; gain-aware evicts the lowest-value queued request)
            self._refresh_phi()
            victim = self.policy.evict(t, [b.req for b in self._queue] + [req])
            self.dropped_requests.inc()  # the victim's frames are lost
            self.dropped_frame_bytes.inc(victim.upload_nbytes)
            if victim is req:
                return
            self._queue.remove(next(b for b in self._queue if b.req is victim))
        self._queue.append(_Backlog(req=req, idxs=idxs))
        self.max_backlog.set_max(len(self._queue))
        if self.tracer is not None:
            self._trace_queue(t)
        self._maybe_start(t)

    def _maybe_start(self, t: float) -> None:
        # no new grants past the horizon: the backlog is left unserved (and
        # reported) rather than drained in overtime, which would overstate
        # both utilization and served-phase counts
        if not self._queue or t >= self.cfg.duration:
            return
        free = self.pool.free_ids()
        if not free:
            return
        self._refresh_phi()
        # one candidate per *idle* client: a session's training state is
        # singular, so a client mid-phase on some device is ineligible (two
        # devices cannot train the same weights concurrently), and only its
        # oldest queued request competes — every policy's ranking already
        # reduces same-client duplicates to the oldest one
        ready: dict[int, GPURequest] = {}
        for b in self._queue:
            c = b.req.client
            if c in self._active:
                continue
            if c not in ready or b.req.t_request < ready[c].t_request:
                ready[c] = b.req
        if not ready:
            return
        if self._ranked_assign:
            assignments = self._assign_ranked(t, list(ready.values()), free)
        else:
            assignments = self.policy.assign(
                t, list(ready.values()), free, self.pool)
        taken = [a.req for a in assignments]
        for a in assignments:
            riders = []
            if self.cfg.fuse_train > 1:
                # fill the stacked launch: ready requests not claimed this
                # round that are free (or cheap enough — see the cost-aware
                # `coalesce`) to train on the granted device
                leftover = [r for r in ready.values()
                            if not any(r is x for x in taken)]
                riders = self.policy.coalesce(t, a, leftover, self.pool,
                                              self.cfg.fuse_train)
                taken.extend(riders)
            backlog = next(b for b in self._queue if b.req is a.req)
            self._queue.remove(backlog)
            rider_backlogs = []
            for r in riders:
                rb = next(b for b in self._queue if b.req is r)
                self._queue.remove(rb)
                rider_backlogs.append(rb)
            self.requests_granted.inc(1 + len(rider_backlogs))
            self._start_service(t, backlog, a.gpu, rider_backlogs)
        if self.tracer is not None:
            self._trace_queue(t)

    def _assign_ranked(self, t, reqs, free):
        """Vectorized policy path: one `rank` call over parallel request
        arrays replaces the pick-loop, devices are handed out in ascending
        id order — exactly what base `place` (min of a shrinking free list)
        does. Stateful policies (fair's turn pointer) advance as if the
        taken prefix had been picked one by one."""
        k = len(reqs)
        clients = np.fromiter((r.client for r in reqs), np.int64, k)
        t_req = np.fromiter((r.t_request for r in reqs), np.float64, k)
        deadline = np.fromiter((r.deadline for r in reqs), np.float64, k)
        phi = np.fromiter((r.phi for r in reqs), np.float64, k)
        t_upd = np.fromiter((r.t_update for r in reqs), np.float64, k)
        free_sorted = sorted(free)
        order = self.policy.rank(t, clients=clients, t_request=t_req,
                                 deadline=deadline, phi=phi, t_update=t_upd,
                                 limit=len(free_sorted))
        return [Assignment(req=reqs[int(j)], gpu=g)
                for j, g in zip(order, free_sorted)]

    def _trace_queue(self, t: float) -> None:
        """Server-process counter tracks: the ready queue in requests and in
        unlabeled frames (the labeling backlog a grant would clear)."""
        tr = self.tracer
        tr.counter(PID_SERVER, "queue_depth", t,
                   {"requests": len(self._queue)})
        tr.counter(PID_SERVER, "backlog_frames", t,
                   {"frames": sum(len(b.idxs) for b in self._queue)})

    def _refresh_phi(self) -> None:
        # a request's φ is snapshotted at arrival; batched labeling can move
        # the session's φ EMA while it queues, so re-read before any policy
        # decision — otherwise a feed that just turned dynamic is ranked
        # (and evicted) by its stale near-static score
        for b in self._queue:
            b.req.phi = _phi_of(self.sessions[b.req.client])

    def _rider_migration_s(self, gid: int, riders: list[_Backlog]) -> list[float]:
        return [self.pool.migration_s(b.req.client, gid, b.req.state_bytes)
                for b in riders]

    def _start_service(self, t: float, backlog: _Backlog, gid: int,
                       riders: list[_Backlog] | None = None) -> None:
        if not self.cfg.streams.legacy:
            self._start_service_streams(t, backlog, gid, riders or [])
            return
        dev = self.pool.device(gid)
        riders = riders or []
        # injected device slowdown (thermal throttle / noisy neighbor):
        # compute stretches, data movement (migration) does not
        slow = (self._inj.slowdown_factor(gid, t) if self._chaos else 1.0)
        if slow > 1.0:
            self.chaos_slowed_grants.inc()
        # cross-client batched labeling: one launch on the granted device
        # clears every still-queued session's unlabeled frames, not just the
        # picked one (a co-granted device then finds its backlog pre-labeled)
        if self.cfg.batch_labeling:
            to_label = [backlog, *riders] + [b for b in self._queue if b.idxs]
        else:
            to_label = [backlog, *riders]
        n_label = sum(len(b.idxs) for b in to_label)
        label_s = dev.cost.label_batch_s(n_label) * slow
        if n_label:
            self.label_batches.inc()
            self.labels_total.inc(n_label)
        # staging a non-resident session's state runs on this device's clock
        # *before* the labeling launch, so labels land at t + mig_s + label_s;
        # a cost-aware rider's staging runs after (labels don't need it)
        mig_s = self.pool.migration_s(backlog.req.client, gid,
                                      backlog.req.state_bytes)
        rider_migs = self._rider_migration_s(gid, riders)
        t_labeled = t + mig_s + label_s
        for b in to_label:
            self.sessions[b.req.client].label_and_ingest(b.idxs, t_labeled)
            b.idxs = []
        n_sessions = 1 + len(riders)
        train_s = dev.cost.train_batch_s(n_sessions, backlog.req.k_iters) * slow
        dur = mig_s + label_s + sum(rider_migs) + train_s
        self.pool.grant(gid, backlog.req.client, t, dur, self.cfg.duration,
                        mig_s, label_s)
        tr = self.tracer
        if tr is not None:
            # legacy single-clock path: the pool keeps no per-charge
            # schedule, so the engine emits the component spans itself
            # (they tile [t, t+dur] in the order the clock charges them)
            self._grant_seq += 1
            self._grant_spans[gid] = tr.grant_span(
                gid, "grant", t, {"seq": self._grant_seq,
                                  "client": backlog.req.client,
                                  "riders": len(riders)})
            sub = {"grant": self._grant_seq}
            if mig_s > 0.0:
                tr.gpu_span(gid, "train", "migrate", t, t + mig_s, dict(sub))
            if n_label:
                tr.gpu_span(gid, "label", "label_batch", t + mig_s,
                            t_labeled, dict(sub, frames=n_label))
            rmig = sum(rider_migs)
            if rmig > 0.0:
                tr.gpu_span(gid, "train", "migrate_riders", t_labeled,
                            t_labeled + rmig, dict(sub))
            tr.gpu_span(gid, "train", "train", t + dur - train_s, t + dur,
                        dict(sub, b=n_sessions, k=backlog.req.k_iters))
        for b in [backlog, *riders]:
            b.req.gpu = gid
            self._active.add(b.req.client)
        for b, r_mig in zip(riders, rider_migs):
            self.pool.attach(gid, b.req.client, t, mig_s=r_mig)
        if riders:
            self.fused_launches.inc()
            self.fused_sessions.inc(n_sessions)
        gen = self._note_grant(gid, [backlog, *riders], t + dur)
        self.q.push(t + dur, "gpu_done", backlog.req.client,
                    (gid, tuple(b.req.client for b in riders), gen))

    def _note_grant(self, gid: int, members: list, done_t: float) -> int:
        """Register a grant generation. Under chaos the grant is tracked as
        in-flight and a watchdog is armed past its planned completion: if
        the device dies mid-grant, ``gpu_done`` never lands and the watchdog
        is what detects the straggler and requeues the fused group."""
        self._grant_gen += 1
        gen = self._grant_gen
        if self._chaos:
            self._live_grants[gen] = {
                "gid": gid, "done_t": done_t, "dead": False,
                "clients": [b.req.client for b in members]}
            self._grant_on[gid] = gen
            self.q.push(done_t + self.cfg.faults.watchdog_s, "watchdog",
                        members[0].req.client, gen)
        return gen

    # ---- dual-stream service path --------------------------------------
    def _take_segment(self, b: _Backlog) -> _Segment:
        seg = _Segment(client=b.req.client, idxs=b.idxs)
        b.idxs = []
        b.segment = seg
        return seg

    def _charge_label_launch(self, gid: int, t: float, segs: list[_Segment],
                             scale: float = 1.0) -> _LabelLaunch | None:
        """One batched labeling launch for ``segs`` on ``gid``'s label
        stream; each segment completes at a frame-batch boundary and gets
        its own `label_seg` event (the preemption quanta). ``scale`` > 1 is
        an injected device slowdown stretching the whole launch."""
        segs = [s for s in segs if s.idxs]
        if not segs:
            return None
        cost = self.pool.device(gid).cost
        rate = cost.teacher_infer_s * cost.label_batch_discount * scale
        cum, work = [], cost.label_batch_overhead_s * scale
        for s in segs:
            work += len(s.idxs) * rate
            cum.append(work)
        args = None
        if self.pool.tracer is not None:
            args = {"frames": sum(len(s.idxs) for s in segs),
                    "segments": len(segs)}
        start, bounds = self.pool.label_bounds(gid, t, cum,
                                               name="label_batch", args=args)
        launch = _LabelLaunch(gid=gid, start=start, end=bounds[-1], segs=segs)
        for s, b in zip(segs, bounds):
            s.bound = b
            s.done = False
            self.q.push(b, "label_seg", s.client, (launch, s))
        self._label_sched[gid].append(launch)
        self.label_batches.inc()
        return launch

    def _preempt_labels(self, gid: int, t: float,
                        member_segs: list[_Segment]) -> list[_Segment]:
        """Split/cancel in-flight labeling on ``gid`` so a grant's own
        labeling (and train phase) need not wait for the tail of whoever's
        labeling. Launches that have not started are cancelled outright
        (free reordering); the one mid-flight is cut at the next frame-batch
        boundary when that beats waiting for its natural end, paying the
        model's preemption cost. Returns the requeued segments, member
        segments first, in their original order."""
        requeued: list[_Segment] = []
        members = {id(s) for s in member_segs}
        max_preempts = self.cfg.streams.max_seg_preempts

        def feeds_active_phase(segs):
            # a mid-phase client's train charge was placed against these
            # bounds — requeueing them would slip labels past the phase
            # that consumes them (the preemptor's own members are not yet
            # active, so they requeue freely)
            return any(not s.done and id(s) not in members
                       and s.client in self._active for s in segs)

        def has_aged_out(segs):
            # priority aging: a frame batch already requeued max_seg_preempts
            # times is uncuttable — its labels cannot be pushed back again,
            # so repeated preemption can't grow one victim's label staleness
            # without bound (the preemptor's own members requeue into the
            # grant's OWN launch, which moves them earlier, so they never age)
            return any(not s.done and id(s) not in members
                       and s.preempts >= max_preempts for s in segs)

        def note_requeue(segs):
            for s in segs:
                if id(s) not in members:
                    s.preempts += 1

        live = [l for l in self._label_sched[gid] if l.live_at(t)]
        # latest charge first: `truncate_label` edits the label stream's
        # tail, so once any launch is KEPT nothing earlier may be touched
        # (and cutting behind a kept launch would free no stream time)
        for launch in reversed(live):
            if launch.start >= t:  # never started: cancel, requeue all
                if feeds_active_phase(launch.segs) or has_aged_out(launch.segs):
                    break
                launch.cut = launch.start
                self.pool.truncate_label(gid, launch.start,
                                         preempted_frames=0, cancel=True)
                self.label_batches.inc(-1)  # never ran; its relaunch recounts
                note_requeue(launch.segs)
                requeued[:0] = launch.segs
                continue
            cut = min((s.bound for s in launch.segs if s.bound > t),
                      default=launch.end)
            tail = [s for s in launch.segs if s.bound > cut]
            if feeds_active_phase(tail) or has_aged_out(tail):
                break
            # a cut buys (end - cut) of label-stream headroom for the
            # grant, but the requeued tail re-pays the launch overhead and
            # the stream eats the preemption charge: only split when the
            # reclaimed tail strictly exceeds that disruption, else the
            # device thrashes at saturation (preempting pure overhead)
            disruption = (self.pool.streams.preempt_cost_s
                          + self.pool.device(gid).cost.label_batch_overhead_s)
            if not tail or launch.end - cut <= disruption:
                break
            launch.cut = cut
            launch.end = cut
            self.pool.truncate_label(
                gid, cut,
                preempted_frames=sum(len(s.idxs) for s in tail))
            note_requeue(tail)
            requeued[:0] = tail
        requeued.sort(key=lambda s: 0 if id(s) in members else 1)
        return requeued

    def _start_service_streams(self, t: float, backlog: _Backlog, gid: int,
                               riders: list[_Backlog]) -> None:
        """The dual-stream grant: migration and the training phase are
        charged to the device's *train* stream, labeling launches to its
        *label* stream, and the train charge waits only for the labels the
        stack itself consumes — cross-client prefetch labeling runs behind
        it (concurrently, under an ``overlap`` model). Everything is placed
        at grant time (boundaries are deterministic), so preemption is a
        schedule edit, not a rollback."""
        members = [backlog, *riders]
        slow = (self._inj.slowdown_factor(gid, t) if self._chaos else 1.0)
        if slow > 1.0:
            self.chaos_slowed_grants.inc()
        tr = self.tracer
        sub = None
        if tr is not None:
            self._grant_seq += 1
            self._grant_spans[gid] = tr.grant_span(
                gid, "grant", t, {"seq": self._grant_seq,
                                  "client": backlog.req.client,
                                  "riders": len(riders)})
            sub = {"grant": self._grant_seq}
        self._label_sched[gid] = [l for l in self._label_sched[gid]
                                  if l.live_at(t)]  # prune history
        # --- labeling: what the stack needs vs what can prefetch ---------
        # the preemption decision comes FIRST: every train-stream charge
        # below (migration included) is placed against the label stream's
        # post-cut schedule, so a serialized grant doesn't pay a preemption
        # that its own staging would have swallowed anyway
        waiting = [b.segment for b in members
                   if b.segment is not None and not b.segment.done]
        # preempting this device's label stream only helps when the grant
        # would otherwise queue behind it: fresh frames to label, a
        # member's segment sitting in one of its live launches — or, under
        # a SERIALIZED model, any live launch at all (it holds the one
        # clock the migration/train charges need)
        live = [l for l in self._label_sched[gid] if l.live_at(t)]
        member_here = any(any(s is w for w in waiting)
                          for l in live for s in l.segs)
        if self.cfg.streams.preempt and live and (
                member_here or not self.cfg.streams.overlapped
                or any(b.idxs for b in members)):
            requeued = self._preempt_labels(gid, t, waiting)
        else:
            requeued = []
        # --- staging: primary + cost-aware riders on the train stream ---
        mig_s = self.pool.migration_s(backlog.req.client, gid,
                                      backlog.req.state_bytes)
        rider_migs = self._rider_migration_s(gid, riders)
        total_mig = mig_s + sum(rider_migs)
        if total_mig > 0.0:
            _, mig_end = self.pool.charge(gid, "train", t, total_mig,
                                          name="migrate", args=sub)
        else:
            mig_end = t
        own = ([s for s in requeued if any(s is b.segment for b in members)]
               + [self._take_segment(b) for b in members if b.idxs])
        self._charge_label_launch(gid, t, own, scale=slow)
        waiting = [b.segment for b in members
                   if b.segment is not None and not b.segment.done]
        t_labeled = max([t] + [s.bound for s in waiting])
        # --- the training phase itself -----------------------------------
        n_sessions = len(members)
        train_s = self.pool.device(gid).cost.train_batch_s(
            n_sessions, backlog.req.k_iters) * slow
        _, done_t = self.pool.charge(
            gid, "train", max(mig_end, t_labeled), train_s, name="train",
            args=None if sub is None else dict(sub, b=n_sessions,
                                               k=backlog.req.k_iters))
        # --- background prefetch: requeued non-member + still-queued -----
        bg = [s for s in requeued if not any(s is b.segment for b in members)]
        if self.cfg.batch_labeling:
            bg += [self._take_segment(b) for b in self._queue if b.idxs]
        self._charge_label_launch(gid, t, bg, scale=slow)
        # --- bookkeeping (same shape as the legacy path) ------------------
        self.pool.grant_streams(gid, backlog.req.client, t)
        self.pool.note_migration(mig_s)
        for b in [backlog, *riders]:
            b.req.gpu = gid
            self._active.add(b.req.client)
        for b, r_mig in zip(riders, rider_migs):
            self.pool.attach(gid, b.req.client, t, mig_s=r_mig)
        if riders:
            self.fused_launches.inc()
            self.fused_sessions.inc(n_sessions)
        gen = self._note_grant(gid, members, done_t)
        self.q.push(done_t, "gpu_done", backlog.req.client,
                    (gid, tuple(b.req.client for b in riders), gen))

    def _on_label_seg(self, ev) -> None:
        launch, seg = ev.payload
        if launch.cut is not None and seg.bound > launch.cut:
            return  # requeued by a preemption; a fresh event exists
        if seg.done:
            return
        seg.done = True
        self.labels_total.inc(len(seg.idxs))
        self.sessions[seg.client].label_and_ingest(seg.idxs, ev.time)

    def _on_gpu_done(self, ev) -> None:
        gid, rider_clients, gen = ev.payload
        if self._chaos:
            info = self._live_grants.get(gen)
            if info is None or info["dead"]:
                # the device died mid-grant: this completion never happened.
                # The armed watchdog is the detector — it requeues the fused
                # group and releases the device
                return
            del self._live_grants[gen]
            self._grant_on.pop(gid, None)
        clients = [ev.client, *rider_clients]
        for c in clients:
            self._active.discard(c)
        if len(clients) == 1:
            deltas = [self.sessions[ev.client].train(ev.time)]
        else:
            # the stacked launch just finished: run the actual fused math —
            # on the granted pool slot's own card when the pool binds one
            # (device_backend="torch"); None places nothing
            deltas = train_many([self.sessions[c] for c in clients], ev.time,
                                device=self.pool.device(gid).torch_device)
        self.served.inc(len(clients))
        legacy = self.cfg.streams.legacy
        cost = self.pool.device(gid).cost
        t_free = ev.time
        tr = self.tracer
        gspan = self._grant_spans.pop(gid, None)
        sub = None if gspan is None else {"grant": gspan.args["seq"]}

        def charge_update(upd_s: float) -> tuple[float, float]:
            nonlocal t_free
            if upd_s <= 0.0:
                return (t_free, t_free)
            if legacy:
                start = t_free
                self.pool.extend_busy(gid, t_free, upd_s, self.cfg.duration)
                t_free = t_free + upd_s
                return (start, t_free)
            start, t_free = self.pool.charge(gid, "train", t_free, upd_s)
            return (start, t_free)

        def trace_update(u0: float, u1: float, sel_s: float, enc_s: float,
                         b: int) -> None:
            # split the charged update seconds into modeled selection vs
            # encode shares. Fused grants emit the pair even when the
            # pipeline is unpriced (zero-duration), so the trace always
            # shows train -> select -> encode nested in the device grant
            total = sel_s + enc_s
            frac = sel_s / total if total > 0.0 else 0.5
            mid = u0 + (u1 - u0) * frac
            tr.gpu_span(gid, "train", "select", u0, mid, dict(sub, b=b))
            tr.gpu_span(gid, "train", "encode", mid, u1, dict(sub, b=b))

        # price the post-train update pipeline: a fused grant's selections
        # and delta encodes ran as ONE stacked launch + ONE batched
        # device->host encode (`core.batched`), so the device is charged the
        # amortized `update_batch_s` once and every delta ships after it —
        # not B serial select/compress round-trips
        sent_bytes = [d.total_bytes for d in deltas if d is not None]
        batched_update = self.cfg.fuse_updates and len(sent_bytes) > 1
        if batched_update:
            upd_s = cost.update_batch_s(sent_bytes)
            if upd_s > 0.0:
                # counters track *priced* amortization only — an unpriced
                # pipeline charges nothing, so it reports nothing here
                # (structural batching still shows in the stacked_* counts)
                self.update_batched_launches.inc()
                self.update_batched_sessions.inc(len(sent_bytes))
                self.update_s_charged.inc(upd_s)
                self.update_s_sequential.inc(sum(cost.update_solo_s(b)
                                                 for b in sent_bytes))
            u0, u1 = charge_update(upd_s)
            if sub is not None:
                trace_update(u0, u1, cost.select_s * len(sent_bytes),
                             sum(cost.delta_comp_s(b) for b in sent_bytes),
                             len(sent_bytes))
        for c, delta in zip(clients, deltas):
            s = self.sessions[c]
            if delta is not None:
                # a real phase ran here (no-op grants don't record one);
                # training phases always execute on the train stream
                s.note_device(gid, "train")
                if not batched_update:
                    upd_s = cost.update_solo_s(delta.total_bytes)
                    self.update_s_charged.inc(upd_s)
                    self.update_s_sequential.inc(upd_s)
                    u0, u1 = charge_update(upd_s)
                    if sub is not None and upd_s > 0.0:
                        trace_update(u0, u1, cost.select_s,
                                     cost.delta_comp_s(delta.total_bytes), 1)
                if self._chaos:
                    # freshest-delta bookkeeping: any older in-flight retry
                    # for this client is now stale and will supersede
                    self._delta_seq[c] = self._delta_seq.get(c, 0) + 1
                    self._send_delta(t_free, c, delta, t_free,
                                     self._delta_seq[c], 0, gspan)
                else:
                    arrival = s.net.send_down(t_free, delta.total_bytes)
                    if gspan is not None and s.net.last_span is not None:
                        tr.flow(gspan, s.net.last_span)
                    self.q.push(arrival, "delta", c, (delta, t_free))
            if self.cfg.asr_ctrl_bytes > 0:
                # the ASR's new rate rides the downlink too (unmodeled, it
                # would be free); the edge samples at its old rate until it lands
                arrival = s.net.send_ctrl(t_free, self.cfg.asr_ctrl_bytes)
                self.q.push(arrival, "rate_ctrl", c, float(s.sampling_rate))
        if gspan is not None:
            # close the grant at its last charged second BEFORE any regrant
            # of this device can open the next one
            gspan.end = t_free
            d = self.pool.device(gid)
            horizon = max(ev.time, 1e-9)
            tr.counter(tr.gpu_pid(gid), "stream_util", ev.time, {
                "label": d.stream_busy_s("label", horizon) / horizon,
                "train": d.stream_busy_s("train", horizon) / horizon})
        if t_free > ev.time:
            self.q.push(t_free, "gpu_free", ev.client, gid)
        else:
            self.pool.release(gid)
        # schedule even while this device compresses: the finished clients
        # are eligible again and other devices may be idle
        self._maybe_start(ev.time)

    def _on_gpu_free(self, ev) -> None:
        self.pool.release(ev.payload)
        self._maybe_start(ev.time)

    # ---- chaos: lossy downlink with supersede semantics -----------------
    def _send_delta(self, t: float, c: int, delta, t_produced: float,
                    seq: int, attempt: int, gspan=None) -> None:
        """Ship a delta over a lossy downlink. An outage defers the send, a
        lost transfer schedules a retransmit after backoff — but a retx is
        *supersede-checked* first (`_on_delta_retx`): if the server has
        produced a newer delta by then, the stale one is never resent
        (retransmitting old weights wastes the paper's precious downlink).
        The arrival event carries the ORIGINAL production time, so delta
        latency honestly reflects retry-induced staleness."""
        inj, plan = self._inj, self.cfg.faults
        s = self.sessions[c]
        if inj.outage_until("down", c, t) is not None:
            if attempt >= plan.max_retries:
                self.chaos_deltas_abandoned.inc()
                return
            retry_t = t + plan.detect_timeout_s + inj.backoff_s(c, attempt)
            self.q.push(retry_t, "delta_retx", c,
                        (delta, t_produced, seq, attempt + 1))
            return
        nbytes = delta.total_bytes
        if attempt > 0:
            self.chaos_deltas_retransmitted.inc()
            self.chaos_retransmitted_bytes.inc(nbytes)
        arrival = s.net.send_down(t, nbytes,
                                  what="delta" if attempt == 0 else "retry")
        if gspan is not None and s.net.last_span is not None:
            self.tracer.flow(gspan, s.net.last_span)
        if inj.transfer_lost("down", c):
            self.chaos_deltas_lost.inc()
            if attempt >= plan.max_retries:
                self.chaos_deltas_abandoned.inc()
                return
            retry_t = (arrival + plan.detect_timeout_s
                       + inj.backoff_s(c, attempt))
            self.q.push(retry_t, "delta_retx", c,
                        (delta, t_produced, seq, attempt + 1))
            return
        self.q.push(arrival, "delta", c, (delta, t_produced))

    def _on_delta_retx(self, ev) -> None:
        delta, t_produced, seq, attempt = ev.payload
        c = ev.client
        if self._delta_seq.get(c, 0) != seq:
            # a fresher delta exists (shipped or shipping): drop this one
            self.chaos_deltas_superseded.inc()
            self.chaos_superseded_bytes.inc(delta.total_bytes)
            if self.tracer is not None and self.tracer.traces_client(c):
                self.tracer.instant(self.tracer.client_pid(c), TID_DOWN,
                                    "supersede", ev.time,
                                    {"bytes": int(delta.total_bytes)})
            return
        self._send_delta(ev.time, c, delta, t_produced, seq, attempt)

    # ---- chaos: device crash / recovery ---------------------------------
    def _on_crash(self, ev) -> None:
        gid, _until = ev.payload
        self.pool.crash(gid, ev.time)
        gen = self._grant_on.get(gid)
        if gen is not None:
            info = self._live_grants.get(gen)
            if info is not None and not info["dead"]:
                # the grant in flight dies with the device; its gpu_done is
                # suppressed and the watchdog will recover the fused group
                info["dead"] = True
                self.chaos_grants_killed.inc()

    def _on_recover(self, ev) -> None:
        self.pool.recover(ev.payload)
        self._maybe_start(ev.time)

    def _on_watchdog(self, ev) -> None:
        gen = ev.payload
        info = self._live_grants.pop(gen, None)
        if info is None:
            return  # the grant completed normally; the watchdog disarms
        gid = info["gid"]
        self._grant_on.pop(gid, None)
        self.chaos_watchdog_fires.inc()
        self.chaos_grants_recovered.inc()
        self.chaos_sessions_recovered.inc(len(info["clients"]))
        gspan = self._grant_spans.pop(gid, None)
        if gspan is not None:
            # close the dead grant at its planned end so its component
            # spans stay nested; mark it so the trace shows the casualty
            gspan.end = info["done_t"]
            if gspan.args is not None:
                gspan.args = dict(gspan.args, crashed=True)
        self.pool.release(gid)
        for c in info["clients"]:
            self._active.discard(c)
            s = self.sessions[c]
            # requeue with no frames: the phase's labels already landed (or
            # died with the device); the session just needs its training
            # phase re-run — residency was spilled by the crash, so the
            # regrant pays a full restage on a surviving device
            req = GPURequest(client=c, t_request=ev.time, n_frames=0,
                             k_iters=s.k_iters,
                             deadline=ev.time + s.t_update,
                             phi=_phi_of(s), t_update=s.t_update,
                             state_bytes=getattr(s, "state_bytes", 0))
            self._enqueue(ev.time, req, [])

    def _on_delta(self, ev) -> None:
        delta, t_sent = ev.payload
        self.sessions[ev.client].apply_delta(delta, t_sent, ev.time)
        if self._chaos:
            self._last_delta_arrival[ev.client] = ev.time

    def _on_rate_ctrl(self, ev) -> None:
        self.sessions[ev.client].apply_rate_ctrl(ev.payload)

    # ---- main loop ------------------------------------------------------
    def _init_events(self) -> None:
        self._admit_sessions()
        if self.fleet is not None:
            self._init_events_fleet()
        else:
            for i, s in enumerate(self.sessions):
                if self.cfg.asr_ctrl_bytes > 0:
                    # the boot-time rate is already on-device; every *change*
                    # from here on must be delivered over the downlink
                    s.apply_rate_ctrl(s.sampling_rate)
                self.q.push(0.0, "eval", i)
                if s.admitted:
                    self.q.push(0.0, "sample", i)
                    self.q.push(min(s.t_update, self.cfg.duration * 0.999),
                                "upload", i)
        if self._chaos:
            dur = self.cfg.duration
            for w in self.cfg.faults.crashes:
                if w.gid >= self.pool.n or w.start >= dur:
                    continue
                self.q.push(w.start, "crash", None, (w.gid, w.end))
                self.q.push(w.end, "recover", None, w.gid)
                if self.tracer is not None:
                    self.tracer.gpu_fault_span(
                        w.gid, "crash", w.start, min(w.end, dur))
            if self.tracer is not None:
                for d, c, a, b in self._inj.outage_windows():
                    if a >= dur:
                        continue
                    targets = ([c] if c is not None
                               else [s.idx for s in self.sessions])
                    for ci in targets:
                        self.tracer.client_fault_span(
                            ci, "outage", max(a, 0.0), min(b, dur),
                            {"direction": d})

    def _init_events_fleet(self) -> None:
        """Cohort twin of the per-session init loop: same events at the
        same times; samples before uploads (seq order) just as the
        interleaved scalar pushes would land."""
        f, cfg = self.fleet, self.cfg
        if cfg.asr_ctrl_bytes > 0:
            f.edge_rate[:] = f.sampling_rate
        all_c = np.arange(f.n, dtype=np.int64)
        self._push_cohorts(np.zeros(f.n), "eval", all_c)
        adm = all_c[f.admitted]
        if len(adm):
            self._push_cohorts(np.zeros(len(adm)), "sample", adm)
            self._push_cohorts(np.minimum(f.t_update[adm],
                                          cfg.duration * 0.999),
                               "upload", adm)

    def _dispatch(self, ev) -> None:
        self._handlers[ev.kind](ev)

    def run(self) -> dict:
        self._init_events()
        handlers = self._handlers
        self._update_snap = update_pipeline_info()  # process-global counters
        self._timing_snap = timing.snapshot()  # wall-clock stage stats
        t0 = time.time()
        if self.fleet is not None:
            # fleet loop: drain the timestamp in one batch; cohort events
            # (ndarray client) go to the array handlers, everything else —
            # grants, deltas, chaos — takes the scalar handlers unchanged
            batch = self._batch_handlers
            while self.q:
                for ev in self.q.pop_batch():
                    if type(ev.client) is np.ndarray:
                        batch[ev.kind](ev.time, ev.client, ev.payload)
                    else:
                        handlers[ev.kind](ev)
        else:
            while self.q:
                ev = self.q.pop()
                handlers[ev.kind](ev)
        wall = time.time() - t0
        return self._results(wall)

    def _results(self, wall_s: float) -> dict:
        """Fold the run into the results dict. Every value routes through
        `self.metrics` (counters accumulated during the run, gauges set
        here), so the registry IS the results — `as_results` preserves the
        historical keys and values bit-for-bit."""
        cfg = self.cfg
        m = self.metrics
        per_client = [s.miou_mean() for s in self.sessions]
        kbps = [s.net.kbps(cfg.duration) for s in self.sessions]
        lat = m.histogram("delta_latency_s")
        lat_lists = [s.latency_values() for s in self.sessions]
        if all(v is not None for v in lat_lists):  # telemetry="full"
            lat.extend(l for v in lat_lists for l in v)
            lat_mean, lat_max = lat.mean(), lat.max()
        else:
            # "moments" sessions fold their samples into running
            # (count, sum, max) — O(1) memory; the histogram stays empty
            n_tot, s_tot, mx = 0, 0.0, 0.0
            for s in self.sessions:
                c, sm, m_ = s.latency_summary()
                n_tot += c
                s_tot += sm
                mx = max(mx, m_)
            lat_mean = s_tot / n_tot if n_tot else 0.0
            lat_max = mx
        n_req = (self.served.value + self.dropped_requests.value
                 + len(self._queue))
        busy_s = sum(d.union_busy_s(cfg.duration) for d in self.pool.devices)
        # this run's wall-clock stage stats (core.timing is process-global;
        # the delta against the snapshot isolates what THIS engine ran)
        stage_stats = timing.delta(getattr(self, "_timing_snap", None))
        compile_s = timing.compile_s(stage_stats)
        m.set("n_clients", len(self.sessions))
        m.set("miou_per_client", per_client)
        m.set("mean_miou", float(np.mean(per_client)))
        m.set("gpu_utilization", busy_s / max(cfg.duration * self.pool.n,
                                              1e-9))
        m.set("phases_per_client", [s.phases for s in self.sessions])
        m.set("scheduler", self.policy.name)
        m.set("admitted_clients", sum(s.admitted for s in self.sessions))
        m.set("parked_clients", [s.idx for s in self.sessions
                                 if not s.admitted])
        m.set("offered_load", self.offered_load)
        m.set("unserved_backlog", len(self._queue))
        m.set("deferral_rate", self.deferred.value / max(n_req, 1))
        # fused training telemetry
        m.set("rider_grants", self.pool.rider_grants)
        # fused post-train update pipeline (stacked select + batched
        # encode): modeled pricing plus the real `core.batched` counters
        # for this run (a stub fleet never enters the real fused math,
        # so its stacked_* counters stay zero by construction)
        m.set("update_pipeline.update_s_saved",
              self.update_s_sequential.value - self.update_s_charged.value)
        for k, v in update_pipeline_info().items():
            m.set(f"update_pipeline.{k}",
                  v - getattr(self, "_update_snap", {}).get(k, v))
        # pool telemetry
        m.set("n_gpus", self.pool.n)
        m.set("per_gpu_utilization", self.pool.utilization(cfg.duration))
        m.set("per_gpu_grants", [d.grants for d in self.pool.devices])
        m.set("migrations", self.pool.migrations)
        m.set("migration_s_total", self.pool.migration_s_total)
        m.set("residency_evictions", self.pool.evictions)
        m.set("devices_per_client", [sorted(set(s.phase_devices))
                                     for s in self.sessions])
        # dual-stream telemetry
        m.set("stream_mode", cfg.streams.mode)
        m.set("per_gpu_stream_utilization",
              self.pool.stream_utilization(cfg.duration))
        m.set("overlap_s", self.pool.overlap_s_total())
        m.set("preemptions", self.pool.preemptions)
        m.set("preempted_frames", self.pool.preempted_frames)
        m.set("preempt_s_total", self.pool.preempt_s_total)
        # network telemetry
        m.set("per_client_kbps", kbps)
        m.set("mean_up_kbps", float(np.mean([u for u, _ in kbps])))
        m.set("mean_down_kbps", float(np.mean([d for _, d in kbps])))
        m.set("delta_latency_mean_s", lat_mean)
        m.set("delta_latency_max_s", lat_max)
        # fault telemetry (plan-level gauges only exist in chaos runs; the
        # chaos.* counters are always registered and zero without faults)
        if self._chaos:
            m.set("chaos.link_outage_s",
                  self._inj.link_outage_s(cfg.duration, len(self.sessions)))
            m.set("chaos.crash_s", self._inj.crash_s(cfg.duration))
            m.set("chaos.device_crashes", self.pool.crashes)
            m.set("chaos.crash_spills", self.pool.crash_spills)
            stale = [cfg.duration - self._last_delta_arrival.get(s.idx, 0.0)
                     for s in self.sessions if s.admitted]
            m.set("chaos.final_staleness_max_s",
                  max(stale) if stale else 0.0)
        m.set("events_processed", self.q.popped)
        m.set("events_per_sec", self.q.popped / max(wall_s, 1e-9))
        # steady-state engine throughput: the first-call (set-up + warm)
        # seconds the timing hooks attributed are excluded from the clock,
        # so this no longer punishes the first fleet a process runs
        m.set("events_per_sec_steady",
              self.q.popped / max(wall_s - compile_s, 1e-9))
        m.set("wall_s", wall_s)
        m.set("observability", {
            "tracing": self.tracer is not None,
            "compile_s": compile_s,
            "stage_timings": timing.totals(stage_stats),
            "drift": drift_report(self.cost, stage_stats),
        })
        return m.as_results()
