"""The port's serving engine (`repro_torch.serving`, `repro_torch.core.
scheduler`, `repro_torch.core.timing`) against the JAX package's.

The engine is JAX-free in both packages, so on stub fleets the contract is
exact: the same fleet under the same config gives equal results dicts
(apart from the wall-clock keys) and byte-identical `Tracer.to_json()`
across policies, pool sizes, fused training, the dual-stream model with
preemption, a seeded `FaultPlan` and a struct-of-arrays `FleetState`
fleet. The unit scenarios below replay the JAX package's own serving tests
(`tests/test_serving.py`, `test_streams.py`, `test_faults.py`,
`test_fleet.py`, `test_obs.py`, `test_scheduler.py`) in both packages and
require the same answers.
"""
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core.scheduler as j_scheduler
import repro.core.timing as j_timing
import repro.serving as j_serving
import repro.serving.faults as j_faults
import repro.serving.network as j_network
import repro_torch.core.scheduler as t_scheduler
import repro_torch.core.timing as t_timing
import repro_torch.serving as t_serving
import repro_torch.serving.faults as t_faults
import repro_torch.serving.network as t_network

JAX = SimpleNamespace(S=j_serving, sched=j_scheduler, timing=j_timing,
                      faults=j_faults, net=j_network)
TORCH = SimpleNamespace(S=t_serving, sched=t_scheduler, timing=t_timing,
                        faults=t_faults, net=t_network)

WALL = ("wall_s", "events_per_sec", "events_per_sec_steady")
PRICED = dict(select_s=0.15, delta_comp_s_per_mb=5.0)


def _stable(r: dict) -> dict:
    return {k: v for k, v in r.items() if k not in WALL}


# ---------------------------------------------------------------------------
# stub fleets, bit for bit
# ---------------------------------------------------------------------------


def _fleet(P, n: int, kind: str):
    static = [i < n // 3 for i in range(n)]
    if kind == "fleet":
        s = np.array(static)
        return P.S.FleetState(n, rate=np.where(s, 0.15, 1.0),
                              dynamics=np.where(s, 0.0005, 0.004),
                              up_kbps=500.0, down_kbps=2000.0)
    link = P.S.LinkSpec(up_kbps=500.0, down_kbps=2000.0)
    return [P.S.StubSession(i, rate=0.15 if st else 1.0,
                            dynamics=0.0005 if st else 0.004,
                            net=P.S.ClientNetwork(link))
            for i, st in enumerate(static)]


def _engine_run(P, *, n=10, kind="objects", policy="fair", n_gpus=1,
                fuse=1, duration=120.0, streams=None, faults=False,
                cost=None, **cfg_kw):
    fkw = {}
    if faults:
        fkw["faults"] = P.S.FaultPlan.reference(duration, n_gpus=n_gpus)
    cfg = P.S.ServingConfig(
        duration=duration, n_gpus=n_gpus, fuse_train=fuse, max_queue=16,
        streams=P.S.StreamModel(**(streams or {})), **fkw, **cfg_kw)
    tracer = P.S.Tracer()
    eng = P.S.ServingEngine(_fleet(P, n, kind), policy=policy,
                            cost=P.sched.GPUCostModel(**(cost or {})),
                            cfg=cfg, tracer=tracer)
    return eng.run(), tracer.to_json()


CASES = [
    *[pytest.param(dict(policy=p, n_gpus=g, fuse=f), id=f"{p}-gpus{g}-fuse{f}")
      for p in ("fair", "edf", "gain", "affinity")
      for g in (1, 4) for f in (1, 4)],
    pytest.param(dict(policy="fair", n_gpus=2, fuse=4, cost=PRICED,
                      streams=dict(mode="overlap", preempt=True)),
                 id="overlap-preempt"),
    pytest.param(dict(policy="gain", n_gpus=1, fuse=4,
                      streams=dict(mode="overlap", preempt=True,
                                   slowdown=1.5, preempt_cost_s=0.05)),
                 id="overlap-preempt-slowdown"),
    pytest.param(dict(policy="fair", n=12, n_gpus=2, fuse=4, faults=True,
                      duration=240.0), id="fault-plan"),
    pytest.param(dict(policy="gain", kind="fleet", n_gpus=2, fuse=4),
                 id="fleet-state"),
    pytest.param(dict(policy="affinity", n=12, n_gpus=2, fuse=3,
                      cost=PRICED, asr_ctrl_bytes=64, residency_cap=3,
                      admission_util_cap=0.6), id="priced-capped-parked"),
]


@pytest.mark.parametrize("case", CASES)
def test_stub_fleet_results_and_trace_bit_for_bit(case):
    r_j, tr_j = _engine_run(JAX, **case)
    r_t, tr_t = _engine_run(TORCH, **case)
    assert r_t["phases_served"] > 0
    assert _stable(r_t) == _stable(r_j)
    assert tr_t == tr_j  # byte-identical Chrome trace
    # stubs train nothing: no stage timings, nothing in the drift audit
    assert r_t["observability"]["stage_timings"] == {}
    assert r_t["observability"]["drift"] == {}
    assert set(r_t["update_pipeline"]) == set(r_j["update_pipeline"])


# ---------------------------------------------------------------------------
# unit behaviour: the JAX package's serving tests, replayed in both packages
# ---------------------------------------------------------------------------


def _req(P, client, t_request=0.0, deadline=10.0, phi=1.0, t_update=10.0):
    return P.S.GPURequest(client=client, t_request=t_request, n_frames=4,
                          k_iters=20, deadline=deadline, phi=phi,
                          t_update=t_update)


def sc_events(P):
    q = P.S.EventQueue()
    for t, c in [(2.0, 0), (1.0, 1), (2.0, 2), (1.0, 3), (0.5, 4)]:
        q.push(t, "k", client=c)
    order = [(e.time, e.client) for e in (q.pop() for _ in range(5))]
    assert order == [(0.5, 4), (1.0, 1), (1.0, 3), (2.0, 0), (2.0, 2)]
    q2 = P.S.EventQueue()
    q2.push_many([(3.0, "a", 1, None), (1.0, "b", 2, None),
                  (1.0, "c", 3, None), (2.0, "d", 4, None)])
    q2.push(1.0, "cohort", np.arange(5, dtype=np.int64))
    batch = [(e.kind, e.seq, e.n) for e in q2.pop_batch()]
    rest = [(e.time, e.kind) for e in (q2.pop() for _ in range(2))]
    return order, batch, rest, q2.pushed, q2.popped


def sc_network(P):
    link = P.net.Link(rate_kbps=300.0, prop_delay_s=0.05)
    times = [link.tx_seconds(37_500), link.transfer(0.0, 37_500),
             link.transfer(0.0, 37_500), link.transfer(10.0, 37_500)]
    assert times[1:] == pytest.approx([1.05, 2.05, 11.05])
    net = P.S.ClientNetwork(P.S.LinkSpec(up_kbps=300.0, down_kbps=600.0,
                                         prop_delay_s=0.0))
    net.send_up(0.0, 37_500)
    net.send_down(0.0, 37_500)
    zero = P.net.Link(rate_kbps=0.0, prop_delay_s=0.01).transfer(5.0, 10**9)
    tr = P.S.RateTrace(kbps=(1000.0, 0.0, 250.0, 800.0), interval_s=1.0)
    phased = [(tr.for_client(c).phase_s, tr.for_client(c).finish_time(
        0.3, 1.2e6)) for c in range(6)]
    spec = P.S.LinkSpec.from_trace({"interval_s": 1.0, "up_kbps": [1000, 200],
                                    "down_kbps": [800, 80]}, client=7)
    return (times, net.kbps(10.0), zero, phased, spec.up_trace.phase_s,
            spec.up_kbps, P.S.ClientNetwork(spec).up.transfer(0.0, 20_000))


def sc_faults(P):
    plan = P.S.FaultPlan(seed=3, up_loss=0.3, down_loss=0.1)
    inj = P.S.FaultInjector(plan)
    lost = [inj.transfer_lost("up", c) for c in range(3) for _ in range(60)]
    assert 0.15 < sum(lost) / len(lost) < 0.45
    inj2 = P.S.FaultInjector(P.S.FaultPlan(
        seed=11, backoff_jitter=0.25,
        outages=(P.S.OutageWindow(start=10.0, end=20.0, direction="up"),
                 P.S.OutageWindow(start=15.0, end=25.0, direction="up"),
                 P.S.OutageWindow(start=40.0, end=45.0, direction="down",
                                  client=2)),
        slowdowns=(P.S.SlowdownWindow(gid=1, start=5.0, end=9.0,
                                      factor=2.0),)))
    queries = [inj2.outage_until("up", 0, 12.0),
               inj2.outage_until("up", 0, 25.0),
               inj2.outage_until("down", 2, 41.0),
               inj2.outage_until("down", 1, 41.0),
               inj2.slowdown_factor(1, 6.0), inj2.slowdown_factor(1, 9.0),
               inj2.link_outage_s(30.0, 3)]
    assert queries[0] == 25.0 and queries[1] is None
    backoff = [inj2.backoff_s(c, k) for c in range(3) for k in range(4)]
    u01 = [P.faults._u01(7, 1, c, n) for c in range(3) for n in range(16)]
    ref = P.S.FaultPlan.reference(240.0, n_gpus=2)
    with pytest.raises(ValueError):
        P.S.FaultPlan(up_loss=1.5)
    return lost, queries, backoff, u01, repr(ref)


def sc_streams(P):
    m = P.S.StreamModel(mode="overlap", slowdown=2.0)
    fin = [P.S.StreamModel().finish_time(2.0, 3.0, 10.0),
           m.finish_time(5.0, 3.0, 4.0), m.finish_time(0.0, 1.0, 100.0),
           m.finish_time(0.0, 3.0, 2.0),
           m.stream_demand_s(1.3, 1.0), P.S.StreamModel().stream_demand_s(
               1.3, 1.0)]
    assert fin[:4] == pytest.approx([5.0, 8.0, 2.0, 4.0])
    ser = P.S.GPUPool(1, streams=P.S.StreamModel(preempt=True))
    charges = [ser.charge(0, "label", 0.0, 2.0), ser.charge(0, "train", 0.0, 1.0),
               ser.charge(0, "label", 0.5, 1.0)]
    ovl = P.S.GPUPool(1, streams=m)
    charges += [ovl.charge(0, "label", 0.0, 4.0), ovl.charge(0, "train", 0.0, 1.0)]
    dev = ovl.device(0)
    busy = [dev.overlap_s(), dev.stream_busy_s("label", 100.0),
            dev.stream_busy_s("train", 100.0), dev.union_busy_s(100.0)]
    pre = P.S.GPUPool(1, streams=P.S.StreamModel(preempt=True,
                                                 preempt_cost_s=0.5))
    bounds = pre.label_bounds(0, 0.0, [1.0, 2.0, 4.0])
    cut = pre.truncate_label(0, 2.0, preempted_frames=7)
    wait = [ser.train_ready_wait_s(0, 1.0), ovl.train_ready_wait_s(0, 1.0)]
    for bad in (dict(mode="concurrent"), dict(slowdown=0.5),
                dict(max_seg_preempts=0)):
        with pytest.raises(ValueError):
            P.S.StreamModel(**bad)
    return (fin, charges, busy, bounds, cut, pre.preemptions,
            pre.preempt_s_total, wait)


def sc_pool(P):
    pool = P.S.GPUPool(2, migration=P.S.MigrationModel(gbps=1.0, setup_s=0.5))
    nb = 10 ** 9
    mig = [pool.migration_s(7, 0, nb)]
    pool.grant(0, client=7, t=0.0, dur_s=1.0, horizon_s=100.0)
    with pytest.raises(RuntimeError, match="double-booked"):
        pool.grant(0, client=1, t=0.5, dur_s=1.0, horizon_s=10.0)
    mig += [pool.migration_s(7, 0, nb), pool.migration_s(7, 1, nb)]
    pool.release(0)
    pool.grant(1, client=7, t=2.0, dur_s=1.0, horizon_s=100.0,
               mig_s=pool.migration_s(7, 1, nb))
    assert mig == pytest.approx([0.0, 0.0, 8.5])
    capped = P.S.GPUPool(1, residency_cap=1,
                         migration=P.S.MigrationModel(gbps=1.0, setup_s=0.1))
    for c, t in ((0, 0.0), (1, 2.0)):
        capped.grant(0, client=c, t=t, dur_s=1.0, horizon_s=50.0)
        capped.release(0)
    clip = P.S.GPUPool(1)
    clip.grant(0, client=0, t=9.0, dur_s=5.0, horizon_s=10.0)
    with pytest.raises(ValueError, match="device_backend"):
        P.S.GPUPool(1, device_backend="tpu")
    return (mig, pool.home_of(7), pool.migrations, pool.migration_s_total,
            capped.evictions, capped.is_resident(0, 0),
            capped.migration_s(0, 0, nb), clip.device(0).busy_s,
            pool.free_ids(), pool.utilization(100.0))


def sc_policies(P):
    edf = P.S.make_policy("edf").pick(
        0.0, [_req(P, 0, deadline=30.0), _req(P, 1, deadline=10.0),
              _req(P, 2, deadline=20.0)]).client
    gain = P.S.make_policy("gain")
    picks = [gain.pick(5.0, [_req(P, 0, 5.0, phi=1.0),
                             _req(P, 1, 5.0, phi=0.1)]).client,
             gain.pick(60.0, [_req(P, 0, 60.0, phi=1.0),
                              _req(P, 1, 0.0, phi=0.1)]).client]
    queued = [_req(P, 0, 10.0, phi=1.5), _req(P, 1, 10.0, phi=0.05),
              _req(P, 2, 11.0, phi=1.5)]
    evict = [gain.evict(11.0, queued).client,
             P.S.make_policy("fair").evict(11.0, queued).client]
    fair = P.S.make_policy("fair")
    ready = [_req(P, c) for c in range(3)]
    rotation = [fair.pick(0.0, ready).client for _ in range(6)]
    assert rotation == [0, 1, 2, 0, 1, 2] and edf == 1
    assigned = [(a.req.client, a.gpu) for a in P.S.make_policy("fair").assign(
        0.0, [_req(P, c) for c in range(5)], [2, 3], P.S.GPUPool(4))]
    rng = np.random.default_rng(5)
    reqs = [P.S.GPURequest(client=i, t_request=float(rng.uniform(0, 10)),
                           n_frames=1, k_iters=20,
                           deadline=float(rng.uniform(10, 30)),
                           phi=float(rng.uniform(0.1, 1.5)),
                           t_update=float(rng.choice([5.0, 10.0, 20.0])))
            for i in range(8)]
    ranks = {}
    for name in ("fair", "edf", "gain"):
        p = P.S.make_policy(name)
        order = p.rank(12.0, clients=np.arange(8, dtype=np.int64),
                       t_request=np.array([r.t_request for r in reqs]),
                       deadline=np.array([r.deadline for r in reqs]),
                       phi=np.array([r.phi for r in reqs]),
                       t_update=np.array([r.t_update for r in reqs]), limit=5)
        ranks[name] = [int(j) for j in order]
    aff_pool = P.S.GPUPool(2, migration=P.S.MigrationModel(gbps=1.0,
                                                           setup_s=0.5))
    aff_pool.grant(1, client=0, t=0.0, dur_s=1.0, horizon_s=100.0)
    aff_pool.release(1)
    aff = [(a.req.client, a.gpu) for a in P.S.make_policy("affinity").assign(
        2.0, [_req(P, 0), _req(P, 1)], [0, 1], aff_pool)]
    with pytest.raises(ValueError):
        P.S.make_policy("lifo")
    return edf, picks, evict, rotation, assigned, ranks, aff, sorted(P.S.POLICIES)


def sc_scheduler(P):
    cost = P.sched.GPUCostModel(teacher_infer_s=0.2, train_iter_s=0.05,
                                **PRICED)
    prices = [cost.phase_s, cost.phase_cost_s(4, 20), cost.label_batch_s(6),
              cost.train_batch_s(1, 20), cost.train_batch_s(8, 25),
              cost.delta_comp_s(2_000_000), cost.update_solo_s(30_000),
              cost.update_batch_s([30_000, 20_000, 10_000])]
    assert prices[3] == pytest.approx(20 * 0.05)
    assert P.sched.GPUCostModel().train_batch_s(8, 25) == pytest.approx(5.2375)
    rr = P.sched.RoundRobinScheduler(cost=P.sched.GPUCostModel(
        teacher_infer_s=0.0, train_iter_s=0.5), waiting_timeout=5.0)
    seq = [rr.try_acquire(0.0, 0, 2, client=0), rr.try_acquire(0.5, 0, 2, client=1),
           rr.try_acquire(2.0, 0, 2, client=0), rr.try_acquire(10.0, 0, 2, client=0)]
    assert seq == [True, False, False, True]
    ring = P.sched.RoundRobinScheduler(cost=P.sched.GPUCostModel(
        teacher_infer_s=0.0, train_iter_s=0.0))
    grants = [c for t in range(9) for c in range(3)
              if ring.try_acquire(float(t), 1, 1, client=c)]
    sat = P.sched.RoundRobinScheduler()
    for t in range(0, 60, 2):
        for c in range(6):
            sat.try_acquire(float(t), 2, 20, client=c)
    turn = [P.sched.next_in_turn([3, 1, 5], t, 6) for t in range(7)]
    return (prices, seq, rr.deferred, grants, sat.served, sat.deferred,
            sat.utilization(60.0), turn)


def sc_registry(P):
    m = P.S.MetricsRegistry()
    c = m.counter("a.b")
    c.inc()
    c.inc(2)
    m.gauge("a.g", 0).set_max(5)
    m.gauge("a.g").set_max(3)
    m.set("top", "x")
    h = m.histogram("lat")
    h.extend([1.0, 3.0])
    with pytest.raises(TypeError):
        m.gauge("a.b")
    assert m.as_results() == {"a": {"b": 3, "g": 5}, "top": "x"}
    return m.as_results(), h.summary()


def sc_timing_and_drift(P):
    snap = P.timing.snapshot()
    P.timing.record("train_fused", 0.5, first=True, key=(4, 20))
    P.timing.record("train_fused", 0.25, key=(4, 20))
    P.timing.record("train_fused", 0.125, key=(4, 20))
    P.timing.record("encode_stacked", 0.0625, key=(4,), nbytes=80_000)
    P.timing.set_enabled(False)
    try:
        P.timing.record("train_fused", 1.0, key=(2, 5))
    finally:
        P.timing.set_enabled(True)
    stats = P.timing.delta(snap)
    assert ("train_fused", (2, 5)) not in stats
    stats_in = {
        ("train_fused", (4, 20)): {"calls": 3, "first_calls": 1,
                                   "first_s": 2.0, "steady_s": 1.0,
                                   "nbytes": 0},
        ("select_stacked", (4,)): {"calls": 2, "first_calls": 0,
                                   "first_s": 0.0, "steady_s": 0.3,
                                   "nbytes": 0},
        ("select_solo", ()): {"calls": 1, "first_calls": 0,
                              "first_s": 0.0, "steady_s": 0.01, "nbytes": 0},
        ("encode_solo", ()): {"calls": 2, "first_calls": 0, "first_s": 0.0,
                              "steady_s": 0.1, "nbytes": 2_000_000},
        ("encode_stacked", (4,)): {"calls": 1, "first_calls": 1,
                                   "first_s": 0.2, "steady_s": 0.0,
                                   "nbytes": 90_000},
        ("unpriced_stage", ()): {"calls": 1, "first_calls": 0,
                                 "first_s": 0.0, "steady_s": 1.0,
                                 "nbytes": 0},
    }
    drift = P.S.drift_report(P.sched.GPUCostModel(**PRICED), stats_in)
    tf = drift["train_fused"]
    want = 3 * P.sched.GPUCostModel(**PRICED).train_batch_s(4, 20) * 2 / 3
    assert tf["modeled_steady_s"] == pytest.approx(want)
    assert "unpriced_stage" not in drift
    return (stats, P.timing.totals(stats), P.timing.compile_s(stats), drift,
            P.S.drift_report(P.sched.GPUCostModel(), stats_in))


def sc_trace_validation(P):
    r, trace = _engine_run(P, n=6, n_gpus=2, fuse=4, duration=60.0,
                           streams=dict(mode="overlap", preempt=True),
                           cost=PRICED)
    import json

    doc = json.loads(trace)
    assert P.S.validate_trace(doc) == []
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    names = sorted({(e["cat"], e["name"]) for e in spans})
    assert ("stream:train", "train") in names
    next(e for e in spans if e["cat"] == "stream:train")["dur"] = -5
    negative = P.S.validate_trace(doc)
    assert any("negative" in x for x in negative)
    gutted = dict(json.loads(trace), traceEvents=[
        e for e in json.loads(trace)["traceEvents"]
        if e.get("name") != "queue_depth"])
    missing = P.S.validate_trace(gutted)
    assert any("queue_depth" in x for x in missing)
    return r["phases_served"], names, negative, missing


def sc_fleet(P):
    f = _fleet(P, 9, "fleet")
    views = f.views()
    eng = P.S.ServingEngine(_fleet(P, 9, "fleet"), policy="fair",
                            cfg=P.S.ServingConfig(duration=60.0))
    r = _stable(eng.run())
    r_obj = _stable(P.S.ServingEngine(
        _fleet(P, 9, "objects"), policy="fair",
        cfg=P.S.ServingConfig(duration=60.0)).run())
    assert r == r_obj  # the fleet reproduces the per-object engine
    return (len(views), [views[i].sampling_rate for i in range(9)],
            f.sampling_rate.tolist(), f.dynamics.tolist(), r)


UNIT = [sc_events, sc_network, sc_faults, sc_streams, sc_pool, sc_policies,
        sc_scheduler, sc_registry, sc_timing_and_drift, sc_trace_validation,
        sc_fleet]


@pytest.mark.parametrize("scenario", UNIT, ids=[f.__name__[3:] for f in UNIT])
def test_unit_behaviour_matches_the_jax_package(scenario):
    assert scenario(TORCH) == scenario(JAX)


def test_port_pool_refuses_the_jax_backend_name():
    with pytest.raises(ValueError, match="'torch'"):
        t_serving.GPUPool(2, device_backend="jax")
    modeled = t_serving.GPUPool(3)
    assert modeled.torch_devices() == [None] * 3
    assert modeled.distinct_torch_devices == 0


def test_timing_block_waits_for_nothing_on_the_cpu():
    import torch

    t_timing.block({"a": torch.ones(3), "b": (torch.zeros(2), 1.5)})
    t_timing.block([])


def test_debug_snapshot_keeps_the_port_counters():
    """The JAX package's keys minus the three with no counterpart in the
    port (kernel dispatch races, selection/encode executable caches); the
    sharded counters have the JAX package's keys."""
    snap = t_serving.debug_snapshot()
    j_snap = j_serving.debug_snapshot()
    assert set(snap) == set(j_snap) - {"kernel_dispatch", "stacked_select_cache",
                                       "stacked_encode_cache"}
    assert set(snap["update_pipeline"]) == set(j_snap["update_pipeline"])
    assert set(snap["fused_train_cache"]) == set(j_snap["fused_train_cache"])
    assert set(snap["sharded"]) == set(j_snap["sharded"])
