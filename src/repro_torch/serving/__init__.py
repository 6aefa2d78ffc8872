"""Event-driven AMS serving runtime — many edge devices, a GPU pool, a real(ish) network.

Paper-concept -> class map (Appendix D/E):

  ==========================================  =================================
  Paper concept                               Here
  ==========================================  =================================
  Shared-GPU round-robin (App. E)             `policies.FairRoundRobin`
  Deferred phases under saturation (Fig. 6)   `engine.ServingEngine` backlog +
                                              admission control / drop stats
  ATR cycle reclamation (App. D)              `policies.GainAware` (recent
                                              φ-score + staleness priority,
                                              φ-aware eviction when saturated)
  App. E scaling argument, many GPUs          `resources.GPUPool` (per-device
                                              stream clocks + session
                                              residency) + `policies.
                                              AffinityAware` (session, gpu)
                                              placement
  Server labels + trains concurrently (§4)    `resources.StreamModel`: label
                                              vs train streams per device,
                                              overlap with bounded slowdown,
                                              labeling preemptible at frame-
                                              batch boundaries
  Uplink frame batches / downlink deltas      `network.ClientNetwork` (links
  (§3.1.2, §3.2, Tables 1-2)                  occupy `bytes/rate` s, feed the
                                              per-client `BandwidthLedger`)
  Edge double-buffered swap (§3)              via `session.SegServingSession`
                                              wrapping `core.client.EdgeClient`
  ==========================================  =================================

Quickstart::

    from repro_torch.serving import (LinkSpec, ClientNetwork, SegServingSession,
                               ServingEngine, ServingConfig)

    sessions = [
        SegServingSession(i, world_i, ams_session_i, pretrained,
                          net=ClientNetwork(LinkSpec(up_kbps=500,
                                                     down_kbps=2000)))
        for i, (world_i, ams_session_i) in enumerate(zip(worlds, ams))
    ]
    result = ServingEngine(sessions, policy="affinity",
                           cfg=ServingConfig(duration=120.0, n_gpus=4)).run()
    print(result["mean_miou"], result["per_gpu_utilization"],
          result["migrations"])

`sim.multiclient.run_multiclient` is a thin shim over this engine (with
``n_gpus``/``affinity`` kwargs; the defaults give the single-GPU
engine). `StubSession` fleets drive it without training, to measure the
engine itself at large client counts.

Flight recorder (`serving.obs`): pass ``tracer=obs.Tracer()`` to the engine
(or ``run_multiclient``, or ``examples/multi_client_torch.py --trace
out.json``)
and every grant, migration, labeling launch, preemption cut, fused
train→select→encode stage and per-client uplink/downlink transfer lands as
a span in **simulated** time. ``tracer.dump("out.json")`` writes
deterministic Chrome trace-event JSON — open it at https://ui.perfetto.dev
("Open trace file"; processes are the server, each ``gpu<g>`` with
``stream:label``/``stream:train``/``grants`` threads, and each
``client<i>``; counter tracks carry queue depth, labeling backlog and
per-stream utilization). The engine's results dict is assembled from
`obs.MetricsRegistry`, an ``observability`` section reports the
modeled-vs-measured cost audit (`obs.drift_report` over `core.timing`
stage stats), and `obs.debug_snapshot` unifies the fused path's runner
cache, exec-shape decisions and counters with the stage timing totals.
Tracing defaults off and the recorder never changes the schedule: two
runs, traced or not, pop identical events.

Fault model (`serving.faults`): chaos is a *plan*, not a dice roll.
``ServingConfig(faults=FaultPlan(...))`` injects a seeded, fully
deterministic fault schedule — per-transfer link loss (splitmix64-hashed
draws, one counter per direction per client), link outage windows
(`OutageWindow`, up/down/both, fleet-wide or per-client), cyclic
`network.RateTrace` bandwidth replay (`LinkSpec.from_trace` loads the
``benchmarks/traces/*.json`` fixtures), device crash windows
(`CrashWindow`) and thermal slowdowns (`SlowdownWindow`). Frame uploads
retry with exponential backoff plus deterministic jitter and are abandoned
(frames dropped, bytes accounted) after ``max_retries``; delta downloads
use *supersede* semantics — a lost delta is retransmitted only while it is
still the newest one, otherwise the retransmit slot notes a ``supersede``
and the client waits for the fresh delta already in flight, inferring on
its stale model meanwhile (``chaos.final_staleness_max_s`` gauges the
damage). A device crash kills the in-flight grant; the ``gpu_done``
watchdog (armed per grant generation) recovers it — releases the device,
spills residency so survivors restage from scratch, and requeues every
member session — while admission control sheds new requests only when the
whole pool is dead. ``FaultPlan.none()`` (the default) is bit-identical to
the fault-free engine: no extra events, no RNG draws, byte-identical
traces.

Fleet control plane (`serving.fleet`): at 10^4-10^5 clients the per-object
path drowns in Python — one heap entry, one dict lookup, one bound-method
call per client per tick. ``FleetState(n, ...)`` stores the whole stub
fleet as struct-of-arrays numpy columns and the engine, handed one, switches
to *cohort events*: clients sharing a timestamp ride a single heap entry
(`Event.client` becomes an index array, ``Event.n`` its multiplicity) and
each event kind is handled by one vectorized batch handler. Policies grow an
array-native ``rank(t, clients=..., ...) -> argsort`` beside the per-object
``pick``, and admission prices unique parameter rows once and parks by a
single argsort+cumsum. The contract is **bit-identical results**: same
events_processed, same mIoU/latency floats, byte-identical flight-recorder
traces under ``FaultPlan.none()`` — anything the vector path cannot
reproduce exactly (tracing, chaos, per-link traces) silently drops to the
scalar lane per cohort. ``telemetry="moments"`` (also on `StubSession`)
folds per-sample lists into running (count, sum, max) so memory stays O(n)
at 10^5 clients; means then agree to ~1 ulp rather than bit-for-bit.

Device binding (`resources.GPUPool`): ``GPUPool(device_backend="torch")``
binds every modeled `GPUDevice` to ``torch.device("cuda", gid %
device_count)`` (`GPUDevice.torch_device`), and a fused grant's lifecycle
runs on the granted slot's card (`session.train_many` ->
`core.batched.train_phases_fused(device=...)`). Without CUDA it raises:
there is no CPU binding. ``"modeled"``, the default, binds nothing, imports
nothing and leaves every tensor where its session put it.

Sharded execution (`launch.host_mesh` + `core.batched`): the pool's
modeled per-device parallelism runs on real cards.
``core.batched.train_phases_sharded(groups, t, devices=pool.torch_devices())``
runs D co-resident groups, one per pool slot, each on its slot's card:
every group staged first (stacked, placed, its selection run there), then
every group launched with nothing in between that waits for a card, each
completion timestamped by its own waiter thread. It is byte-identical to
the serial fused path (``devices=[None] * D``, or per-group
``train_phases_fused``). `launch.host_mesh.host_devices(n)` raises when
the host has fewer than ``n`` cards, so a serial run cannot pass for a
parallel one; a pool wider than the host maps several slots to one card
(``GPUPool.distinct_torch_devices`` says how many are real). Per-device
measured-vs-modeled seconds surface in
``obs.drift_report()["sharded_device"]["per_device"]``. The gate is
``chip_smoke.py``'s sharded phase on the card (``sharded_phase``: three
fleets equal bit for bit, the counters and K1/K2 launches exact, the
drift report per slot); ``tests/test_torch_sharded.py`` holds the path
against the JAX package's on the CPU.
"""
from repro_torch.serving.engine import ServingConfig, ServingEngine
from repro_torch.serving.events import Event, EventQueue
from repro_torch.serving.faults import (
    CrashWindow,
    FaultInjector,
    FaultPlan,
    OutageWindow,
    SlowdownWindow,
)
from repro_torch.serving.fleet import FleetSessionView, FleetState
from repro_torch.serving.network import ClientNetwork, Link, LinkSpec, RateTrace
from repro_torch.serving.obs import (
    MetricsRegistry,
    Tracer,
    debug_snapshot,
    drift_report,
    validate_trace,
)
from repro_torch.serving.policies import (
    POLICIES,
    AffinityAware,
    Assignment,
    EarliestDeadlineFirst,
    FairRoundRobin,
    GainAware,
    GPURequest,
    SchedulingPolicy,
    make_policy,
)
from repro_torch.serving.resources import (
    GPUDevice,
    GPUPool,
    MigrationModel,
    StreamModel,
)
from repro_torch.serving.session import (
    SegServingSession,
    SessionBase,
    StubSession,
    train_many,
)

__all__ = [
    "Event", "EventQueue", "ClientNetwork", "Link", "LinkSpec",
    "SchedulingPolicy", "FairRoundRobin", "EarliestDeadlineFirst",
    "GainAware", "AffinityAware", "Assignment", "GPURequest", "POLICIES",
    "make_policy", "GPUDevice", "GPUPool", "MigrationModel", "StreamModel",
    "SegServingSession", "SessionBase", "StubSession", "train_many",
    "ServingConfig", "ServingEngine",
    "Tracer", "MetricsRegistry", "debug_snapshot", "drift_report",
    "validate_trace",
    "FaultPlan", "FaultInjector", "OutageWindow", "CrashWindow",
    "SlowdownWindow", "RateTrace",
    "FleetState", "FleetSessionView",
]
