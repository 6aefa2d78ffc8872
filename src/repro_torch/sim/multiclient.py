"""Multiple edge devices sharing a server GPU pool (Appendix E, Fig. 6/10).

`run_multiclient` builds sessions for the event-driven runtime in
`repro_torch.serving` — so phases queue behind a modeled GPU pool, frame
batches and deltas occupy rate-limited links (deltas arrive *stale*, never
teleported), and the GPU policy is pluggable (``policy="fair" | "edf" |
"gain" | "affinity"``). ``n_gpus`` sizes the pool and ``affinity=True``
selects residency-aware (session, gpu) placement; the defaults
(``n_gpus=1``, blind) give the single-GPU engine.

The sessions run on the device of the ``pretrained`` params' leaves, as
`sim.runner.run_scheme` does: each server session and each edge starts
from its own clone of them.
"""
from __future__ import annotations

import dataclasses

from repro_torch import tree
from repro_torch.core.scheduler import GPUCostModel
from repro_torch.core.server import AMSConfig, AMSSession, Task
from repro_torch.data.video import VideoConfig, stop_and_go
from repro_torch.serving import (
    ClientNetwork,
    LinkSpec,
    SegServingSession,
    ServingConfig,
    ServingEngine,
    StreamModel,
)
from repro_torch.sim.seg_world import SegWorld, phi_pixel_loss


def build_sessions(
    n_clients: int,
    pretrained,
    seg_cfg,
    ams_cfg: AMSConfig,
    *,
    duration: float = 120.0,
    video_kw: dict | None = None,
    eval_stride: int = 6,
    stationary_frac: float = 0.3,
    seed: int = 0,
    link: LinkSpec | None = None,
) -> list[SegServingSession]:
    """N seg worlds -> serving sessions; the first ``stationary_frac`` of
    clients watch near-static feeds (the ATR/gain-aware reclamation target)."""
    video_kw = dict(video_kw or {})
    video_kw.setdefault("duration", duration)
    video_kw.setdefault("fps", 4.0)
    link = link or LinkSpec()

    sessions = []
    for i in range(n_clients):
        kw = dict(video_kw, seed=seed * 1000 + i)
        if i < int(stationary_frac * n_clients):
            kw["motion_schedule"] = stop_and_go(0.0, duration)  # near-static feed
        world = SegWorld.make(VideoConfig(**kw), seg_cfg)
        task = Task(loss_and_grad=world.loss_and_grad, teacher=None,
                    phi_loss=phi_pixel_loss)
        ams = AMSSession(task, ams_cfg,
                         tree.tree_map(lambda x: x.detach().clone(),
                                       pretrained), seed=i)
        sessions.append(SegServingSession(
            i, world, ams, pretrained, net=ClientNetwork(link),
            eval_stride=eval_stride))
    return sessions


def run_multiclient(
    n_clients: int,
    pretrained,
    seg_cfg,
    ams_cfg: AMSConfig,
    *,
    duration: float = 120.0,
    video_kw: dict | None = None,
    cost: GPUCostModel | None = None,
    eval_stride: int = 6,
    stationary_frac: float = 0.3,
    seed: int = 0,
    policy: str = "fair",
    n_gpus: int | None = None,
    affinity: bool = False,
    fuse_train: int | None = None,
    streams: StreamModel | None = None,
    link: LinkSpec | None = None,
    serving_cfg: ServingConfig | None = None,
    tracer=None,
    faults=None,
) -> dict:
    """Returns mean mIoU across clients + scheduler/network telemetry.

    Seed-era keys (``n_clients``, ``miou_per_client``, ``mean_miou``,
    ``gpu_utilization``, ``phases_served``, ``phases_deferred``) are
    preserved; the engine adds per-client Kbps, delta latency, deferral-rate,
    per-GPU utilization/migration and events/sec fields on top.

    ``n_gpus`` sizes the server's GPU pool (sessions then compete for
    (session, gpu) assignments instead of one busy flag), ``affinity=True``
    swaps in the residency-aware `AffinityAware` policy, and
    ``fuse_train=B`` lets a granted device co-train up to B sessions whose
    staging is free or beaten by the fused-stack discount as one stacked
    vmap lifecycle (`core.batched`) priced by the sublinear
    `GPUCostModel.train_batch_s`, and ``streams`` selects the per-device
    dual-stream model (`serving.StreamModel`: overlap teacher labeling with
    training, optionally preempting labeling launches at frame-batch
    boundaries) — the defaults (one GPU, unfused, serialized streams, no
    preemption) give the single-clock engine.

    ``tracer`` attaches a `repro_torch.serving.Tracer` flight recorder: every
    grant/labeling/train/transfer lands as a span in simulated time; dump
    with ``tracer.dump("out.json")`` and open in Perfetto. ``tracer=None``
    (the default) records nothing and changes nothing.

    ``faults`` attaches a seeded `repro_torch.serving.FaultPlan` chaos schedule
    (link loss/outages, rate-trace replay, device crashes/slowdowns);
    ``faults=None`` (the default) injects nothing.

    The ``duration`` kwarg governs the run: it sizes the videos AND the
    engine horizon. A ``serving_cfg`` supplies the other engine knobs
    (queue cap, admission, batching, migration model, its own ``n_gpus``);
    its ``duration`` is overridden so clients can never be scored past the
    end of their streams, and an explicit ``n_gpus`` kwarg (even 1) wins
    over the config's."""
    sessions = build_sessions(
        n_clients, pretrained, seg_cfg, ams_cfg, duration=duration,
        video_kw=video_kw, eval_stride=eval_stride,
        stationary_frac=stationary_frac, seed=seed, link=link)
    if affinity:
        if not (isinstance(policy, str) and policy in ("fair", "gain",
                                                       "affinity")):
            raise ValueError(
                f"affinity=True swaps in the gain-based AffinityAware "
                f"policy; it cannot be combined with policy={policy!r}")
        policy = "affinity"
    if serving_cfg is None:
        fkw = {} if faults is None else {"faults": faults}
        cfg = ServingConfig(duration=duration, n_gpus=n_gpus or 1,
                            fuse_train=fuse_train or 1,
                            streams=streams or StreamModel(), **fkw)
    else:
        cfg = dataclasses.replace(
            serving_cfg, duration=duration,
            n_gpus=serving_cfg.n_gpus if n_gpus is None else n_gpus,
            fuse_train=(serving_cfg.fuse_train if fuse_train is None
                        else fuse_train),
            streams=(serving_cfg.streams if streams is None else streams),
            faults=(serving_cfg.faults if faults is None else faults))
    engine = ServingEngine(sessions, policy=policy, cost=cost, cfg=cfg,
                           tracer=tracer)
    return engine.run()
