"""Session adapters: what the serving engine needs from one client.

The engine is deliberately ignorant of torch, video, and segmentation — it
schedules opaque sessions through a small duck-typed surface:

  edge side   : ``sampling_rate``, ``eval_interval_s``, ``capture(t)``,
                ``take_outbox()``, ``upload_bytes(n)``, ``evaluate(t)``,
                ``apply_delta(delta, t_sent, t_now)``
  server side : ``t_update``, ``k_iters``, ``label_and_ingest(idxs, t)``,
                ``train(t) -> delta | None`` (delta needs ``.total_bytes``)

`SessionBase` holds the shared edge-side plumbing (outbox, network,
telemetry). `SegServingSession` binds the real pipeline (SegWorld +
AMSSession + double-buffered EdgeClient) on the device of the params it
is given. `StubSession` is a compute-free stand-in with identical
timing/byte behaviour, used to measure engine throughput at client counts
where real training would drown the measurement.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch import tree
from repro_torch.core.client import EdgeClient
from repro_torch.core.server import AMSSession
from repro_torch.data import codec
from repro_torch.device import host_to_device
from repro_torch.metrics.miou import miou
from repro_torch.serving.network import ClientNetwork, LinkSpec


class SessionBase:
    """Edge-side plumbing shared by every session flavor: the device outbox,
    the per-client network, and the telemetry the engine reads. Subclasses
    add the actual compute (or a model of it)."""

    def __init__(self, idx: int, net: ClientNetwork | None = None):
        self.idx = idx
        self.net = net or ClientNetwork(LinkSpec())
        self.net.client = idx  # flight-recorder identity for transfer spans
        self._outbox: list[int] = []  # sampled frame indices awaiting upload
        self.admitted = True
        self.state_bytes = 0  # server-side training state (migration cost)
        self.delta_bytes_hint = 0  # expected wire-delta size (update pricing)
        self.ams_session = None  # real AMS core, if any (fused-training hook)
        self._edge_rate: float | None = None  # last *delivered* ASR rate
        # telemetry
        self.mious: list[float] = []
        self.delta_latencies: list[float] = []
        self.phases = 0
        self.phase_devices: list[int] = []  # which GPU served each phase
        self.phase_streams: list[str] = []  # which device stream ran it

    def take_outbox(self) -> list[int]:
        out, self._outbox = self._outbox, []
        return out

    @property
    def edge_sampling_rate(self) -> float:
        """The rate the device actually samples at. With the rate-control
        message modeled (``ServingConfig.asr_ctrl_bytes > 0``) this is the
        last rate *delivered* over the downlink; otherwise the server-side
        rate applies instantly (the simplification without the control message)."""
        return self.sampling_rate if self._edge_rate is None else self._edge_rate

    def apply_rate_ctrl(self, rate: float) -> None:
        self._edge_rate = rate

    def note_device(self, gid: int, stream: str = "train") -> None:
        """Record where a phase physically ran: device id and, under the
        dual-stream device model, which execution stream carried it
        (training phases live on ``train``; the ``label`` stream only ever
        carries teacher launches, which are not per-phase events)."""
        self.phase_devices.append(gid)
        self.phase_streams.append(stream)

    # ---- telemetry folds (what the engine's results read) ---------------
    # Sessions that fold samples into running moments instead of lists
    # (StubSession(telemetry="moments"), fleet views) override these; the
    # defaults read the lists, bit-identical to the historical inline code.
    def miou_mean(self) -> float:
        return float(np.mean(self.mious)) if self.mious else float("nan")

    def latency_values(self):
        """Per-delta latency samples, or None when only moments are kept."""
        return self.delta_latencies

    def latency_summary(self) -> tuple[int, float, float]:
        vals = self.delta_latencies
        return (len(vals), float(sum(vals)),
                float(max(vals)) if vals else 0.0)


class SegServingSession(SessionBase):
    """One edge device streaming a `SegWorld` video through a real
    `AMSSession`, with client-side weights held in an `EdgeClient` (so deltas
    land in the inactive replica and swap — never blocking inference).

    The edge starts from a clone of ``params0``: torch tensors are mutable,
    and the edge must move only through ``apply_delta``, never through a
    write to storage the server side shares."""

    def __init__(self, idx: int, world, session: AMSSession, params0,
                 net: ClientNetwork | None = None, eval_stride: int = 6):
        super().__init__(idx, net)
        self.world = world
        self.session = session
        self.ams_session = session  # fused-training hook (core.batched)
        self.edge = EdgeClient(world.predict,
                               tree.tree_map(lambda x: x.detach().clone(),
                                             params0))
        self.fps = world.video.cfg.fps
        self.eval_interval_s = eval_stride / self.fps
        self._n_pixels = world.video.cfg.height * world.video.cfg.width
        # what a GPU must stage to host this session: params + Adam moments
        # (x3) plus the horizon replay buffer of decoded frames (float32 RGB
        # at the ~1 fps nominal sampling rate)
        param_bytes = sum(x.numel() * x.element_size()
                          for x in tree.leaves(params0))
        buffer_bytes = int(session.cfg.t_horizon) * self._n_pixels * 3 * 4
        self.state_bytes = 3 * param_bytes + buffer_bytes
        # expected delta wire size, for amortized update-pipeline pricing at
        # admission: γN fp16 values + the (uncompressed-bound) mask bits
        n_params = sum(x.numel() for x in tree.leaves(params0))
        self.delta_bytes_hint = int(session.cfg.gamma * n_params * 2
                                    + n_params / 8)

    # ---- edge side -----------------------------------------------------
    @property
    def sampling_rate(self) -> float:
        return self.session.sampling_rate

    @property
    def phi_signal(self) -> float:
        """Recent φ relative to the ASR target: ~0 for a frozen feed, ~1 at
        the controller's set point, >1 while the scene outruns it."""
        ema = self.session.asr.phi_ema
        if ema < 0:  # nothing observed yet: assume dynamic (serve eagerly)
            return 1.0
        return ema / max(self.session.asr.phi_target, 1e-9)

    def capture(self, t: float) -> None:
        idx = min(int(t * self.fps), self.world.video.cfg.n_frames - 1)
        self._outbox.append(idx)

    def upload_bytes(self, n_frames: int) -> int:
        """H.264 two-pass over the T_update buffer (paper §3.2) + a small
        control message so even an empty upload asks for a phase."""
        return 256 + codec.h264_buffer_bytes(n_frames, self._n_pixels,
                                             self.t_update)

    def evaluate(self, t: float) -> None:
        idx = min(int(t * self.fps), self.world.video.cfg.n_frames - 1)
        img, _ = self.world.video.frame(idx)
        tlabel = self.world.teacher.label(idx)
        dev = tree.leaves(self.edge.active)[0].device
        frame = host_to_device(img[None], dev)
        pred = self.edge.infer(frame)[0].cpu().numpy()  # one pull per eval
        self.mious.append(miou(pred, tlabel, self.world.video.cfg.n_classes))

    def apply_delta(self, delta, t_sent: float, t_now: float) -> None:
        self.edge.apply_update(delta)
        self.delta_latencies.append(t_now - t_sent)

    # ---- server side ---------------------------------------------------
    @property
    def t_update(self) -> float:
        return self.session.t_update

    @property
    def k_iters(self) -> int:
        return self.session.cfg.k_iters

    def label_and_ingest(self, idxs: list[int], t: float) -> None:
        if not idxs:
            return
        frames = np.stack([self.world.video.frame(i)[0] for i in idxs])
        labels = np.stack([self.world.teacher.label(i) for i in idxs])
        self.session.receive_labeled(frames, labels, t)

    def train(self, t: float):
        delta = self.session.train_phase(t)
        if delta is not None:
            self.phases += 1
        return delta


@dataclass
class StubDelta:
    total_bytes: int


class StubSession(SessionBase):
    """Compute-free session with the same surface and modeled byte sizes.

    Accuracy is a deterministic freshness curve: mIoU decays linearly with
    the age of the client's weights at a per-session ``dynamics`` rate, so
    scheduler quality still shows up in the aggregate numbers while a single
    event costs microseconds — this is what lets `serving_scale` push client
    counts into the dozens and report engine events/sec rather than
    training time.
    """

    def __init__(self, idx: int, *, fps: float = 4.0, t_update: float = 10.0,
                 k_iters: int = 20, rate: float = 1.0, dynamics: float = 0.01,
                 frame_bytes: int = 7000, delta_bytes: int = 20_000,
                 state_bytes: int = 32_000_000, eval_stride: int = 6,
                 net: ClientNetwork | None = None,
                 telemetry: str = "full"):
        super().__init__(idx, net)
        if telemetry not in ("full", "moments"):
            raise ValueError("telemetry must be 'full' or 'moments', "
                             f"got {telemetry!r}")
        # "full" keeps every mIoU/latency sample (bit-identical, the
        # default); "moments" folds them into running (count, sum, max)
        # so a huge fleet stops accumulating unbounded Python lists
        self.telemetry = telemetry
        self._m_n = 0
        self._m_sum = 0.0
        self._lat_n = 0
        self._lat_sum = 0.0
        self._lat_max = 0.0
        self.state_bytes = state_bytes  # modeled weights+opt+buffer residency
        self.fps = fps
        self.sampling_rate = rate
        self.phi_signal = rate  # stubs: the configured rate IS the dynamics
        self.eval_interval_s = eval_stride / fps
        self.t_update = t_update
        self.k_iters = k_iters
        self.dynamics = dynamics  # mIoU lost per second of weight staleness
        self._frame_bytes = frame_bytes
        self._delta_bytes = delta_bytes
        self.delta_bytes_hint = delta_bytes  # stubs: the modeled size is exact
        self._ingested = 0
        self._last_update_t = 0.0

    def capture(self, t: float) -> None:
        self._outbox.append(int(t * self.fps))

    def upload_bytes(self, n_frames: int) -> int:
        return 256 + n_frames * self._frame_bytes

    def evaluate(self, t: float) -> None:
        staleness = t - self._last_update_t
        v = max(0.2, 0.9 - self.dynamics * staleness)
        if self.telemetry == "full":
            self.mious.append(v)
        else:
            self._m_n += 1
            self._m_sum += v

    def apply_delta(self, delta, t_sent: float, t_now: float) -> None:
        self._last_update_t = t_now
        lat = t_now - t_sent
        if self.telemetry == "full":
            self.delta_latencies.append(lat)
        else:
            self._lat_n += 1
            self._lat_sum += lat
            if lat > self._lat_max:
                self._lat_max = lat

    def miou_mean(self) -> float:
        if self.telemetry == "full":
            return super().miou_mean()
        return self._m_sum / self._m_n if self._m_n else float("nan")

    def latency_values(self):
        if self.telemetry == "full":
            return self.delta_latencies
        return None

    def latency_summary(self) -> tuple[int, float, float]:
        if self.telemetry == "full":
            return super().latency_summary()
        return (self._lat_n, self._lat_sum, self._lat_max)

    def label_and_ingest(self, idxs: list[int], t: float) -> None:
        self._ingested += len(idxs)

    def train(self, t: float):
        if self._ingested == 0:
            return None
        self.phases += 1
        return StubDelta(total_bytes=self._delta_bytes)


def train_many(sessions: list, t: float, device=None) -> list:
    """Train several co-granted sessions, fusing where the math allows.

    Sessions exposing a real AMS core (``ams_session``) run through
    `core.batched.train_phases_fused` as one stacked vmap lifecycle (same
    grouping rules: shared loss callable, shapes, K, optimizer). Everything
    else — stubs, single stragglers — falls back to its own ``train``. The
    returned list is delta-or-None per session, in input order.

    ``device`` is the granted pool slot's ``torch.device`` binding
    (`GPUPool(device_backend="torch")`): a stacked group's lifecycle then
    runs on that card, and each session's state returns to its own
    device. None places nothing."""
    out: list = [None] * len(sessions)
    fusable = [i for i, s in enumerate(sessions)
               if getattr(s, "ams_session", None) is not None]
    rest = list(range(len(sessions)))
    if len(fusable) >= 2:
        from repro_torch.core.batched import train_phases_fused

        deltas = train_phases_fused([sessions[i].ams_session for i in fusable],
                                    t, device=device)
        for i, d in zip(fusable, deltas):
            if d is not None:
                sessions[i].phases += 1
            out[i] = d
        fused = set(fusable)  # hoisted: rebuilding per element made this O(B²)
        rest = [i for i in rest if i not in fused]
    for i in rest:
        out[i] = sessions[i].train(t)
    return out
