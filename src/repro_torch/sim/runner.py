"""End-to-end streaming simulation of all five schemes (§4.1).

Timeline granularity = one video frame. Every scheme shares the same eval
loop (client inference vs teacher labels, per-frame mIoU — exactly the
paper's metric) and the same bandwidth ledger; they differ in what moves
over the network and when the student trains.

Everything runs on the device of the ``pretrained`` params' leaves; frames
and labels go there as they are used. Just-In-Time's first mask is drawn
from ``torch.Generator().manual_seed(seed + idx)``; every random mask goes
through the module attribute ``selection.random_mask``.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import selection
from repro_torch.core.bandwidth import BandwidthLedger
from repro_torch.core.delta import apply_delta, encode_delta, full_model_bytes
from repro_torch.core.masked_adam import (
    adam_update,
    init_momentum,
    init_state,
    momentum_update,
)
from repro_torch.core.server import AMSConfig, AMSSession, Task
from repro_torch.data import codec
from repro_torch.device import host_to_device
from repro_torch.metrics.miou import miou
from repro_torch.sim.seg_world import SegWorld, phi_pixel_loss


@dataclass(frozen=True)
class SimConfig:
    eval_stride: int = 3  # evaluate every k-th frame
    one_time_window: float = 60.0
    one_time_iters: int = 200
    remote_rate: float = 1.0  # fps, Remote+Tracking label rate
    # Just-In-Time baseline, following the paper's methodology (§4.1): it
    # samples continuously (every frame) and its accuracy threshold is tuned
    # so JIT matches AMS accuracy — bandwidth is then compared at equal mIoU.
    jit_threshold: float = 0.60
    jit_max_iters: int = 4
    jit_sample_rate: float = 4.0


@dataclass
class Result:
    scheme: str
    miou_per_frame: list = field(default_factory=list)
    eval_times: list = field(default_factory=list)
    ledger: BandwidthLedger = field(default_factory=BandwidthLedger)
    updates: int = 0
    extras: dict = field(default_factory=dict)

    @property
    def mean_miou(self) -> float:
        return float(np.mean(self.miou_per_frame)) if self.miou_per_frame else 0.0

    def bandwidth_kbps(self, duration: float) -> tuple[float, float]:
        return self.ledger.kbps(duration)


def _label_bytes(label: np.ndarray) -> int:
    return len(gzip.compress(label.astype(np.uint8).tobytes(), 6))


def _global_shift(prev: np.ndarray, cur: np.ndarray) -> tuple[int, int]:
    """Phase-correlation global motion estimate (optical-flow proxy for
    Remote+Tracking)."""
    a = prev.mean(axis=-1)
    b = cur.mean(axis=-1)
    fa, fb = np.fft.rfft2(a), np.fft.rfft2(b)
    cross = fa * np.conj(fb)
    cross /= np.maximum(np.abs(cross), 1e-9)
    corr = np.fft.irfft2(cross, s=a.shape)
    dy, dx = np.unravel_index(np.argmax(corr), corr.shape)
    h, w = a.shape
    if dy > h // 2:
        dy -= h
    if dx > w // 2:
        dx -= w
    return int(dy), int(dx)


def run_scheme(
    scheme: str,
    world: SegWorld,
    pretrained,
    ams_cfg: AMSConfig | None = None,
    sim: SimConfig | None = None,
    seed: int = 0,
) -> Result:
    ams_cfg = ams_cfg or AMSConfig()
    sim = sim or SimConfig()
    video, teacher = world.video, world.teacher
    fps = video.cfg.fps
    n_frames = video.cfg.n_frames
    n_pixels = video.cfg.height * video.cfg.width
    dev = tree.leaves(pretrained)[0].device
    res = Result(scheme=scheme)
    client_params = pretrained  # every update below builds new tensors
    rng = np.random.default_rng(seed)

    # ---- scheme state ----------------------------------------------------
    session = None
    if scheme == "ams":
        task = Task(loss_and_grad=world.loss_and_grad, teacher=None, phi_loss=phi_pixel_loss)
        session = AMSSession(task, ams_cfg, pretrained, seed=seed)
    pending: list = []  # frames sampled at the edge, waiting for upload
    next_sample_t = 0.0
    next_upload_t = ams_cfg.t_update
    # one-time
    ot_frames: list = []
    ot_done = False
    # remote tracking
    rt_label = None
    rt_prev_frame = None
    next_rt_t = 0.0
    # jit (Just-In-Time baseline)
    jit_opt = init_momentum(pretrained) if scheme == "jit" else None
    jit_params = pretrained if scheme == "jit" else None
    jit_u_prev = None
    next_jit_t = 0.0

    for idx in range(n_frames):
        t = idx / fps
        img, _ = video.frame(idx)
        tlabel = teacher.label(idx)

        # ---------------- evaluation (paper metric) -----------------------
        if idx % sim.eval_stride == 0:
            if scheme == "remote_tracking":
                pred = rt_label if rt_label is not None else np.zeros_like(tlabel)
            else:
                pred = world.predict(client_params, host_to_device(img[None], dev))[0]
                pred = pred.cpu().numpy()
            res.miou_per_frame.append(miou(pred, tlabel, video.cfg.n_classes))
            res.eval_times.append(t)

        # ---------------- scheme mechanics --------------------------------
        if scheme == "no_custom":
            continue

        if scheme == "one_time":
            if t < sim.one_time_window:
                if t >= next_sample_t:
                    ot_frames.append((img, tlabel))
                    next_sample_t += 1.0
            elif not ot_done:
                ot_done = True
                res.ledger.uplink(
                    codec.h264_buffer_bytes(len(ot_frames), n_pixels, sim.one_time_window), t
                )
                params, opt = pretrained, init_state(pretrained)
                fr = np.stack([f for f, _ in ot_frames])
                lb = np.stack([l for _, l in ot_frames])
                for _ in range(sim.one_time_iters):
                    pick = rng.integers(0, len(ot_frames), size=ams_cfg.batch_size)
                    _, grads = world.loss_and_grad(params, host_to_device(fr[pick], dev),
                                                   host_to_device(lb[pick], dev))
                    params, opt, _ = adam_update(params, grads, opt, lr=ams_cfg.lr)
                client_params = params
                res.ledger.downlink(full_model_bytes(params), t, "full-model")
                res.updates += 1
            continue

        if scheme == "remote_tracking":
            # warp held label by estimated global motion every frame
            if rt_label is not None and rt_prev_frame is not None:
                dy, dx = _global_shift(rt_prev_frame, img)
                rt_label = np.roll(np.roll(rt_label, dy, axis=0), dx, axis=1)
            rt_prev_frame = img
            if t >= next_rt_t:
                # full-quality JPEG up (buffering would make labels stale)
                res.ledger.uplink(codec.jpeg_bytes(n_pixels), t, "jpeg")
                rt_label = tlabel
                res.ledger.downlink(_label_bytes(tlabel), t, "label")
                next_rt_t += 1.0 / sim.remote_rate
            continue

        if scheme == "jit":
            # sample at the JIT rate, upload full-quality frames immediately
            if t >= next_jit_t:
                next_jit_t += 1.0 / sim.jit_sample_rate
                res.ledger.uplink(codec.jpeg_bytes(n_pixels), t, "jpeg")
                fr = host_to_device(img[None], dev)
                lb = host_to_device(tlabel[None], dev)
                it = 0
                while (
                    float(world.accuracy(jit_params, fr, lb)) < sim.jit_threshold
                    and it < sim.jit_max_iters
                ):
                    _, grads = world.loss_and_grad(jit_params, fr, lb)
                    if jit_u_prev is None:
                        mask = selection.random_mask(
                            torch.Generator().manual_seed(seed + idx), jit_params,
                            ams_cfg.gamma,
                        )
                    else:
                        mask = selection.gradient_guided_mask(jit_u_prev, ams_cfg.gamma)
                    jit_params, jit_opt, jit_u_prev = momentum_update(
                        jit_params, grads, jit_opt, mask, lr=ams_cfg.lr,
                        momentum=ams_cfg.momentum,
                    )
                    it += 1
                if it > 0:  # a model update is shipped
                    delta = encode_delta(jit_params, mask, ams_cfg.value_dtype)
                    res.ledger.downlink(delta.total_bytes, t)
                    client_params = apply_delta(client_params, delta)
                    res.updates += 1
            continue

        if scheme == "ams":
            # --- edge sampling at the server-set rate (ASR) ---
            if t >= next_sample_t:
                pending.append((img, tlabel))
                next_sample_t = t + 1.0 / max(session.sampling_rate, 1e-6)
            # --- buffered upload + train phase every T_update ---
            if t >= next_upload_t:
                if pending:
                    res.ledger.uplink(
                        codec.h264_buffer_bytes(len(pending), n_pixels, session.t_update), t
                    )
                    session.receive_labeled(
                        np.stack([f for f, _ in pending]),
                        np.stack([l for _, l in pending]),
                        t,
                    )
                    pending.clear()
                delta = session.train_phase(t)
                if delta is not None:
                    res.ledger.downlink(delta.total_bytes, t)
                    client_params = apply_delta(client_params, delta)
                    res.updates += 1
                next_upload_t = t + session.t_update
            continue

        raise ValueError(scheme)

    if session is not None:
        res.extras["history"] = session.history
    return res


SCHEMES = ("no_custom", "one_time", "remote_tracking", "jit", "ams")
