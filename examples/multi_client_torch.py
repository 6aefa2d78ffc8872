"""Multiple edge devices sharing one server GPU (Appendix E), on the
event-driven serving runtime of the PyTorch/CUDA port: pick a GPU policy
and a link profile and watch per-client accuracy, bandwidth, and delta
staleness. The student is pretrained and every session trains on the card
by default (``--device cuda``); ``--device cpu`` runs on the host, and
``--size`` sets the frames' height and width.

Run:  PYTHONPATH=src python examples/multi_client_torch.py --clients 4 --policy gain

Flight recorder: add ``--trace out.json`` to record every grant, labeling
launch, train phase and client transfer as spans in simulated time, then
open the file at https://ui.perfetto.dev ("Open trace file") to see the
schedule — one track per GPU stream, one per client link, counter tracks
for queue depth / backlog / stream utilization.
"""
import argparse

from repro_torch.core.server import AMSConfig
from repro_torch.device import resolve_device
from repro_torch.models.seg.student import SegConfig
from repro_torch.serving import LinkSpec, StreamModel, Tracer
from repro_torch.sim.multiclient import run_multiclient
from repro_torch.sim.seg_world import pretrain_student


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--duration", type=float, default=90.0)
    ap.add_argument("--atr", action="store_true")
    ap.add_argument("--policy", default="fair",
                    choices=("fair", "edf", "gain", "affinity"))
    ap.add_argument("--gpus", type=int, default=1,
                    help="server GPU pool size")
    ap.add_argument("--affinity", action="store_true",
                    help="residency-aware (session, gpu) placement")
    ap.add_argument("--fuse-train", type=int, default=1,
                    help="max co-resident sessions per fused train launch")
    ap.add_argument("--overlap", action="store_true",
                    help="dual-stream devices: teacher labeling overlaps "
                         "training instead of serializing on one clock")
    ap.add_argument("--slowdown", type=float, default=1.1,
                    help="stream contention stretch while both streams are "
                         "busy (with --overlap; 1.0 = full overlap)")
    ap.add_argument("--preempt", action="store_true",
                    help="labeling launches preemptible at frame-batch "
                         "boundaries (works with or without --overlap)")
    ap.add_argument("--up-kbps", type=float, default=1000.0)
    ap.add_argument("--down-kbps", type=float, default=2000.0)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome trace-event JSON of the run "
                         "(open at https://ui.perfetto.dev)")
    ap.add_argument("--device", default="cuda",
                    help="where the student trains (cuda: the card)")
    ap.add_argument("--size", type=int, default=48,
                    help="frame height and width in pixels")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    hw = dict(height=args.size, width=args.size)

    seg_cfg = SegConfig(n_classes=5)
    pre = pretrain_student(seg_cfg, n_videos=3, steps=120,
                           video_kw=dict(**hw, fps=4.0, duration=60.0),
                           device=dev)
    ams = AMSConfig(t_update=10.0, t_horizon=60.0, k_iters=12, batch_size=6,
                    gamma=0.05, lr=2e-3, phi_target=0.15, asr_eta=1.0, atr_enabled=args.atr)
    streams = None
    if args.overlap or args.preempt:
        streams = StreamModel(
            mode="overlap" if args.overlap else "serialized",
            slowdown=args.slowdown if args.overlap else 1.0,
            preempt=args.preempt, preempt_cost_s=0.02)
    tracer = Tracer() if args.trace else None
    out = run_multiclient(args.clients, pre, seg_cfg, ams, duration=args.duration,
                          video_kw=dict(**hw, fps=4.0),
                          policy=args.policy, n_gpus=args.gpus,
                          affinity=args.affinity, fuse_train=args.fuse_train,
                          streams=streams,
                          link=LinkSpec(up_kbps=args.up_kbps, down_kbps=args.down_kbps),
                          tracer=tracer)
    if tracer is not None:
        tracer.dump(args.trace)
        print(f"trace: {args.trace} — open at https://ui.perfetto.dev "
              f"('Open trace file')")
    print(f"clients={out['n_clients']} policy={out['scheduler']} "
          f"gpus={out['n_gpus']} "
          f"mean mIoU={out['mean_miou']:.3f} gpu_util={out['gpu_utilization']:.2f} "
          f"served={out['phases_served']} deferred={out['phases_deferred']} "
          f"dropped={out['dropped_requests']}")
    print(f"delta latency: mean={out['delta_latency_mean_s']*1e3:.0f} ms "
          f"max={out['delta_latency_max_s']*1e3:.0f} ms; "
          f"events={out['events_processed']} ({out['events_per_sec']:.0f}/s)")
    if out["n_gpus"] > 1:
        utils = "/".join(f"{u:.2f}" for u in out["per_gpu_utilization"])
        print(f"pool: per-gpu util {utils}; migrations={out['migrations']} "
              f"({out['migration_s_total']:.1f} s); "
              f"evictions={out['residency_evictions']}")
    if out["fused_launches"]:
        print(f"fused training: {out['fused_launches']} stacked launches "
              f"covering {out['fused_sessions']} sessions "
              f"({out['rider_grants']} riders)")
        up = out["update_pipeline"]
        print(f"update pipeline: {up['stacked_select_launches']} stacked "
              f"selection launches ({up['stacked_select_sessions']} "
              f"sessions), {up['stacked_encode_launches']} batched encodes "
              f"({up['stacked_encode_sessions']} deltas)")
    if out["stream_mode"] != "serialized" or out["preemptions"]:
        su = out["per_gpu_stream_utilization"]
        print(f"streams [{out['stream_mode']}]: label util "
              f"{su['label'][0]:.2f} train util {su['train'][0]:.2f}; "
              f"overlap {out['overlap_s']:.1f} s; "
              f"{out['preemptions']} preemptions "
              f"({out['preempted_frames']} frames requeued)")
    for i, (m, (up, down), ph, dev) in enumerate(zip(out["miou_per_client"],
                                                     out["per_client_kbps"],
                                                     out["phases_per_client"],
                                                     out["devices_per_client"])):
        gpus = ",".join(map(str, dev)) or "-"
        print(f"  client {i}: mIoU {m:.3f}  up {up:.0f} Kbps  down {down:.0f} Kbps  "
              f"phases {ph}  gpus [{gpus}]")


if __name__ == "__main__":
    main()
