"""Roofline terms and serving-stage bounds (the arithmetic part of the JAX
package's `roofline/analysis.py`), against an H100's data-sheet peaks
(`launch/mesh.py`):

    compute    = FLOPs / (chips * peak bf16 FLOP/s)
    memory     = HBM bytes / (chips * HBM bytes/s)
    collective = collective bytes / (chips * NVLink bytes/s)

The FLOPs and bytes come from `roofline.analytic`. The JAX package's HLO
readers (`collective_bytes_from_hlo`, `hlo_facts`), which read compiled
XLA programs, wait for the dry-run launcher (ROADMAP §1 item 7).
"""
from __future__ import annotations

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


def extrapolate_depth(c1: float, c2: float, n_groups: int) -> float:
    """Linear in depth: total(G) = c1 + (G-1)*(c2-c1)."""
    return c1 + (n_groups - 1) * (c2 - c1)


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   chips: int) -> dict:
    t_compute = flops / (chips * PEAK_FLOPS_BF16)
    t_memory = hbm_bytes / (chips * HBM_BW)
    t_collective = collective_bytes / (chips * NVLINK_BW)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_collective}
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "bottleneck": max(terms, key=terms.get),
        "step_time_lb_s": max(terms.values()),
    }


# ---------------------------------------------------------------------------
# serving hot-path kernel bounds (masked Adam, K1; top-k threshold, K2)
# ---------------------------------------------------------------------------


def adam_step_hbm_bytes(n_params: int, *, param_bytes: int = 4) -> int:
    """Analytic minimum HBM traffic of ONE masked-Adam step over
    ``n_params`` coordinates: read p/g/m/v + bool mask, write p/m/v/u —
    every buffer touched exactly once (what the fused masked-Adam kernel,
    `csrc/masked_adam.cu`, streams; 33 B/param for f32 params). Multiply by B sessions and K
    iterations for a fused phase's optimizer-update term."""
    return int(n_params) * (25 + 2 * param_bytes)


def topk_hbm_bytes(n_coords: int, *, passes: int = 1) -> int:
    """Analytic HBM traffic of one session's bit-pattern top-k selection:
    ``passes`` reads of the 4-byte |u| buffer plus the 1-byte mask write.
    ``passes=1`` is the bound; the port's radix select
    (`csrc/topk_mask.cu`) reads |u| once per digit (``passes=3``)."""
    return int(n_coords) * (4 * passes + 1)


def kernel_roofline_fraction(nbytes: int, measured_s: float,
                             *, chips: int = 1) -> float | None:
    """Achieved fraction of the HBM roofline: the analytic memory-bound
    time for ``nbytes`` of traffic over the measured wall-clock. 1.0 means
    the launch ran at memory-bandwidth speed; the gap is launch overhead,
    compute, or wasted re-reads."""
    if not measured_s or measured_s <= 0:
        return None
    return (nbytes / (chips * HBM_BW)) / measured_s


def serving_stage_report(drift: dict) -> dict:
    """Roofline-style summary of the serving pipeline's *measured* stage
    timings, consuming a `repro_torch.serving.obs.drift_report` dict.

    Where `roofline_terms` ranks analytic lower bounds, this ranks the
    stages the fused serving path actually ran (steady-state wall-clock,
    compile excluded) and reports each stage's model efficiency — modeled
    seconds / measured seconds, the fraction of `GPUCostModel`'s price the
    real stacked executables achieve. ``bottleneck`` is the stage eating
    the most measured steady time; a low ``model_efficiency`` there is
    where re-pricing (or a faster kernel) pays first.

    Stages whose timing hooks recorded analytic byte traffic (``nbytes`` —
    the masked-Adam and top-k bounds above) additionally report
    ``roofline_fraction``: measured steady wall-clock against the
    memory-bound time for those bytes (`kernel_roofline_fraction`)."""
    stages = {}
    for stage, e in sorted(drift.items()):
        meas, mod = e["measured_steady_s"], e["modeled_steady_s"]
        nbytes = int(e.get("nbytes", 0))
        stages[stage] = {
            "measured_s": meas,
            "modeled_s": mod,
            "compile_s": e["compile_s"],
            "calls": e["calls"],
            "model_efficiency": (mod / meas) if meas > 0 else None,
            "nbytes": nbytes,
            "roofline_fraction": (kernel_roofline_fraction(nbytes, meas)
                                  if nbytes else None),
        }
    measured = {k: v["measured_s"] for k, v in stages.items()}
    return {
        "stages": stages,
        "bottleneck": (max(measured, key=measured.get) if measured else None),
        "measured_total_s": sum(measured.values()),
    }
