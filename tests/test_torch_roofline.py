"""The port's roofline arithmetic (`roofline/analytic.py`,
`roofline/analysis.py`, `launch/mesh.py`) against the JAX package's.

`analytic_cost` must equal the JAX package's exactly (same FLOPs, bytes
and model FLOPs, to the last bit) for every ported full config and every
step kind; the bounds differ only by the card's constants: the port's are
an H100 SXM's data-sheet peaks (989 TFLOP/s bf16, 3.35 TB/s, NVLink 450
GB/s a direction), the JAX package's a TPU v5e's, so a memory-bound share
scales by the ratio of the two HBM rates.
"""
import math

import pytest

from repro.configs import get_config as get_config_jax
from repro.configs import get_smoke as get_smoke_jax
from repro.launch import mesh as mesh_jax
from repro.roofline import analysis as analysis_jax
from repro.roofline import analytic as analytic_jax
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import mesh
from repro_torch.roofline import analysis, analytic

ARCHS = ["gemma2-9b", "gemma-2b", "moonshot-v1-16b-a3b", "mixtral-8x22b",
         "llama4-maverick-400b-a17b", "llama3-405b", "zamba2-7b", "rwkv6-3b",
         "llama-3.2-vision-90b", "whisper-large-v3"]
SHAPES = {"train": (4096, 256), "prefill": (8000, 2), "decode": (8064, 2),
          "decode_long": (500_000, 1)}


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_cost_equals_jax(arch, kind):
    seq, batch = SHAPES[kind]
    want = analytic_jax.analytic_cost(get_config_jax(arch),
                                      analytic_jax.ShapeSpec(kind, seq, batch))
    got = analytic.analytic_cost(get_config(arch), analytic.ShapeSpec(kind, seq, batch))
    assert got == want
    assert all(type(v) is float and v > 0 for v in got.values())


@pytest.mark.parametrize("ring", [False, True])
def test_analytic_cost_equals_jax_under_the_ring_cache(ring):
    """Decode with window slicing on: Mixtral's windowed blocks attend
    min(seq, window) positions, and a full block under an override."""
    over = dict(decode_window_slicing=ring, attn_window_override=2048)
    for arch in ("mixtral-8x22b", "gemma2-9b"):
        spec = ("decode_long", 100_000, 2)
        want = analytic_jax.analytic_cost(get_config_jax(arch, **over),
                                          analytic_jax.ShapeSpec(*spec))
        got = analytic.analytic_cost(get_config(arch, **over), analytic.ShapeSpec(*spec))
        assert got == want


def test_moonlight_anchors():
    """The numbers the MoE serving path is held to on the card (2 prompts
    of 8,000 tokens; decode against 8,064 positions)."""
    cfg = get_config("moonshot-v1-16b-a3b")
    pre = analytic.analytic_cost(cfg, analytic.ShapeSpec("prefill", 8000, 2))
    dec = analytic.analytic_cost(cfg, analytic.ShapeSpec("decode", 8064, 2))
    assert math.isclose(pre["flops"], 2.025e14, rel_tol=1e-3)
    assert math.isclose(pre["model_flops"], 1.430e14, rel_tol=1e-3)
    assert math.isclose(dec["bytes"], 2.027e10, rel_tol=1e-3)
    assert math.isclose(pre["flops"] / mesh.PEAK_FLOPS_BF16, 0.2048, rel_tol=1e-3)
    assert math.isclose(dec["bytes"] / mesh.HBM_BW, 6.05e-3, rel_tol=1e-3)
    # decode counts the experts that B * k = 12 tokens can touch, not all 64
    assert analytic._decode_touched_params(cfg, 2) < analytic.param_count(
        analytic.model_metas(cfg))


@pytest.mark.parametrize("arch,pre,pre_model,pre_bytes,dec_bytes", [
    ("zamba2-7b", 4.375e14, 2.124e14, 9.408e10, 2.012e10),
    ("rwkv6-3b", 8.154e13, 8.610e13, 2.639e10, 5.468e9),
])
def test_recurrent_anchors(arch, pre, pre_model, pre_bytes, dec_bytes):
    """The numbers the hybrid and recurrent serving paths are held to on
    the card (2 prompts of 8,000 tokens; decode against 8,064 positions):
    Zamba2's prefill bound 442.4 ms (operations), decode 6.01 ms (bytes);
    RWKV6's 82.4 ms and 1.63 ms."""
    cfg = get_config(arch)
    p = analytic.analytic_cost(cfg, analytic.ShapeSpec("prefill", 8000, 2))
    d = analytic.analytic_cost(cfg, analytic.ShapeSpec("decode", 8064, 2))
    for got, want in ((p["flops"], pre), (p["model_flops"], pre_model),
                      (p["bytes"], pre_bytes), (d["bytes"], dec_bytes)):
        assert math.isclose(got, want, rel_tol=1e-3), (got, want)
    bounds = {"zamba2-7b": (0.4424, 6.005e-3), "rwkv6-3b": (0.08245, 1.632e-3)}[arch]
    assert math.isclose(p["flops"] / mesh.PEAK_FLOPS_BF16, bounds[0], rel_tol=1e-3)
    assert math.isclose(d["bytes"] / mesh.HBM_BW, bounds[1], rel_tol=1e-3)


def test_unported_kinds_raise():
    """Every block kind is priced (``xattn`` too, which no longer raises);
    an unknown one raises ``ValueError`` in both packages."""
    spec = ("prefill", 16, 1)
    over = dict(pattern=("xattn",), num_xattn_tokens=24)
    got = analytic.analytic_cost(get_smoke("gemma-2b", **over), analytic.ShapeSpec(*spec))
    assert got == analytic_jax.analytic_cost(get_smoke_jax("gemma-2b", **over),
                                             analytic_jax.ShapeSpec(*spec))
    for pkg, get in ((analytic, get_smoke), (analytic_jax, get_smoke_jax)):
        with pytest.raises(ValueError):
            pkg.analytic_cost(get("gemma-2b", pattern=("attn_mystery",)), pkg.ShapeSpec(*spec))


def test_h100_constants():
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.NVLINK_BW) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("flops,nbytes,coll,chips,bottleneck", [
    (989e12, 1e9, 1e6, 1, "compute"),      # 1 s of compute
    (1e12, 6.7e12, 1e6, 1, "memory"),      # 2 s of HBM
    (1e12, 1e9, 3.6e12, 4, "collective"),  # 8 s of one card's NVLink
])
def test_roofline_terms_bottleneck(flops, nbytes, coll, chips, bottleneck):
    t = analysis.roofline_terms(flops, nbytes, coll, chips)
    assert t["t_compute_s"] == flops / (chips * 989e12)
    assert t["t_memory_s"] == nbytes / (chips * 3.35e12)
    # one device's collective bytes at one card's link rate, not divided
    # by the cards again (the JAX package's convention, ROADMAP F19)
    assert t["t_collective_s"] == coll / 450e9
    assert t["bottleneck"] == bottleneck
    assert t["step_time_lb_s"] == max(t["t_compute_s"], t["t_memory_s"],
                                      t["t_collective_s"])
    # the same logic as the JAX package's, on other constants
    j = analysis_jax.roofline_terms(flops, nbytes, coll, chips)
    assert j["t_compute_s"] * mesh_jax.PEAK_FLOPS_BF16 == pytest.approx(
        t["t_compute_s"] * mesh.PEAK_FLOPS_BF16)
    assert j["t_memory_s"] * mesh_jax.HBM_BW == pytest.approx(t["t_memory_s"] * mesh.HBM_BW)


def test_node_constants():
    assert (mesh.GPUS_PER_NODE, mesh.IB_BW) == (8, 50e9)


@pytest.mark.parametrize("ranks,seconds", [
    (range(8), 1 / 450e9),                   # one node: NVLink
    (range(16), 1 / 450e9),                  # 8 + 8 over two nodes' 8 ports each
    (range(0, 256, 16), 15 / 16 / 50e9),     # one card on each of 16 nodes
    ((0, 256), 1 / 2 / 50e9),                # the two pods' rank 0
    (range(0, 32, 2), 3 / 4 / 4 / 50e9),     # 4 on each of 4 nodes: 3/4 over 4 ports
])
def test_collective_seconds_by_the_links_a_group_crosses(ranks, seconds):
    got = analysis.collective_seconds(1e9, ranks)
    assert got == pytest.approx(1e9 * seconds, rel=1e-12)
    t = analysis.roofline_terms(0.0, 0.0, 1e9, 256, collective_s=got)
    assert t["t_collective_s"] == got and t["bottleneck"] == "collective"


def test_kernel_bounds_equal_jax():
    for n in (1, 334_405, 8 * 334_405):
        assert analysis.adam_step_hbm_bytes(n) == analysis_jax.adam_step_hbm_bytes(n)
        assert analysis.adam_step_hbm_bytes(n, param_bytes=2) == \
            analysis_jax.adam_step_hbm_bytes(n, param_bytes=2)
        for passes in (1, 3, 32):
            assert analysis.topk_hbm_bytes(n, passes=passes) == \
                analysis_jax.topk_hbm_bytes(n, passes=passes)
    assert analysis.extrapolate_depth(3.0, 5.0, 48) == analysis_jax.extrapolate_depth(3.0, 5.0, 48)
    assert analysis.kernel_roofline_fraction(100, 0.0) is None
    assert analysis.kernel_roofline_fraction(3.35e9, 1e-3) == pytest.approx(1.0)


def test_serving_stage_report_matches_jax_but_for_the_hbm_rate():
    drift = {
        "train_fused": dict(measured_steady_s=3.59, modeled_steady_s=2.53, compile_s=22.0,
                            calls=12, nbytes=0),
        "select_stacked": dict(measured_steady_s=0.004, modeled_steady_s=0.01,
                               compile_s=0.2, calls=12, nbytes=5 * 8 * 334_405),
        "encode_solo": dict(measured_steady_s=0.0, modeled_steady_s=0.5, compile_s=0.0,
                            calls=1),
    }
    got = analysis.serving_stage_report(drift)
    want = analysis_jax.serving_stage_report(drift)
    assert got["bottleneck"] == want["bottleneck"] == "train_fused"
    assert got["measured_total_s"] == want["measured_total_s"]
    assert list(got["stages"]) == list(want["stages"])
    for stage, g in got["stages"].items():
        w = want["stages"][stage]
        assert {k: v for k, v in g.items() if k != "roofline_fraction"} == \
            {k: v for k, v in w.items() if k != "roofline_fraction"}
        if w["roofline_fraction"] is None:
            assert g["roofline_fraction"] is None
        else:
            assert g["roofline_fraction"] / w["roofline_fraction"] == pytest.approx(
                mesh_jax.HBM_BW / mesh.HBM_BW)
    assert analysis.serving_stage_report({})["bottleneck"] is None
