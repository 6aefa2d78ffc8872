"""K4's (flash attention's) share of its roofline in the prefill: the
least time its calls could take, each the larger of its operations at
the bf16 peak and its bytes at HBM's rate (`flops/attention.py`, the
calls from the configuration's `attention_calls`), over the time that
`torch.profiler` traced in kernels named ``flash_fwd_`` in the traced
calls, in percent."""

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels.flash_attention (K4)", "prefill_tok_per_s"
KERNEL = "flash_fwd_"


def read(run):
    if not run.trace or not run.peak:
        return None
    k4_s = sum(s for name, s in run.trace["ops"].items() if KERNEL in name)
    session, tr = run.session, run.traffic
    calls = session.flops.attention_calls(session.model, tr.batch, tr.prompt_tokens,
                                          tr.memory_positions)
    if not k4_s or not calls:
        return None
    attention = session.bench.module("flops", "attention")
    bound = 0.0
    for call in calls:
        flops, nbytes = attention.cost(call)
        bound += call["n"] * max(flops / run.peak["bf16_flops_per_s"],
                                 nbytes / run.peak["hbm_bytes_per_s"])
    return 100.0 * run.trace["calls"] * bound / k4_s
