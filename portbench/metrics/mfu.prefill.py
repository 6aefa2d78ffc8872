"""The whole prefill's share of the card's bf16 peak: the model
operations of every call of the window (`flops/<arch>.prefill`: an
encoder's pass and the cross-attention's K/V projections counted) over
the window's seconds (the host's clock) at 989 TFLOP/s, in percent."""

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER, MOVES = "launch.steps (step)", "prefill_tok_per_s"


def read(run):
    if not run.peak:
        return None
    tr = run.traffic
    flops = run.session.flops.prefill(run.session.model, tr.batch, tr.prompt_tokens,
                                      tr.memory_positions)["flops"]
    return 100.0 * len(run.calls) * flops / (run.window_s * run.peak["bf16_flops_per_s"])
