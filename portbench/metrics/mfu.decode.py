"""The decode steps' share of the card's bf16 peak: their model
operations (`flops/<arch>.decode`) over their time by `serve`'s own
CUDA events (decode_ms_per_token times the steps), summed over the
window's calls, in percent."""

UNIT, BETTER, SOURCE = "%", "higher", "program_span"
LAYER, MOVES = "launch.steps (step)", "output_tok_per_s"


def read(run):
    tr = run.traffic
    if not run.peak or not tr.new_tokens:
        return None
    flops = run.session.flops.decode(run.session.model, tr.batch, tr.prompt_tokens,
                                     tr.memory_positions, tr.new_tokens)["flops"]
    seconds = sum(c.decode_ms_per_token for c in run.calls) * tr.new_tokens / 1e3
    return 100.0 * len(run.calls) * flops / (seconds * run.peak["bf16_flops_per_s"])
