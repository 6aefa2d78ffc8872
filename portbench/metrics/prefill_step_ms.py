"""`serve`'s own prefill_ms (CUDA events around the prefill step, the
encoder included), a mean over the window's calls."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "launch.steps (step)", "prefill_tok_per_s"


def read(run):
    return sum(c.prefill_ms for c in run.calls) / len(run.calls)
