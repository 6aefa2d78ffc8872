"""`serve`'s own decode_ms_per_token (CUDA events from the end of the
prefill to the end of the last decode step, over the steps), a mean over
the window's calls."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "launch.steps (step)", "output_tok_per_s"


def read(run):
    if not run.traffic.new_tokens:
        return None
    return sum(c.decode_ms_per_token for c in run.calls) / len(run.calls)
