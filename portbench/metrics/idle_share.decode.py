"""The device's idle share over the traced calls of a decoding cell,
whole calls as `output_tok_per_s` counts them (the prefill, then the
decode steps): 1 - busy / the traced window (`tracing.summarize`), in
percent."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "output_tok_per_s"


def read(run):
    if not run.trace:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
