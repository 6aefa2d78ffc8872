"""The device's idle share over the traced prefill calls: 1 - busy / the
traced window (`tracing.summarize`: the union of every device
operation's interval, over first start to last end), in percent."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "prefill_tok_per_s"


def read(run):
    if not run.trace:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
