"""The decode step's 95th percentile, on the device's clock: the port's
``serve.decode_step`` spans' device milliseconds over every step of
`spans.span_times` (no profiler; transcribe_b64: 2 calls of 64 steps, 7
beyond the 95th percentile)."""
import statistics

from portbench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "launch.steps (step)", "output_tok_per_s"


def read(run):
    steps = spans.device_ms(spans.span_times(run), "serve.decode_step")
    if len(steps) < 2:
        return None
    return statistics.quantiles(steps, n=100, method="inclusive")[94]
