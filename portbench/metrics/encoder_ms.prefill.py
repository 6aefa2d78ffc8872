"""The encoder's device milliseconds a call: the port's
``transformer.encode`` span (CUDA events at its edges) over
`spans.span_times` (whole calls with the port's spans on, no profiler,
after the harness's own trace), a mean over its calls (one encode a
call)."""
from portbench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "models.transformer (encoder)", "prefill_tok_per_s"


def read(run):
    ms = spans.device_ms(spans.span_times(run), "transformer.encode")
    return sum(ms) / len(ms) if ms else None
