"""Decode attention's share of the decode steps, on the device's clock,
from the port's own spans over `spans.span_times` (no profiler): the
``attention.decode_self`` and ``attention.decode_cross`` spans' device
milliseconds (the projections, the cache write, the casts and the
float32 attention) over the ``serve.decode_step`` spans', summed over
its calls, in percent."""
from portbench import spans

UNIT, BETTER, SOURCE = "%", "lower", "program_span"
LAYER, MOVES = "models.attention (decode)", "output_tok_per_s"


def read(run):
    p = spans.span_times(run)
    steps = spans.device_ms(p, "serve.decode_step")
    attn = spans.device_ms(p, "attention.decode_self") + spans.device_ms(
        p, "attention.decode_cross")
    if not steps or not attn:
        return None
    return 100.0 * sum(attn) / sum(steps)
