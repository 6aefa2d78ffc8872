"""The share of the device's traced window that sits idle while the host
is inside the prefill: in the span pass (`spans.span_pass`: whole calls
with the port's spans on, traced after the harness's own trace), the
device's idle time while the host's innermost span is ``serve.prefill``
or one inside it, over the pass's windows (each segment's first device
operation to its last), in percent. No greater than the pass's whole
idle share."""
from portbench import spans

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "launch.steps (step)", "prefill_tok_per_s"


def read(run):
    return spans.idle_share_under(run, "serve.prefill")
