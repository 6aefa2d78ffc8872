"""The share of the device's traced window that sits idle while the host
is inside the RWKV-6 wkv chunk loop: in the span pass (`spans.span_pass`,
three prefill_8k calls), the device's idle time while the host's
innermost span is ``rwkv6.wkv_chunked``, over the pass's windows, in
percent. The idle time a scan that launches less would remove."""
from portbench import spans

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "models.ssm.rwkv6 (scan)", "prefill_tok_per_s"


def read(run):
    return spans.idle_share_under(run, "rwkv6.wkv_chunked")
