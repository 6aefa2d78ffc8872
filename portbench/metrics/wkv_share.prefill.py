"""The RWKV-6 wkv chunk loop's share of the prefill, on the device's
clock, from the port's own spans over `spans.span_times` (three calls,
no profiler): the ``rwkv6.wkv_chunked`` spans' device milliseconds over
the ``serve.prefill`` spans', summed over the calls, in percent. Like
`scan_share.prefill`, whose successor it is, the spans' time includes
what the loop's launches wait for the host."""
from portbench import spans

UNIT, BETTER, SOURCE = "%", "lower", "program_span"
LAYER, MOVES = "models.ssm.rwkv6 (scan)", "prefill_tok_per_s"


def read(run):
    p = spans.span_times(run)
    scan, prefill = spans.device_ms(p, "rwkv6.wkv_chunked"), spans.device_ms(p, "serve.prefill")
    if not scan or not prefill:
        return None
    return 100.0 * sum(scan) / sum(prefill)
