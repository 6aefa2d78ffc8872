"""The RWKV-6 wkv chunk loop's share of the prefill, on the device's
clock: CUDA events around every call of
`repro_torch.models.ssm.rwkv6._wkv_chunked`, wrapped from outside over
the traced run's window, summed over `serve`'s own prefill_ms of the
window's calls, in percent. The events' time includes what the loop's
launches wait for the host."""
import contextlib

import torch

UNIT, BETTER, SOURCE = "%", "lower", "program_span"
LAYER, MOVES = "models.ssm.rwkv6 (scan)", "prefill_tok_per_s"
KEY = "wkv_chunked_events"


@contextlib.contextmanager
def instrument(extra: dict):
    from repro_torch.models.ssm import rwkv6

    pairs = extra.setdefault(KEY, [])
    fn = rwkv6._wkv_chunked

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    rwkv6._wkv_chunked = timed
    try:
        yield
    finally:
        rwkv6._wkv_chunked = fn


def read(run):
    pairs = (run.extra or {}).get(KEY)
    if not pairs:
        return None
    torch.cuda.synchronize()
    scan_ms = sum(a.elapsed_time(b) for a, b in pairs)
    return 100.0 * scan_ms / sum(c.prefill_ms for c in run.calls)
