"""Time to first token, 95th percentile over every request of the
window: from the start of the request's call to the return of its tokens
to the host, where its first token is (the host's clock)."""
import statistics

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(run):
    values = [c.wall_ms for c in run.calls for _ in range(run.traffic.batch)]
    if len(values) < 2:
        return values[0] if values else None
    return statistics.quantiles(values, n=100, method="inclusive")[94]
