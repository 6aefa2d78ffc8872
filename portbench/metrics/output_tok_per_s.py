"""Tokens served per second: every call's tokens (the prefill's, then
one a decode step, for each row), over the window's seconds (the host's
clock)."""

UNIT, BETTER, SOURCE = "tok/s", "higher", "host_clock"


def read(run):
    return len(run.calls) * run.traffic.tokens_per_call / run.window_s
