"""Seconds from the start of the run's process to the first timed call:
imports, the kernels' load (their build in a checkout's first run), the
weights drawn on the card and one warm call (the host's clock)."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s
