"""Input positions prefilled per second: every call's prompt tokens and
frames, over the window's seconds (the host's clock)."""

UNIT, BETTER, SOURCE = "tok/s", "higher", "host_clock"


def read(run):
    return len(run.calls) * run.traffic.positions_per_call / run.window_s
