"""Host milliseconds a prefill call spends outside the port's prefill
span: the call's host wall minus `serve`'s own prefill_ms (CUDA events),
a mean over the window's calls. The first token's way to the host: the
argmax, the copy back, the call's set-up."""

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER, MOVES = "launch.serve (host)", "ttft_p95_ms"


def read(run):
    calls = run.calls
    return sum(c.wall_ms - c.prefill_ms for c in calls) / len(calls)
