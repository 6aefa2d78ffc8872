"""The decode steps' share of HBM's rate: the bytes the steps must move
(`flops/<arch>.decode`: each weight read once, every cache read once)
over their time by `serve`'s own CUDA events, summed over the window's
calls, at 3.35 TB/s, in percent."""

UNIT, BETTER, SOURCE = "%", "higher", "program_span"
LAYER, MOVES = "launch.steps (step)", "output_tok_per_s"


def read(run):
    tr = run.traffic
    if not run.peak or not tr.new_tokens:
        return None
    nbytes = run.session.flops.decode(run.session.model, tr.batch, tr.prompt_tokens,
                                      tr.memory_positions, tr.new_tokens)["bytes"]
    seconds = sum(c.decode_ms_per_token for c in run.calls) * tr.new_tokens / 1e3
    return 100.0 * len(run.calls) * nbytes / (seconds * run.peak["hbm_bytes_per_s"])
