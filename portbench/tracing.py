"""The device's activity in a `torch.profiler` trace, reduced to what the
metrics read: seconds busy (the union of every kernel, copy and set's
interval), the traced window (first start to last end on the device's
clock), seconds by operation name, and the idle gaps, each named by the
operation that ended it (what the host was launching while the device
waited)."""
from __future__ import annotations

from collections import defaultdict

import torch

NAME_CHARS = 160  # operation names are C++ signatures; keep their heads
NOISE = ("void ", "at::native::", "(anonymous namespace)::", "c10::", "std::")


def short_name(name: str) -> str:
    """A kernel's name without its namespaces, cut to `NAME_CHARS`."""
    for part in NOISE:
        name = name.replace(part, "")
    return name[:NAME_CHARS]


def _ns(event) -> tuple[int, int]:
    if hasattr(event, "start_ns"):
        start = event.start_ns()
        return start, start + event.duration_ns()
    start = int(event.start_us() * 1000)
    return start, start + int(event.duration_us() * 1000)


def device_intervals(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device operation in the trace."""
    out = []
    for event in prof.profiler.kineto_results.events():
        if event.device_type() == torch.autograd.DeviceType.CUDA:
            start, end = _ns(event)
            out.append((short_name(event.name()), start, end))
    return out


def summarize(intervals: list[tuple[str, int, int]]) -> dict | None:
    """{"busy_s", "window_s", "ops": {name: s}, "gaps": {"before <name>":
    s}}, or None for a trace with no device operation."""
    if not intervals:
        return None
    ops, gaps = defaultdict(float), defaultdict(float)
    ivs = sorted(intervals, key=lambda iv: iv[1])
    busy = 0
    cur_start, cur_end = ivs[0][1], ivs[0][2]
    for name, start, end in ivs:
        ops[name] += (end - start) / 1e9
        if start > cur_end:
            busy += cur_end - cur_start
            gaps[f"before {name}"] += (start - cur_end) / 1e9
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = max(end for _, _, end in ivs) - ivs[0][1]
    return {"busy_s": busy / 1e9, "window_s": window / 1e9, "ops": dict(ops), "gaps": dict(gaps)}


def top(seconds: dict, n: int = 10) -> list[list]:
    """The ``n`` largest entries as [name, seconds], largest first."""
    return [[k, v] for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:n]]
