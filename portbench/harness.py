"""One run of one cell: set-up, the measured window, the traced calls, the
comparison, the result line.

Everything that belongs to one cell is found by name under the folder
beside `BENCHMARK.json` (`Bench`): ``configs/<config>.json`` (the sizes
as run, its ``arch`` and the port's config it overrides),
``traffic/<mix>.json`` (the mix's parameters and its ``driver``,
``traffic/<driver>.py``), ``workloads/<cell>.json`` (the comparison's
sample and limits), ``reference/<arch>.py`` (the plain reference and the
weight table), ``flops/<arch>.py`` (operations and bytes) and
``metrics/<metric>.py`` (one reader a metric). No list of cells or
metrics is written here.

The window drives `repro_torch.launch.serve.serve`, the port's serving
entry, back to back (the mix's driver). Its step factories are wrapped
from outside, so that each call keeps the logits of a few rows drawn
from the seed for the comparison (`compare`). A traced run (``trace``)
also runs each per-layer metric's instrument over the window and, after
it, traces whole calls for `TRACE_SECONDS` with `torch.profiler` (the
device's activity only).
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import random
import re
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from portbench import compare, tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names
# whole calls for at least this long: one RWKV-6 prefill (135k kernels) keeps
# every event in the tracer's buffers, where two lost some
TRACE_SECONDS = 2.0


def forbidden_modules(names=None) -> list[str]:
    """The JAX package's and JAX's modules among ``names`` (the modules
    loaded in this process by default)."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


class Bench:
    """The benchmark as its files give it: ``root``/BENCHMARK.json and the
    folder ``root``/portbench that holds the files it names."""

    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules = {}

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in {self.root / 'BENCHMARK.json'}")

    def data(self, kind: str, name: str) -> dict:
        return json.loads((self.dir / kind / f"{name}.json").read_text())

    def module(self, kind: str, name: str):
        key = (kind, name)
        if key not in self._modules:
            path = self.dir / kind / f"{name}.py"
            spec = importlib.util.spec_from_file_location(
                f"portbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
            if spec is None:
                raise FileNotFoundError(path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or its per-layer ones when
        ``trace``: those that list it under ``workloads`` or list none."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


def port_config(config: dict):
    """The port's ModelConfig for a configuration file: the port's own
    config of ``port_arch`` with every key of ``model`` set as the file
    gives it."""
    from repro_torch.configs import get_config

    model = {k: tuple(v) if isinstance(v, list) else v for k, v in config["model"].items()}
    return get_config(config["port_arch"]).replace(**model)


def walk(tree: dict, path=()):
    """(key path, leaf) in sorted key order: a leaf is a tensor, a
    ParamMeta or a weight table's entry (a dict with a ``shape``)."""
    for key in sorted(tree):
        if isinstance(tree[key], dict) and "shape" not in tree[key]:
            yield from walk(tree[key], path + (key,))
        else:
            yield path + (key,), tree[key]


def draw_weights(table: dict, seed: int, device, dtype) -> dict:
    """The weight tree of ``table`` (`reference.common.leaf` entries),
    all leaves views of one buffer drawn N(0, 1) in ``dtype`` by one call
    on ``device`` from a generator seeded with ``seed``, then each scaled
    and shifted in place."""
    leaves = list(walk(table))
    total = sum(math.prod(spec["shape"]) for _, spec in leaves)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, offset = {}, 0
    for path, spec in leaves:
        n = math.prod(spec["shape"])
        t = flat[offset:offset + n].view(spec["shape"]).mul_(spec["std"])
        if spec["mean"]:
            t.add_(spec["mean"])
        offset += n
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return out


def check_tree(params: dict, metas: dict):
    """Raise unless ``params`` has the port's parameter tree: the same
    keys, each leaf of the shape the port's model takes."""
    got = {p: tuple(t.shape) for p, t in walk(params)}
    want = {p: tuple(m.shape) for p, m in walk(metas)}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:6]
        raise ValueError(f"weight tree differs from the port's: {diff}")


@dataclass
class Call:
    """One call of `serve`: host clock at its start and end, the port's
    own CUDA-event times, the served tokens (B, n + 1) on the host, the
    rows whose logits it kept and those logits (rows, n + 1, V)."""

    index: int
    start: float
    end: float
    prefill_ms: float
    decode_ms_per_token: float
    tokens: torch.Tensor
    finite: bool
    rows: list
    logits: torch.Tensor | None

    @property
    def wall_ms(self) -> float:
        return 1e3 * (self.end - self.start)


class _Keep:
    """Wraps the step factories that `serve` calls, so that each step's
    logits at the call's chosen rows are kept (a gather on the device)."""

    def __init__(self, serve_mod):
        self.serve_mod = serve_mod
        self.rows, self.kept = None, []

    def take(self, logits):
        if self.rows is not None:
            self.kept.append(logits[self.rows, -1])

    def __enter__(self):
        mod = self.serve_mod
        self.saved = (mod.make_prefill_step, mod.make_serve_step)
        make_prefill, make_serve = self.saved

        def make_prefill_step(model, cache_len):
            step = make_prefill(model, cache_len)

            def prefill_step(params, batch):
                logits, caches = step(params, batch)
                self.take(logits)
                return logits, caches
            return prefill_step

        def make_serve_step(model):
            step = make_serve(model)

            def serve_step(params, caches, batch):
                tok, caches, logits = step(params, caches, batch)
                self.take(logits)
                return tok, caches, logits
            return serve_step

        mod.make_prefill_step, mod.make_serve_step = make_prefill_step, make_serve_step
        return self

    def __exit__(self, *exc):
        self.serve_mod.make_prefill_step, self.serve_mod.make_serve_step = self.saved


class Session:
    """A cell's configuration, weights and traffic for one seed on one
    device, with the step factories wrapped (`_Keep`) until `close`."""

    def __init__(self, bench: Bench, cell: str, seed: int, device, rows_per_call=None):
        import repro_torch.launch.serve as serve_mod
        from repro_torch.models.registry import build

        entry = bench.cell(cell)
        self.bench, self.cell, self.seed = bench, cell, seed
        self.device = torch.device(device)
        self.config = bench.data("configs", entry["config"])
        self.mix = bench.data("traffic", entry["traffic"])
        self.workload = bench.data("workloads", cell)
        for key in ("config", "traffic"):
            if self.workload[key] != entry[key]:
                raise ValueError(f"workloads/{cell}.json names {key} {self.workload[key]!r}, "
                                 f"BENCHMARK.json {entry[key]!r}")
        self.model = self.config["model"]
        self.cfg = port_config(self.config)
        self.reference = bench.module("reference", self.config["arch"])
        self.flops = bench.module("flops", self.config["arch"])
        driver = bench.module("traffic", self.mix["driver"])
        self.traffic = driver.Traffic(self.mix, self.model, seed, self.device, self.cfg.cdtype)
        self.rows_per_call = min(self.traffic.batch,
                                 rows_per_call or self.workload["check"]["rows_per_call"])
        self.params = draw_weights(self.reference.weights(self.model), seed, self.device,
                                   self.cfg.pdtype)
        check_tree(self.params, build(self.cfg).metas())
        self.serve = serve_mod.serve
        self.keep = _Keep(serve_mod).__enter__()

    def close(self):
        self.keep.__exit__(None, None, None)

    def call(self, i: int) -> Call:
        prompt, memory = self.traffic.inputs(i)
        rows = sorted(random.Random(f"portbench-rows:{self.seed}:{i}").sample(
            range(self.traffic.batch), self.rows_per_call))
        self.keep.rows = torch.tensor(rows, device=self.device)
        self.keep.kept = []
        start = time.perf_counter()
        r = self.serve(self.cfg, self.params, prompt, self.traffic.new_tokens, self.device,
                       memory=memory)
        end = time.perf_counter()
        return Call(i, start, end, r["prefill_ms"], r["decode_ms_per_token"], r["tokens"],
                    r["finite"], rows, torch.stack(self.keep.kept, dim=1))


@dataclass
class Run:
    """What the metric readers read."""

    session: Session
    calls: list
    window_s: float
    setup_s: float
    peak: dict | None  # this device's row of peaks.json
    trace: dict | None = None  # tracing.summarize of the traced calls, plus "calls"
    extra: dict | None = None  # what the instruments recorded

    @property
    def traffic(self):
        return self.session.traffic


def device_peak(bench: Bench, name: str) -> dict | None:
    peaks = json.loads((bench.dir / "peaks.json").read_text())["devices"]
    return next((row for key, row in peaks.items() if key in name), None)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unread ({exc.__class__.__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unread"


def run_cell(bench: Bench, cell: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float | None = None) -> dict:
    """One run: the result line's object, ``checks`` last."""
    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    session = Session(bench, cell, seed, dev)
    try:
        return _run(bench, session, seconds, trace, t0)
    finally:
        session.close()


def _run(bench: Bench, session: Session, seconds: float, trace: bool, t0: float) -> dict:
    cuda = session.device.type == "cuda"
    metrics = [(m, bench.module("metrics", m["name"])) for m in bench.metrics(session.cell, trace)]
    session.call(-1)  # warm-up: every shape of the cell's calls
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    extra = {}
    with contextlib.ExitStack() as stack:
        if trace and cuda:
            for _, mod in metrics:
                if hasattr(mod, "instrument"):
                    stack.enter_context(mod.instrument(extra))
        setup_s = time.perf_counter() - t0
        calls, window_s = session.traffic.drive(session.call, seconds)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    run = Run(session, calls, window_s, setup_s, device_peak(bench, name), extra=extra)
    device = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
              "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile

        first = len(calls)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced, traced_s = session.traffic.drive(lambda j: session.call(first + j),
                                                     TRACE_SECONDS)
        run.trace = tracing.summarize(tracing.device_intervals(prof))
        del prof
        if run.trace is None:
            raise RuntimeError("the profiler's trace holds no device operation")
        run.trace.update(calls=len(traced), host_s=traced_s)
        device.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        breakdown = {"device_ops": tracing.top(run.trace["ops"]),
                     "idle_gaps": tracing.top(run.trace["gaps"])}
        del traced
    values = {}
    for spec, mod in metrics:
        v = mod.read(run)
        if v is not None:
            values[spec["name"]] = {"value": float(v), "unit": spec["unit"]}
    if cuda:
        torch.cuda.empty_cache()
    check = session.workload["check"]
    t_check = time.perf_counter()
    got = compare.readings(session, calls, check["requests"], check["ref_batch"])
    failed = sum(session.traffic.batch for c in calls if not c.finite)
    checks = {k: {"value": got[k], "limit": limit} for k, limit in check["limits"].items()}
    checks["failed_requests"] = {"value": failed, "limit": 0}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(calls) * session.traffic.batch,
        "failed": failed,
        "metrics": values,
        "device": device,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["notes"] = {"calls": len(calls), "window_s": window_s,
                       "check_s": time.perf_counter() - t_check,
                       "requests_checked": got["requests"], "positions_checked": got["positions"],
                       "token_gap": got["token_gap"]}
    if run.trace:
        result["notes"].update(traced_calls=run.trace["calls"], traced_host_s=run.trace["host_s"])
    result["checks"] = checks  # last, as the numbers compared beside their limits
    return result
