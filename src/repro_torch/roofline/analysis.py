"""Roofline terms and serving-stage bounds (the arithmetic part of the JAX
package's `roofline/analysis.py`), against an H100's data-sheet peaks
(`launch/mesh.py`):

    compute    = FLOPs / (chips * peak bf16 FLOP/s)
    memory     = HBM bytes / (chips * HBM bytes/s)
    collective = collective bytes / (chips * NVLink bytes/s)

The FLOPs and bytes come from `roofline.analytic`.

`trace_facts` is the counterpart of the JAX package's `hlo_facts`, which
reads a compiled XLA program's memory and cost analysis: it runs a step
function on meta tensors (`torch.device("meta")`: shapes and dtypes, no
storage, no card) under `MetaTrace` and reads the argument bytes, the
peak of the storage bytes live at once, and the FLOPs of the products it
ran.

The collective term's bytes: `collective_bytes_from_hlo` is the JAX
package's parser of a compiled XLA program's text, copied as it is. The
port compiles no HLO of its own; the parser is kept to read XLA dumps and
as the definition of what is counted: each collective's result bytes, a
loop body's collectives counted trip-count times. Its counterpart,
`collective_bytes_from_trace`, runs a step on DTensors over a fake
process group (`launch.mesh.fake_mesh`) under `CollectiveTrace` and
counts, by the same five kinds and the same convention, every collective
that PyTorch's partitioner issues, each time it is issued.
"""
from __future__ import annotations

import math
import re
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.launch.mesh import (GPUS_PER_NODE, HBM_BW, IB_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16)

# the CUDA caching allocator rounds every block up to 512 bytes, and
# torch.cuda.max_memory_allocated counts the rounded blocks
ALLOC_GRANULE = 512


def _tensors(obj, out: list, seen: set) -> list:
    """Every tensor reachable from ``obj`` through dicts, sequences and
    object attributes."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif id(obj) in seen:
        pass
    elif isinstance(obj, dict):
        seen.add(id(obj))
        for v in obj.values():
            _tensors(v, out, seen)
    elif isinstance(obj, (list, tuple)):
        seen.add(id(obj))
        for v in obj:
            _tensors(v, out, seen)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        seen.add(id(obj))
        _tensors(vars(obj), out, seen)
    return out


def _blocks(nbytes: int) -> int:
    return -(-nbytes // ALLOC_GRANULE) * ALLOC_GRANULE


def _sig(x):
    """A hashable key of an operation's argument: a tensor's shape,
    strides, dtype and device; a scalar with its type (1 and 1.0 promote
    differently); sequences element by element."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in sorted(x.items()))
    hash(x)  # raises on what cannot key the cache (a generator)
    return (type(x), x)


class MetaTrace(TorchDispatchMode):
    """What a run of meta-tensor operations would hold and do on a card.

    Storage bytes live at once: every tensor an operation returns adds its
    storage (a view of a storage already counted adds nothing), and the
    storage's bytes are taken back when the storage is freed (a weak
    reference's callback). ``track`` adds tensors that exist before the
    run (the arguments). Each storage counts its bytes rounded up to
    `ALLOC_GRANULE`.

    A kernel that allocates a temporary inside one operation, which the
    meta kernel does not, adds it for the operation's span (`HIDDEN`):
    ATen's logsumexp (a composite on every device) takes the max, then
    sums exp of (x - max) in one x-sized buffer.

    FLOPs: each operation that `torch.utils.flop_counter.flop_registry`
    prices (the matrix products, convolutions, fused attention) adds its
    count, as `FlopCounterMode` would.

    Most meta kernels are Python, tens of microseconds an operation, and
    a chunked scan runs a million of them at 32,768 tokens. So an
    operation whose outputs are fresh tensors (its schema aliases
    nothing, and its first run returned no storage of its inputs) is run
    once per distinct signature of its arguments (`_sig`); later calls
    get empty tensors of the recorded shapes, strides and dtypes."""

    def __init__(self):
        super().__init__()
        self.live: dict = {}
        self.refs: dict = {}
        self.results: dict = {}  # signature -> (output metadata, FLOPs)
        self.now = self.peak = self.ops = self.flops = 0

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = _blocks(st.nbytes())
        self.live[key] = n
        self.now += n
        self.peak = max(self.peak, self.now)

        def freed(_, key=key):
            self.now -= self.live.pop(key)
            self.refs.pop(key, None)

        self.refs[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        key = None
        if _functional(func):
            try:
                key = (func, _sig(args), _sig(kwargs))
            except TypeError:
                key = None
        hit = self.results.get(key) if key is not None else None
        if hit is not None:
            metas, flops = hit
            out = tuple(torch.empty_strided(shape, stride, dtype=dtype, device=META)
                        for shape, stride, dtype in metas)
            out = out[0] if len(out) == 1 else out
        else:
            out = func(*args, **kwargs)
            flops = (flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
                     if func.overloadpacket in flop_registry else 0)
            if key is not None and _fresh(args, kwargs, out):
                outs = out if isinstance(out, tuple) else (out,)
                self.results[key] = (tuple((t.shape, t.stride(), t.dtype) for t in outs),
                                     flops)
        self.flops += flops
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        if func in HIDDEN:
            extra = sum(_blocks(n) for n in HIDDEN[func](*args))
            self.peak = max(self.peak, self.now + extra)
        return out


def _logsumexp_temps(x, dims, keepdim=False):
    """ATen's logsumexp: the max over ``dims`` (kept) and the x-sized
    buffer of exp(x - max)."""
    dims = [d % x.dim() for d in dims] or list(range(x.dim()))
    kept = [1 if i in dims else n for i, n in enumerate(x.shape)]
    return [math.prod(kept) * x.element_size(), x.numel() * x.element_size()]


HIDDEN = {torch.ops.aten.logsumexp.default: _logsumexp_temps}
META = torch.device("meta")
_FUNCTIONAL: dict = {}


def _functional(func) -> bool:
    """Whether ``func``'s schema returns only fresh tensors: no argument or
    return aliases, every return a Tensor."""
    ok = _FUNCTIONAL.get(func)
    if ok is None:
        s = func._schema
        ok = (bool(s.returns) and all(str(r.type) == "Tensor" and r.alias_info is None
                                      for r in s.returns)
              and all(a.alias_info is None for a in s.arguments))
        _FUNCTIONAL[func] = ok
    return ok


def _fresh(args, kwargs, out) -> bool:
    """Whether every output is a meta tensor on a storage of its own (none
    of the inputs')."""
    outs = out if isinstance(out, tuple) else (out,)
    ins = {t.untyped_storage()._cdata for t in tree_leaves((args, kwargs))
           if isinstance(t, torch.Tensor)}
    return all(isinstance(t, torch.Tensor) and t.device.type == "meta"
               and t.storage_offset() == 0 and t.untyped_storage()._cdata not in ins
               for t in outs)


def trace_facts(fn, *args) -> dict:
    """Run ``fn(*args)`` on meta tensors and read what it would hold and
    do on a card (`MetaTrace`): ``arg_bytes`` (the storages reachable from
    the arguments), ``peak_bytes`` (the most storage bytes live at once,
    arguments included, views of one storage counted once),
    ``traced_flops`` (the products `FlopCounterMode` would count, plus the
    flash-attention kernel's own count, `kernels.flash_attention.ops.
    meta_flops`), ``ops`` (operations run) and ``out`` (what ``fn``
    returned). Every tensor argument must be on the meta device."""
    held = _tensors(args, [], set())
    bad = {str(t.device) for t in held if t.device.type != "meta"}
    if bad:
        raise ValueError(f"trace_facts runs on meta tensors, got {sorted(bad)}")
    attn0 = attn_ops.meta_flops
    trace = MetaTrace()
    for t in held:
        trace.track(t)
    arg_bytes = trace.now
    del held
    with trace:
        out = fn(*args)
    return {"arg_bytes": arg_bytes, "peak_bytes": trace.peak,
            "traced_flops": trace.flops + attn_ops.meta_flops - attn0,
            "ops": trace.ops, "out": out}


# ---------------------------------------------------------------------------
# collective bytes: XLA's HLO text (the JAX package's parser, as it is) and
# the port's own traced step
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(dt: str, dims: str) -> int:
    if dt not in _DTYPE_BYTES:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dt]


def _line_collective(stripped: str):
    """(kind, bytes) for a collective-op HLO line, else None."""
    for kind in _COLLECTIVES:
        if f" {kind}(" in stripped or f" {kind}-start(" in stripped:
            eq = stripped.find("=")
            if eq < 0:
                return None
            rhs = stripped[eq + 1 :]
            shapes = _SHAPE_RE.findall(rhs.split(kind)[0])
            return kind, sum(_shape_bytes(dt, dims) for dt, dims in shapes)
    return None


_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->")
_WHILE_RE = re.compile(r"while\(.*?\), condition=%?([\w.\-]+), body=%?([\w.\-]+)")
_CONST_RE = re.compile(r"constant\((\d+)\)")


def _parse_computations(hlo_text: str) -> dict:
    """comp name -> list of body lines."""
    comps: dict = {}
    cur = None
    for line in hlo_text.splitlines():
        if not line.startswith(" ") and ("->" in line) and line.rstrip().endswith("{"):
            m = _COMP_RE.match(line.strip())
            if m:
                cur = m.group(1)
                comps[cur] = []
                continue
        if line.startswith("}"):
            cur = None
            continue
        if cur is not None:
            comps[cur].append(line.strip())
    return comps


def collective_bytes_from_hlo(hlo_text: str) -> dict:
    """Collective result bytes, scan-aware: collectives inside a while-loop
    body count once per iteration (trip count = the loop-condition constant).
    HLO cost analysis can't do this (it visits loop bodies once); GSPMD keeps
    our FSDP all-gathers inside the layer scan, so the multiplier matters.

    The port has no HLO of its own: this is the JAX package's parser, kept
    to read XLA dumps and as the definition of what is counted, each
    collective's result bytes, loop bodies counted trip-count times
    (`collective_bytes_from_trace` is the port's counterpart)."""
    comps = _parse_computations(hlo_text)
    own = {}
    whiles = {}  # comp -> list[(cond, body)]
    for name, lines in comps.items():
        totals = {k: 0 for k in _COLLECTIVES}
        counts = {k: 0 for k in _COLLECTIVES}
        wl = []
        for ln in lines:
            got = _line_collective(ln)
            if got:
                totals[got[0]] += got[1]
                counts[got[0]] += 1
            m = _WHILE_RE.search(ln)
            if m:
                wl.append((m.group(1), m.group(2)))
        own[name] = (totals, counts)
        whiles[name] = wl

    def trip_count(cond: str) -> int:
        consts = [int(c) for ln in comps.get(cond, []) for c in _CONST_RE.findall(ln)]
        return max(consts) if consts else 1

    import functools

    @functools.lru_cache(maxsize=None)
    def total(name: str):
        t = dict(own[name][0])
        c = dict(own[name][1])
        for cond, body in whiles.get(name, []):
            n = trip_count(cond)
            bt, bc = total(body)
            for k in _COLLECTIVES:
                t[k] += n * bt[k]
                c[k] += n * bc[k]
        return t, c

    entry = None
    for line in hlo_text.splitlines():
        if line.startswith("ENTRY"):
            m = _COMP_RE.match(line.strip()[len("ENTRY "):].strip())
            if m:
                entry = m.group(1)
            break
    if entry is None:  # fall back: flat count
        entry = max(comps, key=lambda n: len(comps[n])) if comps else None
    if entry is None:
        z = {k: 0 for k in _COLLECTIVES}
        return {"totals": z, "counts": z, "sum": 0}
    totals, counts = total(entry)
    return {"totals": totals, "counts": counts, "sum": int(sum(totals.values()))}


# PyTorch's collectives by operator name, as DTensor and functional
# collectives issue them, mapped to the HLO kinds above (point-to-point
# sends and receives are XLA's collective-permutes); "" marks an operator
# of those namespaces that moves nothing (a wait, an autograd wrapper, a
# group lookup). Any other operator of these namespaces (a broadcast, a
# c10d op) raises.
COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
                         "_dtensor")
TORCH_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "isend": "collective-permute",
    "irecv": "collective-permute",
    "batch_p2p_ops": "collective-permute",
    "wait_tensor": "",
    "_wrap_tensor_autograd": "",
    "mesh_get_process_group": "",
}


def collective_kind(func) -> str | None:
    """The HLO kind of a PyTorch collective operator (`TORCH_COLLECTIVES`),
    "" for one that moves nothing, None for an operator outside the
    collective namespaces. An unknown operator of those namespaces
    raises: no collective is dropped."""
    if func.namespace not in COLLECTIVE_NAMESPACES:
        return None
    name = func._schema.name.split("::")[-1]
    if name not in TORCH_COLLECTIVES:
        raise NotImplementedError(f"unknown collective {func}: no kind to count it by")
    return TORCH_COLLECTIVES[name]


def _group_name(func, args, kwargs) -> str:
    """The name of the process group a collective operator runs over (its
    ``group_name`` argument, a name or a group)."""
    for i, a in enumerate(func._schema.arguments):
        if a.name == "group_name":
            g = kwargs["group_name"] if "group_name" in kwargs else args[i]
            return g if isinstance(g, str) else g.group_name
    raise NotImplementedError(f"{func} names no process group")


class CollectiveTrace(MetaTrace):
    """`MetaTrace` over a step that runs on DTensors: each DTensor
    operation is handed back to DTensor (``NotImplemented``), which
    redistributes its operands with collectives and runs the operation on
    the local shards; this mode then sees the local operations and the
    collectives. ``totals`` and ``counts`` hold, by `_COLLECTIVES` kind,
    the result bytes (one rank's, as XLA's HLO states them) and the
    number of every collective issued (`collective_kind`); ``by_group``
    the result bytes by the name of the process group each ran over;
    ``issued`` lists them in order as (operator, kind, bytes). The local
    operations are what `MetaTrace` makes of them: ``peak`` is then one
    rank's."""

    def __init__(self):
        super().__init__()
        self.totals = {k: 0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}
        self.by_group: dict = {}
        self.issued: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kind = collective_kind(func)
        if kind is None:
            return super().__torch_dispatch__(func, types, args, kwargs)
        self.ops += 1
        out = func(*args, **(kwargs or {}))
        if kind:
            nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor))
            self.totals[kind] += nbytes
            self.counts[kind] += 1
            group = _group_name(func, args, kwargs or {})
            self.by_group[group] = self.by_group.get(group, 0) + nbytes
            self.issued.append((str(func), kind, nbytes))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out

    def result(self) -> dict:
        """`collective_bytes_from_hlo`'s dict: ``totals``, ``counts`` and
        their ``sum`` of bytes."""
        return {"totals": dict(self.totals), "counts": dict(self.counts),
                "sum": int(sum(self.totals.values()))}


def collective_bytes_from_trace(fn, *args) -> dict:
    """Run ``fn(*args)``, a step on DTensors whose local shards are meta
    tensors, under `CollectiveTrace` and return its collectives as
    `collective_bytes_from_hlo` returns XLA's: ``{"totals", "counts",
    "sum"}``, result bytes by kind, counted each time a collective is
    issued."""
    trace = CollectiveTrace()
    with trace:
        fn(*args)
    return trace.result()


def extrapolate_depth(c1: float, c2: float, n_groups: int) -> float:
    """Linear in depth: total(G) = c1 + (G-1)*(c2-c1)."""
    return c1 + (n_groups - 1) * (c2 - c1)


def collective_seconds(nbytes: float, ranks) -> float:
    """The least time in which one device of the process group ``ranks``
    (global ranks; a mesh's ranks fill nodes of `GPUS_PER_NODE` cards in
    order) takes in ``nbytes`` of collective result bytes: at one card's
    NVLink rate, or, where the group spans k > 1 nodes with g of its
    cards on each, the (k - 1) / k of the bytes that lie on other nodes
    coming in over the g InfiniBand ports (`IB_BW` each) that its node's
    members share, whichever is slower. A group of one card on each of
    its nodes is bound by the port; 16 consecutive ranks over two nodes
    by NVLink."""
    ranks = list(ranks)
    k = len({r // GPUS_PER_NODE for r in ranks})
    t = nbytes / NVLINK_BW
    if k > 1:
        t = max(t, nbytes * (k - 1) / (k * (len(ranks) / k) * IB_BW))
    return t


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   chips: int, *, collective_s: float | None = None) -> dict:
    """The step's lower bounds at the data sheet's peaks: ``flops`` and
    ``hbm_bytes`` are the whole step's over ``chips`` cards, so each is
    priced at ``chips`` cards' rate; ``collective_bytes`` are one
    device's (as XLA's per-device HLO and `CollectiveTrace` count them),
    so they are priced at one card's link rate: ``collective_s`` where
    the caller priced them by the links each group crosses
    (`collective_seconds`), else one card's NVLink rate. (The JAX
    package divides one device's collective bytes by ``chips`` again:
    ROADMAP F19.)"""
    t_compute = flops / (chips * PEAK_FLOPS_BF16)
    t_memory = hbm_bytes / (chips * HBM_BW)
    t_collective = (collective_bytes / NVLINK_BW if collective_s is None
                    else collective_s)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_collective}
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "bottleneck": max(terms, key=terms.get),
        "step_time_lb_s": max(terms.values()),
    }


# ---------------------------------------------------------------------------
# serving hot-path kernel bounds (masked Adam, K1; top-k threshold, K2)
# ---------------------------------------------------------------------------


def adam_step_hbm_bytes(n_params: int, *, param_bytes: int = 4) -> int:
    """Analytic minimum HBM traffic of ONE masked-Adam step over
    ``n_params`` coordinates: read p/g/m/v + bool mask, write p/m/v/u —
    every buffer touched exactly once (what the fused masked-Adam kernel,
    `csrc/masked_adam.cu`, streams; 33 B/param for f32 params). Multiply by B sessions and K
    iterations for a fused phase's optimizer-update term."""
    return int(n_params) * (25 + 2 * param_bytes)


def topk_hbm_bytes(n_coords: int, *, passes: int = 1) -> int:
    """Analytic HBM traffic of one session's bit-pattern top-k selection:
    ``passes`` reads of the 4-byte |u| buffer plus the 1-byte mask write.
    ``passes=1`` is the bound; the port's radix select
    (`csrc/topk_mask.cu`) reads |u| once per digit (``passes=3``)."""
    return int(n_coords) * (4 * passes + 1)


def kernel_roofline_fraction(nbytes: int, measured_s: float,
                             *, chips: int = 1) -> float | None:
    """Achieved fraction of the HBM roofline: the analytic memory-bound
    time for ``nbytes`` of traffic over the measured wall-clock. 1.0 means
    the launch ran at memory-bandwidth speed; the gap is launch overhead,
    compute, or wasted re-reads."""
    if not measured_s or measured_s <= 0:
        return None
    return (nbytes / (chips * HBM_BW)) / measured_s


def serving_stage_report(drift: dict) -> dict:
    """Roofline-style summary of the serving pipeline's *measured* stage
    timings, consuming a `repro_torch.serving.obs.drift_report` dict.

    Where `roofline_terms` ranks analytic lower bounds, this ranks the
    stages the fused serving path actually ran (steady-state wall-clock,
    compile excluded) and reports each stage's model efficiency — modeled
    seconds / measured seconds, the fraction of `GPUCostModel`'s price the
    real stacked executables achieve. ``bottleneck`` is the stage eating
    the most measured steady time; a low ``model_efficiency`` there is
    where re-pricing (or a faster kernel) pays first.

    Stages whose timing hooks recorded analytic byte traffic (``nbytes`` —
    the masked-Adam and top-k bounds above) additionally report
    ``roofline_fraction``: measured steady wall-clock against the
    memory-bound time for those bytes (`kernel_roofline_fraction`)."""
    stages = {}
    for stage, e in sorted(drift.items()):
        meas, mod = e["measured_steady_s"], e["modeled_steady_s"]
        nbytes = int(e.get("nbytes", 0))
        stages[stage] = {
            "measured_s": meas,
            "modeled_s": mod,
            "compile_s": e["compile_s"],
            "calls": e["calls"],
            "model_efficiency": (mod / meas) if meas > 0 else None,
            "nbytes": nbytes,
            "roofline_fraction": (kernel_roofline_fraction(nbytes, meas)
                                  if nbytes else None),
        }
    measured = {k: v["measured_s"] for k, v in stages.items()}
    return {
        "stages": stages,
        "bottleneck": (max(measured, key=measured.get) if measured else None),
        "measured_total_s": sum(measured.values()),
    }
