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
ran. The JAX
package's `collective_bytes_from_hlo` has no counterpart yet: it is the
next and last module to port (ROADMAP §1 item 5).
"""
from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

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


def extrapolate_depth(c1: float, c2: float, n_groups: int) -> float:
    """Linear in depth: total(G) = c1 + (G-1)*(c2-c1)."""
    return c1 + (n_groups - 1) * (c2 - c1)


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   chips: int) -> dict:
    t_compute = flops / (chips * PEAK_FLOPS_BF16)
    t_memory = hbm_bytes / (chips * HBM_BW)
    t_collective = collective_bytes / (chips * NVLINK_BW)
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
