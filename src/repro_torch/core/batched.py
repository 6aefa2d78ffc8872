"""Fused cross-session training: B sessions' phases as one stacked lifecycle.

Every AMS session of a task shares one parameter-tree structure (the
student), so B co-resident sessions' training phases need not be B
separate K-iteration loops: stack their ``(params, opt_state, mask,
replay batches)`` along a leading session axis, run the K iterations of a
`torch.func.vmap`-ed loss/grad followed by ONE fused masked-Adam launch
per param dtype over the whole stack per iteration (momentum SGD, which
has no kernel, is a `vmap` of the plain `momentum_update`), then select
the next phase's masks with one stacked top-k launch and encode the B
wire deltas with one device-to-host pull.

`vmap` keeps each session's maths its own: the student's folded-norm
statistics are taken over one session's batch, never over the stack
(folding B into the convolution batch axis would change them).

The K loop keeps Adam's inputs in the kernel's flat layout: params,
moments and mask are flattened into ``(B, rows, 128)`` buffers once per
phase (`kernels.stacking.flatten_tree`), the loss/grad reads the params
as views into the flat params buffer, each iteration flattens only the
gradients (`kernels.masked_adam.ops.masked_adam_flat`), and the new
params, state and last update are unflattened once, after the loop. It
is bitwise equal to K calls of the tree step `masked_adam_stacked`.

Execution shape, as in the JAX package (`set_exec_mode`):

* ``"loop"``: the K iterations run eagerly from Python, as K dispatches
  of the vmapped step (the JAX package's ``"loop"``);
* ``"graph"``: the whole K loop captured once per compile key into a
  `torch.cuda.CUDAGraph` and replayed per phase, so the host issues one
  launch for the phase: the port's counterpart of the JAX package's
  ``"scan"`` (K iterations inside one ``lax.scan`` launch). CUDA only;
* ``"auto"`` (the default): the first call per compile key on a CUDA
  device races both shapes on the caller's real batch (one warm run,
  then the best of 2, ties broken lexically), records the winner and
  both times, and caches only the winner. On a CPU device the only shape
  is ``"loop"``, recorded without a race.

Phase runners are cached at module level per compile key (loss callable,
stacked shapes and dtypes, K, optimizer and its hyperparameters, device)
plus the resolved shape; `cache_info` counts hits and misses (a race is
one miss). The graphs of one device share one memory pool: the engine
replays one group at a time, and each replay's outputs are cloned out of
the graph's memory before anything else runs.

A singleton group runs the sequential `AMSSession._run_phase_prepared`
loop, as in the JAX package.

Sharded execution (`train_phases_sharded`): D co-resident groups, one per
granted pool slot, each on its slot's card. Every group is staged first
(stacked, placed, its selection run and its batches copied to its card),
then every group is launched, with nothing in between that waits for a
card, and one waiter thread per group timestamps its own completion. On D
cards the D lifecycles run at once; on one card they queue on it, and the
results are the same bits either way.

Observability: `update_pipeline_info` counts the stacked selections and
batched encodes and the sessions they covered, `exec_info` the loop runs,
graph captures, graph replays and warm-up iterations, and the K
iterations of a stacked group are timed as stage ``train_fused``
(`core.timing`) under key ``(B, K)``; a call that missed the cache (the
race, a capture, cuDNN's first algorithm choice) lands in the first-call
bucket.
"""
from __future__ import annotations

import functools
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Hashable

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import selection, timing
from repro_torch.core.delta import encode_delta_stack
from repro_torch.core.masked_adam import momentum_update
from repro_torch.device import host_to_device, resolve_device
from repro_torch.kernels import stacking
from repro_torch.kernels.masked_adam import ops as adam_ops

# ---------------------------------------------------------------------------
# struct-of-arrays stack / unstack
# ---------------------------------------------------------------------------


def stack_trees(trees: list):
    """Stack B same-structure trees along a new leading session axis."""
    if not trees:
        raise ValueError("stack_trees needs at least one tree")
    return tree.tree_map(lambda *ls: torch.stack(ls), *trees)


def unstack_tree(t, n: int) -> list:
    """Inverse of `stack_trees`: split the leading axis back into B trees
    (views into the stacked leaves)."""
    return [tree.tree_map(lambda l: l[i], t) for i in range(n)]


# ---------------------------------------------------------------------------
# module-level cache of phase runners, and the execution shape
# ---------------------------------------------------------------------------

_PHASE_CACHE: dict = {}
_HITS = 0
_MISSES = 0

_EXEC_MODE = "auto"  # "auto" | "graph" | "loop"
# measured winners: (backend, base key) -> "graph" | "loop"; each settled
# by one race on the first real call (or "loop" without a race off CUDA)
_AUTO_MODES: dict = {}
# (backend, base key) -> {"winner", "graph_s", "loop_s"}: each race's times
_RACES: dict = {}
# device -> the memory pool its phase graphs share
_POOLS: dict = {}
# what ran: eager K loops, graph captures and replays, and the one-step
# warm-ups before each capture (K1 launches once in each, under Adam)
_EXEC_STATS = {"loop_runs": 0, "graph_captures": 0, "graph_replays": 0,
               "warm_iters": 0}


def set_exec_mode(mode: str) -> None:
    """Force the phase's execution shape: ``graph`` (the K loop captured
    once into a CUDA graph and replayed, the JAX package's ``scan``),
    ``loop`` (K eager dispatches of the vmapped step), or ``auto`` (the
    first fused call per compile key races both and keeps the measured
    winner; ``loop`` without a race off CUDA). Cached runners of the other
    shape are kept; the key includes the resolved shape. A ``graph`` call
    on a CPU group raises."""
    if mode not in ("auto", "graph", "loop"):
        raise ValueError(f"exec mode must be auto|graph|loop, got {mode!r}")
    global _EXEC_MODE
    _EXEC_MODE = mode


def auto_mode_info() -> dict:
    """The auto decisions: {(backend, compile key): "graph"|"loop"}. Empty
    until an ``auto``-mode fused call has settled a key."""
    return dict(_AUTO_MODES)


def race_info() -> dict:
    """Each race's outcome: {(backend, compile key): {"winner", "graph_s",
    "loop_s"}}, the times the best of 2 timed runs of each shape."""
    return {k: dict(v) for k, v in _RACES.items()}


def exec_info() -> dict:
    """Counters of what ran: eager K loops (``loop_runs``), graph
    captures and replays, and the one-iteration warm-ups before each
    capture (``warm_iters``). Under Adam, K1 launches K times per loop run
    and per replay and once per warm-up."""
    return dict(_EXEC_STATS)


def cache_info() -> dict:
    """How often did sessions share a phase runner?"""
    return {"size": len(_PHASE_CACHE), "hits": _HITS, "misses": _MISSES}


def cache_clear() -> None:
    """Drop every cached runner and auto decision, and with them the CUDA
    graphs, their static buffers and their pools' memory."""
    global _HITS, _MISSES
    graphs = any(isinstance(fn, _GraphPhase) for fn in _PHASE_CACHE.values())
    _PHASE_CACHE.clear()
    _AUTO_MODES.clear()
    _RACES.clear()
    _POOLS.clear()
    _HITS = _MISSES = 0
    if graphs:
        torch.cuda.empty_cache()


class _Phase:
    """The K loop of one compile key, run eagerly: the ``loop`` shape, and
    the body that the ``graph`` shape captures.

    ``prepare`` lays the phase's inputs out for the loop (under Adam:
    params, moments and mask flattened once into ``(B, rows, 128)``
    buffers), ``run`` is the K loop over them, ``finish`` turns its
    outputs back into ``(params, opt_state, u, losses)`` trees (views into
    the flat buffers; nothing is copied back)."""

    def __init__(self, loss_and_grad, optimizer: str, lr: float, b1: float,
                 b2: float, eps: float, momentum: float):
        self.vgrad = torch.func.vmap(loss_and_grad)
        self.adam = optimizer == "adam"
        if self.adam:
            self.step = functools.partial(adam_ops.masked_adam_flat, lr=lr,
                                          b1=b1, b2=b2, eps=eps)
        else:  # momentum SGD has no kernel: its vmapped tree form
            self.step = torch.func.vmap(functools.partial(
                momentum_update, lr=lr, momentum=momentum))
        self.plan = self.state_type = None

    def prepare(self, params, opt, mask, frames, labels) -> tuple:
        if not self.adam:
            return params, opt, mask, frames, labels
        self.plan = stacking.stack_plan(params)
        self.state_type = type(opt)
        return (*(stacking.flatten_tree(t, self.plan)
                  for t in (params, opt.m, opt.v, mask)),
                opt.count, frames, labels)

    def run(self, *inputs) -> tuple:
        if not self.adam:
            params, opt, mask, frames, labels = inputs
            u = losses = None
            for k in range(frames.shape[0]):
                losses, grads = self.vgrad(params, frames[k], labels[k])
                params, opt, u = self.step(params, grads, opt, mask)
            return params, opt, u, losses
        p, m, v, mask, count, frames, labels = inputs
        u = losses = None
        for k in range(frames.shape[0]):
            losses, grads = self.vgrad(stacking.unflatten_tree(p, self.plan),
                                       frames[k], labels[k])
            p, m, v, u, count = self.step(p, grads, m, v, mask, count,
                                          self.plan)
        return p, m, v, u, count, losses

    def finish(self, out) -> tuple:
        if not self.adam:
            return out
        p, m, v, u, count, losses = out
        trees = [stacking.unflatten_tree(b, self.plan) for b in (p, m, v, u)]
        return (trees[0], self.state_type(trees[1], trees[2], count),
                trees[3], losses)

    def __call__(self, params, opt, mask, frames, labels):
        _EXEC_STATS["loop_runs"] += 1
        return self.finish(self.run(*self.prepare(params, opt, mask, frames,
                                                  labels)))


class _GraphPhase:
    """The ``graph`` shape: `_Phase.run`'s whole K loop captured into one
    `torch.cuda.CUDAGraph` at the first call, after a one-iteration warm-up
    on a side stream (cuDNN's workspaces, autograd's lazy state), and
    replayed at every call with that call's inputs copied into the
    graph's static buffers. The port's counterpart of the JAX package's
    ``lax.scan`` shape.

    A capture that fails raises; nothing falls back to the eager loop.
    K1's launch counter counts at capture, where nothing runs, so the
    captured launches are taken back then and added at every replay."""

    def __init__(self, phase: _Phase, pool):
        self.phase, self.pool = phase, pool
        self.graph = self.static = self.out = None
        self.k1_launches = 0

    def _capture(self, inputs, dev) -> None:
        self.static = tree.tree_map(torch.clone, inputs)
        *head, frames, labels = self.static
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.phase.run(*head, frames[:1], labels[:1])
        torch.cuda.current_stream(dev).wait_stream(side)
        _EXEC_STATS["warm_iters"] += 1
        graph = torch.cuda.CUDAGraph()
        n0 = adam_ops.launches
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self.out = self.phase.run(*self.static)
        finally:
            self.k1_launches = adam_ops.launches - n0
            adam_ops.launches = n0
        self.graph = graph
        _EXEC_STATS["graph_captures"] += 1

    def capture(self, params, opt, mask, frames, labels) -> None:
        """Capture the graph now if it has none, without replaying it:
        the warm-up and the capture wait for the card, so a caller that
        must not wait between launches captures before them."""
        if self.graph is None:
            dev = frames.device
            with torch.cuda.device(dev):
                self._capture(self.phase.prepare(params, opt, mask, frames,
                                                 labels), dev)

    def __call__(self, params, opt, mask, frames, labels):
        inputs = self.phase.prepare(params, opt, mask, frames, labels)
        dev = frames.device
        with torch.cuda.device(dev):
            if self.graph is None:
                self._capture(inputs, dev)
            else:
                for dst, src in zip(tree.leaves(self.static),
                                    tree.leaves(inputs)):
                    dst.copy_(src)
            self.graph.replay()
            adam_ops.launches += self.k1_launches
            _EXEC_STATS["graph_replays"] += 1
            # the outputs live in the graph's pool, which the next replay
            # of this graph or of another one on the device overwrites
            out = tree.tree_map(torch.clone, self.out)
        return self.phase.finish(out)


def _pool(device):
    pool = _POOLS.get(device)
    if pool is None:
        pool = _POOLS[device] = torch.cuda.graph_pool_handle()
    return pool


def _timed_best(fn, args):
    timing.block(fn(*args))  # warm-up (a graph's capture), off the clock
    best, out = float("inf"), None
    for _ in range(2):  # best of 2: damp scheduler and GC jitter
        t0 = time.perf_counter()
        out = fn(*args)
        timing.block(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def fused_phase_fn(loss_and_grad, *, struct: Hashable, k_iters: int,
                   optimizer: str, lr: float, b1: float, b2: float,
                   eps: float, momentum: float, device):
    """The cached phase runner for one compile key: a callable
    ``(params, opt_state, mask, frames, labels) -> (params, opt_state, u,
    losses)`` over B-stacked trees and ``(K, B, ...)`` batches.

    Keyed by the loss callable itself (sessions built from the same task
    share it), the stacked shape-dtype struct of every input, K, the
    optimizer recipe and the device: N same-shaped sessions cost one
    miss, not N. Under ``auto`` an undecided key on a CUDA device returns
    a racer: it times one warm and two timed runs of each shape on the
    caller's batch, records the winner (`auto_mode_info`) and both times
    (`race_info`), caches only the winner and returns the winner's output.
    A race is one miss; the loser is dropped uncounted."""
    global _HITS, _MISSES
    device = torch.device(device)
    backend = device.type
    base_key = (loss_and_grad, struct, k_iters, optimizer, lr, b1, b2, eps,
                momentum, device)
    mode = _EXEC_MODE
    if mode == "auto":
        mode = _AUTO_MODES.get((backend, base_key))
        if mode is None and backend != "cuda":
            mode = _AUTO_MODES[(backend, base_key)] = "loop"  # nothing to race
    elif mode == "graph" and backend != "cuda":
        raise ValueError(f"exec mode 'graph' needs a CUDA device; the group "
                         f"is on {device}")

    def build(m):
        phase = _Phase(loss_and_grad, optimizer, lr, b1, b2, eps, momentum)
        return phase if m == "loop" else _GraphPhase(phase, _pool(device))

    if mode is not None:
        key = base_key + (mode,)
        fn = _PHASE_CACHE.get(key)
        if fn is None:
            _MISSES += 1
            fn = _PHASE_CACHE[key] = build(mode)
        else:
            _HITS += 1
        return fn
    _MISSES += 1

    def race(*args):
        outs, times = {}, {}
        for m in ("loop", "graph"):
            fn = build(m)
            times[m], out = _timed_best(fn, args)
            outs[m] = (fn, out)
        winner = min(times, key=lambda m: (times[m], m))  # ties: lexical
        _AUTO_MODES[(backend, base_key)] = winner
        _RACES[(backend, base_key)] = {"winner": winner,
                                       "graph_s": times["graph"],
                                       "loop_s": times["loop"]}
        _PHASE_CACHE[base_key + (winner,)] = outs[winner][0]
        return outs[winner][1]

    return race


def _mask_struct(s, mask) -> Hashable:
    """Shape fingerprint of the phase's mask tree. A deferred gradient-
    guided mask (None) has param-shaped bool leaves by construction."""
    if mask is not None:
        return tree.struct(mask)
    leaves, treedef = tree.flatten(s.params)
    return (treedef, tuple((tuple(l.shape), str(torch.bool)) for l in leaves))


def _group_key(s, mask, frames, labels) -> Hashable:
    cfg = s.cfg
    return (s.task.loss_and_grad,
            tree.struct((s.params, s.opt_state)), _mask_struct(s, mask),
            cfg.k_iters, cfg.optimizer, cfg.lr, cfg.b1, cfg.b2, cfg.eps,
            cfg.momentum,
            # the update pipeline batches selection (keyed by γ/strategy)
            # and delta encode (keyed by wire dtype) across the group, so
            # they must agree for sessions to share a fused launch
            cfg.strategy, cfg.gamma, cfg.value_dtype,
            tuple(frames.shape), str(frames.dtype),
            tuple(labels.shape), str(labels.dtype))


# ---------------------------------------------------------------------------
# fused phase over live sessions
# ---------------------------------------------------------------------------

# update-pipeline telemetry: how much of the post-train select/encode work
# ran stacked (one launch / one transfer pair per fused group) instead of
# per-session. The serving engine snapshots this around a run.
_UPDATE_STATS = {"stacked_select_launches": 0, "stacked_select_sessions": 0,
                 "stacked_encode_launches": 0, "stacked_encode_sessions": 0}


def update_pipeline_info() -> dict:
    """Counters for the fused post-train update pipeline (stacked selection
    launches + batched delta encodes and the sessions they covered)."""
    return dict(_UPDATE_STATS)


def update_pipeline_reset() -> None:
    for k in _UPDATE_STATS:
        _UPDATE_STATS[k] = 0


def _to(t, device):
    return tree.tree_map(lambda l: l.to(device), t)


def _stacked_masks(members, device=None):
    """The group's stacked mask tree, batching deferred gradient-guided
    selections into one stacked selection.

    ``members`` carry mask=None where selection was deferred; those
    sessions' ``u_prev`` trees stack into a single
    `selection.stacked_gradient_guided_masks` call (one top-k launch for
    all of them, even for one deferred session in a group). Concrete masks
    (first-phase random or injected, Table-3 strategies) stack as they
    are. ``device`` places the selection and the stacked mask on that
    device; None places nothing."""
    def place(t):
        return t if device is None else _to(t, device)

    deferred = [j for j, m in enumerate(members) if m[2] is None]
    masks = {j: m[2] for j, m in enumerate(members) if m[2] is not None}
    if deferred:
        u_stack = place(stack_trees([members[j][1].u_prev for j in deferred]))
        stacked_d = selection.stacked_gradient_guided_masks(
            u_stack, members[0][1].cfg.gamma)
        _UPDATE_STATS["stacked_select_launches"] += 1
        _UPDATE_STATS["stacked_select_sessions"] += len(deferred)
        if not masks:
            return stacked_d
        masks.update({j: tree.tree_map(lambda l, k=k: l[k], stacked_d)
                      for k, j in enumerate(deferred)})
    return stack_trees([place(masks[j]) for j in range(len(members))])


def train_phases_fused(sessions: list, t_now: float,
                       force_stack: bool = False, device=None) -> list:
    """Run one training phase for several sessions as fused launches.

    Per-session host-side work (replay sampling, ASR/ATR bookkeeping)
    happens in session order, consuming each session's RNG exactly as its
    own ``train_phase`` would. Sessions that share a grouping key — same
    loss callable, shapes, K, optimizer and selection/wire recipe — are
    stacked and trained together as one `vmap` lifecycle (K iterations of
    a vmapped loss/grad, each followed by one fused masked-Adam launch; one
    stacked top-k launch for the group's gradient-guided selections; one
    batched encode); a session with nothing to train yields None in its
    slot, like ``train_phase``.

    Singleton groups take the sequential step path (bitwise-identical to
    ``train_phase``); ``force_stack=True`` pushes even B = 1 through the
    stacked path (tests and benchmarks).

    ``device`` (a ``torch.device``: the granted pool slot's card under
    ``GPUPool(device_backend="torch")``) places each stacked group's
    lifecycle on that device — the stacked state, masks, batches and the
    K iterations — and commits each session's new state back to the
    session's own device. The sequential singleton path ignores it. None,
    the default, places nothing: a group runs on its sessions' device."""
    results: dict[int, object] = {}
    groups: dict[Hashable, list] = defaultdict(list)
    for i, s in enumerate(sessions):
        prep = s._prepare_phase_deferred(t_now)
        if prep is None:
            results[i] = None
            continue
        mask, frames, labels = prep  # mask None = deferred gradient-guided
        groups[_group_key(s, mask, frames, labels)].append(
            (i, s, mask, frames, labels))

    for members in groups.values():
        if len(members) == 1 and not force_stack:
            i, s, mask, frames, labels = members[0]
            if mask is None:
                mask = selection.gradient_guided_mask(s.u_prev, s.cfg.gamma)
            results[i] = s._run_phase_prepared(t_now, mask, frames, labels)
            continue
        _commit_stacked(members, t_now, _launch_stacked(members, device),
                        results)
    return [results[i] for i in range(len(sessions))]


def _runner(s0, args):
    """The cached phase runner (`fused_phase_fn`) of a staged group."""
    cfg = s0.cfg
    return fused_phase_fn(
        s0.task.loss_and_grad, struct=tree.struct(args), k_iters=cfg.k_iters,
        optimizer=cfg.optimizer, lr=cfg.lr, b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
        momentum=cfg.momentum, device=args[3].device)


def _stage(members, device=None):
    """The first half of a stacked launch: stack the group's trees, place
    them on ``device`` (None: the sessions' own device), select its masks
    there (`_stacked_masks`) and copy its replay batches there.

    Returns ``(phase, args, first)``: the runner of its compile key, the
    runner's arguments ``(params, opt, mask, frames, labels)`` and whether
    the lookup missed the cache."""
    ss = [m[1] for m in members]
    dev = ss[0].device if device is None else device
    params = stack_trees([s.params for s in ss])
    opt = stack_trees([s.opt_state for s in ss])
    if device is not None:
        params, opt = _to(params, device), _to(opt, device)
    mask = _stacked_masks(members, device)
    # batches: per-session (K, batch, ...) -> (K, B, batch, ...)
    frames = host_to_device(np.stack([m[3] for m in members], axis=1), dev)
    labels = host_to_device(np.stack([m[4] for m in members], axis=1), dev)
    args = (params, opt, mask, frames, labels)
    miss0 = _MISSES
    phase = _runner(ss[0], args)
    return phase, args, _MISSES > miss0


def _launch_stacked(members, device=None):
    """Stack one group and run its K fused train iterations through the
    cached phase runner of its compile key (`fused_phase_fn`).

    Returns ``(params, opt, u, losses, mask)``, all stacked along the
    session axis and still on the device. With timing on, the phase alone
    (after the stacking and the host-to-device copy) is recorded as stage
    ``train_fused`` under key ``(B, K)``, in the first-call bucket when it
    missed the cache."""
    phase, args, first = _stage(members, device)
    cfg = members[0][1].cfg
    record = timing.enabled()
    if record:
        timing.block(args)
        t0 = time.perf_counter()
    params, opt, u, losses = phase(*args)
    if record:
        timing.block((params, opt, u, losses))
        # nbytes: the optimizer update's traffic only (33 B per coordinate
        # and iteration, forward/backward excluded), as in the JAX package
        timing.record("train_fused", time.perf_counter() - t0,
                      first=first, key=(len(members), cfg.k_iters),
                      nbytes=_adam_nbytes(members))
    return params, opt, u, losses, args[2]


def _adam_nbytes(members) -> int:
    s0 = members[0][1]
    return len(members) * s0.cfg.k_iters * 33 * selection.tree_size(s0.params)


# ---------------------------------------------------------------------------
# sharded execution: D co-resident groups on D pool cards
# ---------------------------------------------------------------------------

_SHARD_STATS = {"batches": 0, "groups": 0, "sessions": 0,
                "dispatch_launches": 0, "spmd_launches": 0,
                "distinct_devices": 0}


def sharded_info() -> dict:
    """Counters of sharded batches: batches, groups and sessions covered,
    per-group launches (``dispatch_launches``; ``spmd_launches`` stays 0:
    the JAX package's one-launch ``shard_map`` path has no counterpart),
    and the widest fan-out over distinct devices achieved (1 when nothing
    was placed or every group shared one device)."""
    return dict(_SHARD_STATS)


def sharded_reset() -> None:
    for k in _SHARD_STATS:
        _SHARD_STATS[k] = 0


def _settle(phase, s0, args):
    """Do now what a runner's first launch would do that waits for the
    card: an ``auto`` race (run on this batch, its output dropped, its
    winner cached) and a graph's capture. Returns the runner to launch."""
    if not isinstance(phase, (_Phase, _GraphPhase)):  # an auto race
        phase(*args)
        phase = _runner(s0, args)
    if isinstance(phase, _GraphPhase):
        phase.capture(*args)
    return phase


def _completion(done):
    """A group's completion time: a CPU group's was taken at its launch;
    a CUDA group's is when its event fires (`Event.synchronize` releases
    the GIL, so D waiters wait at once)."""
    if isinstance(done, float):
        return done
    done.synchronize()
    return time.perf_counter()


def _check_device(device):
    if device is None:
        return None
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} requested but the host has "
                           f"{torch.cuda.device_count()} CUDA cards")
    return dev


def train_phases_sharded(session_groups: list, t_now: float, *,
                         devices: list) -> list:
    """Run D co-resident groups' fused lifecycles on D pool devices at once.

    ``session_groups[g]`` is the member list of one granted pool slot (the
    sessions a fused grant would stack); ``devices[g]`` is that slot's
    binding, a ``torch.device`` (`GPUPool.torch_devices()` under
    ``device_backend="torch"``; the CPU is accepted too) or None, which
    runs the group on its sessions' own device: all-None is the serial
    fused baseline. A CUDA device the host lacks raises; nothing falls
    back to the CPU.

    Host-side phase preparation runs in input order, the same RNG use as
    ``train_phases_fused`` over the concatenation. Then every group is
    staged: stacked, placed on its device, its deferred gradient-guided
    selections run there as one stacked launch, its batches copied there,
    and whatever its runner's first launch would wait for done now (an
    ``auto`` race, a graph's capture). Then every group is launched, with
    nothing in between that waits for a card (a blocking copy from the
    sessions' card would wait for the work already queued there), and one
    event recorded per group on its card's stream; one waiter thread per
    group timestamps its completion. Wire deltas and commits follow in
    group order, one batched encode per group. Each group must share ONE
    compile key; mixed groups raise. A session with nothing to train gets
    None in its slot.

    The JAX package's ``spmd=True`` (one ``shard_map`` launch across the
    devices) has no counterpart: a PyTorch process has no launch that
    spans cards.

    With timing on, each group lands as stage ``"sharded_device"`` under
    key ``(slot, B, K)`` and the batch as ``"train_sharded"`` under ``(D,
    B, K)`` (``(D,)`` when the groups differ), both measured from the end
    of staging; `serving.obs.drift_report` prices both, per device too.

    Returns a list of per-group result lists (a delta or None per
    session, ``train_phases_fused`` semantics)."""
    if len(devices) != len(session_groups):
        raise ValueError(
            f"{len(session_groups)} session groups need as many device "
            f"bindings, got {len(devices)}")
    devices = [_check_device(d) for d in devices]
    results_per: list[dict] = [{} for _ in session_groups]
    prepped = []
    for gi, sessions in enumerate(session_groups):
        members, key0 = [], None
        for i, s in enumerate(sessions):
            prep = s._prepare_phase_deferred(t_now)
            if prep is None:
                results_per[gi][i] = None
                continue
            mask, frames, labels = prep
            k = _group_key(s, mask, frames, labels)
            if key0 is None:
                key0 = k
            elif k != key0:
                raise ValueError(
                    "a sharded group must share ONE compile key (the "
                    "engine fuses only same-key sessions onto a device); "
                    "split mixed sessions across slots")
            members.append((i, s, mask, frames, labels))
        if members:
            prepped.append((gi, members))

    if prepped:
        _SHARD_STATS["batches"] += 1
        _SHARD_STATS["groups"] += len(prepped)
        _SHARD_STATS["sessions"] += sum(len(m) for _, m in prepped)
        _SHARD_STATS["distinct_devices"] = max(
            _SHARD_STATS["distinct_devices"],
            len({devices[gi] for gi, _ in prepped
                 if devices[gi] is not None}) or 1)

    staged = []
    for gi, members in prepped:
        phase, args, first = _stage(members, devices[gi])
        staged.append((gi, members, _settle(phase, members[0][1], args), args,
                       first))

    t0 = time.perf_counter()  # staging done: the dispatch window opens
    launches = []
    for gi, members, phase, args, first in staged:
        out = phase(*args) + (args[2],)
        dev = args[3].device
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        else:  # the CPU ran the group before returning
            done = time.perf_counter()
        launches.append((gi, members, out, first, done))
        _SHARD_STATS["dispatch_launches"] += 1
    if len(launches) > 1:
        with ThreadPoolExecutor(max_workers=len(launches)) as ex:
            done = list(ex.map(_completion, [l[4] for l in launches]))
    else:
        done = [_completion(l[4]) for l in launches]
    if launches and timing.enabled():
        for (gi, members, _, first, _), t_done in zip(launches, done):
            timing.record("sharded_device", t_done - t0, first=first,
                          key=(gi, len(members), members[0][1].cfg.k_iters),
                          nbytes=_adam_nbytes(members))
        bks = {(len(m), m[0][1].cfg.k_iters) for _, m, _, _, _ in launches}
        uniform = bks.pop() if len(bks) == 1 else None
        timing.record("train_sharded", max(done) - t0,
                      first=any(l[3] for l in launches),
                      key=(len(launches),) + (uniform or ()),
                      nbytes=sum(_adam_nbytes(m) for _, m, _, _, _ in launches))
    for gi, members, out, _, _ in launches:
        _commit_stacked(members, t_now, out, results_per[gi])
    return [[results_per[gi].get(i) for i in range(len(sg))]
            for gi, sg in enumerate(session_groups)]


def _commit_stacked(members, t_now, out, results) -> None:
    """Encode the group's wire deltas (one batched device-to-host pull) and
    commit per-member state, each on its session's own device."""
    params, opt, u, losses, mask = out
    losses = losses.detach().cpu().numpy()
    b = len(members)
    out_dev = tree.leaves(params)[0].device
    deltas = encode_delta_stack(params, mask, b, members[0][1].cfg.value_dtype)
    _UPDATE_STATS["stacked_encode_launches"] += 1
    _UPDATE_STATS["stacked_encode_sessions"] += b
    for j, (i, s, _, _, _), p_j, o_j, u_j in zip(
            range(b), members, unstack_tree(params, b),
            unstack_tree(opt, b), unstack_tree(u, b)):
        if out_dev != s.device:
            p_j, o_j, u_j = (_to(x, s.device) for x in (p_j, o_j, u_j))
        results[i] = s._commit_phase(t_now, p_j, o_j, u_j,
                                     float(losses[j]), None,
                                     delta=deltas[j])
