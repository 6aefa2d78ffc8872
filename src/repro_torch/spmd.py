"""The port's code on DTensors: the helpers that let a step run as one
SPMD program over a `torch.distributed.device_mesh.DeviceMesh`, PyTorch's
own partitioner issuing the collectives: on meta tensors over a fake
process group for the dry run's count (`launch/dryrun.sharded_step`,
`launch.mesh.fake_mesh`), and on values over a real one
(`scripts/spmd_values.py` runs it across CPU processes against the
single-process step).

A step's weights, optimizer state, inputs and caches are DTensors placed
by the sharding rules (`launch.shardings.placements_for`). Three things
need help:

  * tensors a step makes itself (positions, masks, ``arange``s, state
    initialisers) are plain; `like` makes them replicated DTensors on the
    mesh of the tensor they meet, and `zeros` makes a sharded one;
  * a step's weights are laid out for use where the model uses them
    (`at_use`): the sharded trace gathers their FSDP shards there, inside
    a remat body, so that a recompute gathers them again, as XLA's scan
    does (`weights_at_use`);
  * the kernel wrappers, the scans and the decode steps run on local
    shards through `local` (`torch.distributed.tensor.experimental.
    local_map`), with the placement contract each has: the dims an
    operand may stay sharded on (`operand`) and, for its gradient, the
    mesh dims on which the local gradient is a partial sum. Any other
    placement of an operand is redistributed first, with the collective
    that takes.

Where DTensor's own rules would gather a whole operand that the work
needs only in part, or fail, a few ops take their sharded form here:
head dims split out of and merged into a product's sharded dim
(`split_last`, `merge_last`), the loss's logsumexp over a sharded
vocabulary (`logsumexp`), a lookup's partial sums (`reduced`,
`embedding`) and an argmax's dim (`whole`).

Every function here passes plain tensors through untouched: on the card
and on the CPU nothing changes. ``torch.distributed.tensor`` is imported
only once a DTensor is met.
"""
from __future__ import annotations

import contextlib
import sys

import torch

_AT_USE: list = []  # the layouts that `weights_at_use` set, innermost last


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor's module
    when no code has)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def like(t: torch.Tensor, ref):
    """``t`` replicated over ``ref``'s mesh where ``ref`` is a DTensor,
    else ``t`` itself: for the constants a step makes beside its
    sharded tensors (``t`` has the global shape)."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def local_shape(shape, mesh, placements) -> tuple:
    """Rank 0's shard of a global ``shape``: each sharded dim split into
    ceil-sized chunks (DTensor's and XLA's padding), the first taken."""
    from torch.distributed.tensor import Shard

    loc = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            loc[p.dim] = -(-loc[p.dim] // mesh.size(i))
    return tuple(loc)


def _wrap(local: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous) whose local shard is
    ``local``."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    return DTensor.from_local(local, mesh, list(placements), run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def from_meta(shape, dtype, mesh, placements, *, requires_grad: bool = False):
    """A DTensor of global ``shape`` placed by ``placements`` whose local
    shard (rank 0's, `local_shape`) is an empty meta tensor."""
    local = torch.empty(local_shape(shape, mesh, placements), dtype=dtype,
                        device=torch.device("meta"))
    return _wrap(local, mesh, placements, shape).requires_grad_(requires_grad)


def zeros(shape, dtype, ref, placements):
    """Zeros of global ``shape`` on ``ref``'s mesh, placed by
    ``placements`` (its local shard on ``ref``'s local device), where
    ``ref`` is a DTensor; else a plain ``torch.zeros`` on ``ref``'s
    device."""
    if not is_dtensor(ref):
        return torch.zeros(shape, dtype=dtype, device=ref.device)
    mesh = ref.device_mesh
    local = torch.zeros(local_shape(shape, mesh, placements), dtype=dtype,
                        device=ref.to_local().device)
    return _wrap(local, mesh, placements, shape)


def operand(primary, keep, dims=None) -> tuple[list, list]:
    """(placements, gradient placements) of an operand of a computation
    that is local along the dims ``keep`` of ``primary`` (a DTensor; dims
    negative counted from the end). ``dims`` maps a kept dim of primary
    to the operand's own dim (primary itself where None: the identity).
    On each mesh dim where primary is sharded along a kept dim, the
    operand is sharded along its matching dim, or, lacking one,
    replicated with a gradient that is a partial sum (each rank's
    gradient covers its own shard of primary); on every other mesh dim
    (primary replicated, a partial sum, or sharded along a dim that must
    be whole) the operand is replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    keep = {d % primary.ndim for d in keep}
    if dims is None:
        dims = {d: d for d in keep}
    place, grad = [], []
    for p in primary.placements:
        d = p.dim % primary.ndim if isinstance(p, Shard) else None
        if d is None or d not in keep:
            place.append(Replicate())
            grad.append(Replicate())
        elif d in dims:
            place.append(Shard(dims[d]))
            grad.append(Shard(dims[d]))
        else:
            place.append(Replicate())
            grad.append(Partial())
    return place, grad


def local(fn, out_placements, in_placements, in_grad_placements=None):
    """``fn`` run on local shards (`local_map`): each DTensor argument
    redistributed to its entry of ``in_placements`` (None for a non-tensor
    argument), ``fn``'s outputs wrapped with ``out_placements``."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map

    def norm(pl):  # one tensor's placements a list, several tensors' a tuple
        if pl is None:
            return None
        pl = list(pl)
        return pl if not pl or isinstance(pl[0], Placement) else tuple(map(norm, pl))

    return local_map(fn, out_placements=norm(out_placements),
                     in_placements=tuple(map(norm, in_placements)),
                     in_grad_placements=(None if in_grad_placements is None
                                         else tuple(map(norm, in_grad_placements))),
                     redistribute_inputs=True)


def write_index(c, dim: int, index: int, new) -> None:
    """``c.select(dim, index).copy_(new)`` on a DTensor ``c`` sharded along
    ``dim``: ``new`` is placed as that slice of c is (every rank takes
    part in that), and the rank whose shard holds ``index`` writes it
    into its local shard. No shard of c moves."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    rest = [d for d in range(c.ndim) if d != dim]
    place = operand(c, rest, {d: i for i, d in enumerate(rest)})[0]
    new_local = (new.redistribute(placements=place).to_local() if is_dtensor(new)
                 else new)
    shape, offset = compute_local_shape_and_global_offset(c.shape, c.device_mesh,
                                                          c.placements)
    if offset[dim] <= index < offset[dim] + shape[dim]:
        c.to_local().select(dim, index - offset[dim]).copy_(new_local)


def _gather_unsplittable(t, first: int):
    """``t``, a DTensor, gathered along its last dim over the mesh dims
    whose shard count does not divide ``first`` (the size of the leading
    dim that the last one is split into); shards that divide stay."""
    from torch.distributed.tensor import Replicate, Shard

    last, parts, place = t.ndim - 1, 1, list(t.placements)
    for i, p in enumerate(place):
        if isinstance(p, Shard) and p.dim % t.ndim == last:
            if first % (parts * t.device_mesh.size(i)):
                place[i] = Replicate()
            else:
                parts *= t.device_mesh.size(i)
    return t.redistribute(placements=place) if place != list(t.placements) else t


class _SplitLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, sizes):
        ctx.n = len(sizes)
        return _gather_unsplittable(t, sizes[0]).reshape(tuple(t.shape[:-1]) + tuple(sizes))

    @staticmethod
    def backward(ctx, g):
        return merge_last(g, ctx.n), None


class _MergeLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, n):
        ctx.sizes = tuple(t.shape[-n:])
        return t.flatten(t.ndim - n)

    @staticmethod
    def backward(ctx, g):
        return split_last(g, ctx.sizes), None


def split_last(t, sizes):
    """``t.reshape(*t.shape[:-1], *sizes)``. A DTensor sharded along its
    last dim over mesh dims whose shard count does not divide
    ``sizes[0]`` is gathered along it first (DTensor cannot split such a
    shard); a shard that divides stays. Its gradient is `merge_last`'s."""
    if not is_dtensor(t):
        return t.reshape(tuple(t.shape[:-1]) + tuple(sizes))
    return _SplitLast.apply(t, tuple(sizes))


def merge_last(t, n: int):
    """``t.flatten(-n)``: the last ``n`` dims as one. On a DTensor its
    gradient is `split_last`'s, which gathers a gradient that DTensor
    sharded where the dims cannot be split back out of it."""
    if not is_dtensor(t):
        return t.flatten(t.ndim - n)
    return _MergeLast.apply(t, n)


class _LogSumExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        m = x.amax(dim=dim, keepdim=True)
        lse = m + torch.log(torch.exp(x - m).sum(dim=dim, keepdim=True))
        ctx.dim = dim
        ctx.save_for_backward(torch.exp(x - lse))
        return lse.squeeze(dim)

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return g.unsqueeze(ctx.dim) * p, None


def logsumexp(x, dim: int):
    """``torch.logsumexp(x, dim)``. On a DTensor it is the max, the sum of
    exp(x - max) and, where ``dim`` is sharded, their all-reduces of one
    value a row, as a vocabulary-parallel loss computes it, where
    DTensor's own logsumexp would gather every row whole. Its gradient is
    the softmax times the incoming gradient, on each shard: no
    collective (DTensor's own backward of the sum's reduction was wrong
    on some torch versions)."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=dim)
    return _LogSumExp.apply(x, dim)


@contextlib.contextmanager
def weights_at_use(layout):
    """For the span of the context, `at_use` returns ``layout(params,
    part)``."""
    _AT_USE.append(layout)
    try:
        yield
    finally:
        _AT_USE.pop()


def at_use(params, part: str):
    """A part of a model's weights (``"groups"``: one group's blocks,
    ``"shared_attn"``, ``"encoder"``: one encoder layer's block,
    ``"embed"``) as the computation about to use them takes them: as they
    are, unless a sharded trace set a layout (`weights_at_use`)."""
    return _AT_USE[-1](params, part) if _AT_USE else params


def _keeping(t, keep):
    """DTensor ``t`` redistributed to `operand`'s placements for ``keep``
    (a no-op where they are t's own)."""
    place = operand(t, keep)[0]
    return t.redistribute(placements=place) if place != list(t.placements) else t


def reduced(t):
    """``t`` with its partial sums reduced (every shard kept); a plain
    tensor as it is. A vocabulary-parallel lookup's rows are reduced
    where they are looked up, as such a lookup is: DTensor's masked
    partial sum does not survive the ops that follow it."""
    return _keeping(t, range(t.ndim)) if is_dtensor(t) else t


def embedding(tokens, table):
    """``F.embedding(tokens, table)`` on DTensors, its partial sums over a
    sharded vocabulary reduced (`reduced`). The tokens are first
    replicated over the mesh dims that shard the table's width, where
    DTensor would move them itself: its masked partial sum keeps the mask
    of the tokens' shard as given, which then no longer fits the rows it
    masks."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate

    place = [Replicate() if tp.is_shard(1) else p
             for tp, p in zip(table.placements, tokens.placements)]
    if place != list(tokens.placements):
        tokens = tokens.redistribute(placements=place)
    return reduced(F.embedding(tokens, table))


def whole(t, dim: int):
    """``t`` with dim ``dim`` gathered where a DTensor shards it (every
    other shard kept); a plain tensor as it is. For an op that DTensor
    cannot run over shards of that dim (its argmax over a sharded dim
    fails on some meshes)."""
    if not is_dtensor(t):
        return t
    return _keeping(t, [d for d in range(t.ndim) if d != dim % t.ndim])
