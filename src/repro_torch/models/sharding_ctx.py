"""Activation-sharding context and the port's partition specs.

Model code is mesh-agnostic; the launcher installs a constrainer that maps
logical names to ``DTensor.redistribute`` on the live mesh (the
reference's ``with_sharding_constraint``). With nothing installed, or on a
plain tensor, ``constrain`` returns its input. Names: act (B,S,D), tokens
(B,S), logits (B,S,V), moe_buf (E,C,D), moe_tokens (TK,D), kv (B,T,H,dh).

``P`` is the port's partition spec: one entry per tensor dim, each
``None`` (replicated), a mesh axis name, or a tuple of names (the dim
split over several axes, major first). Entries are normalised as the
reference's ``PartitionSpec`` normalises them (a list becomes a tuple, a
one-name tuple the name, an empty one ``None``), so ``tuple(P(...))``
equals the tuple of the reference's spec of the same entries.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.convert import tree_map

_CONSTRAINER: Callable[[torch.Tensor, str], torch.Tensor] | None = None
# the times local_shards ran its function on DTensors laid out other than
# on its dims (the dry run's record reads it: ``Trace.local_fallbacks``)
LOCAL_FALLBACKS = [0]
_MOE_CTX: dict | None = None   # {"mesh", "dp", "tp"} -> all-to-all MoE dispatch


def _normalise(entry):
    if isinstance(entry, (list, tuple)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class P:
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"), "model")``,
    ``P()`` (every dim replicated). A leaf of spec trees (not a tuple, so
    tree helpers never walk into it)."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(_normalise(a) for a in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.parts == other.parts

    def __hash__(self):
        return hash(("P", self.parts))

    def __repr__(self):
        return "P(" + ", ".join(repr(a) for a in self.parts) + ")"


def spec_map(fn, tree, *rest):
    """``fn`` over the ``P`` leaves of a nested dict / list / tuple spec tree
    (and the same places of the trees ``rest``), keeping the structure."""
    if isinstance(tree, P) or tree is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: spec_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(spec_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def with_layer_dim(tree):
    """Every spec of ``tree`` with a leading replicated (stacked-layer) dim."""
    return spec_map(lambda sp: P(None, *sp), tree)


def replicated(fn, *args):
    """``fn(*args)`` where ``DTensor`` has no sharding rule for an op of
    ``fn``: every ``DTensor`` argument is redistributed to ``Replicate()``
    and ``fn`` runs on the local tensors; tensor results come back as
    replicated ``DTensor``s on that mesh (a tensor, or a tuple / list /
    dict of them). Differentiable. Without a ``DTensor`` argument this is
    ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Replicate

    meshes = [a.device_mesh for a in args if isinstance(a, DTensor)]
    if not meshes:
        return fn(*args)
    mesh = meshes[0]
    rep = [Replicate()] * mesh.ndim
    out = fn(*(a.redistribute(mesh, rep).to_local() if isinstance(a, DTensor) else a
               for a in args))

    def wrap(t):
        if isinstance(t, torch.Tensor):
            return DTensor.from_local(t, mesh, rep, run_check=False)
        if isinstance(t, dict):
            return {k: wrap(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(wrap(v) for v in t)
        return t

    return wrap(out)



def _sharded_ranks(x, dim: int) -> int:
    """Ranks a ``DTensor``'s ``dim`` is split over (1 for a plain tensor)."""
    from torch.distributed.tensor import Shard

    placements = getattr(x, "placements", ())
    dim = dim % x.dim()
    return math.prod(n for p, n in zip(placements, x.device_mesh.shape)
                     if isinstance(p, Shard) and p.dim == dim) if placements else 1


def whole_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with ``dim`` whole on every rank: a ``DTensor``'s ``Shard(dim)``
    redistributed to ``Replicate()``, its other placements kept; a plain
    tensor as it is. Differentiable."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dim = dim % x.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def split_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (..., n·m) viewed as (..., n, m), the head split of a model's
    inner width. A ``DTensor`` sharded on the last dim over ranks that do
    not divide ``n`` (4 xLSTM heads on a 16-way model axis) is first made
    whole along it, as is the gradient that comes back sharded on the head
    width: ``DTensor`` cannot unflatten the one nor flatten the other. The
    reference's GSPMD shards the head width there; the port's products
    that follow take the head width's sharding from their weights."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)
    if n % _sharded_ranks(x, -1):
        x = whole_along(x, -1)
    return _SplitLast.apply(x, n)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., n, m) viewed as (..., n·m), the head merge; a ``DTensor``
    (and the gradient that comes back) is made whole along a dim that
    ``DTensor`` could not flatten or unflatten (see :func:`split_last`)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if _sharded_ranks(x, -1) > 1:
        x = whole_along(x, -1)
    return _MergeLast.apply(x)


class _SplitLast(torch.autograd.Function):
    """(..., n·m) -> (..., n, m) on a ``DTensor``; the gradient made whole
    along its head width before it is flattened back."""

    @staticmethod
    def forward(ctx, x, n):
        return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)

    @staticmethod
    def backward(ctx, g):
        if _sharded_ranks(g, -1) > 1:
            g = whole_along(g, -1)
        return g.reshape(*g.shape[:-2], g.shape[-2] * g.shape[-1]), None


class _MergeLast(torch.autograd.Function):
    """(..., n, m) -> (..., n·m) on a ``DTensor``; the gradient made whole
    along the last dim where its ranks do not divide ``n``."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[-2]
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        if ctx.n % _sharded_ranks(g, -1):
            g = whole_along(g, -1)
        return g.reshape(*g.shape[:-1], ctx.n, g.shape[-1] // ctx.n)

def local_shards(fn, dims: tuple[int, ...], *args):
    """``fn(*args)`` on each rank's shards, for an ``fn`` whose result is
    computed independently along ``dims`` (attention along batch and
    heads): when the first ``DTensor`` argument is sharded on ``dims``
    only, every ``DTensor`` argument is laid out as it is and ``fn`` runs on
    the local tensors; its tensor result, which keeps those dims, comes
    back as a ``DTensor`` of the same layout. The same numbers as ``fn`` on
    the global tensors, with none of ``DTensor``'s per-op dispatch (nor its
    limits: torch 2.11 cannot flatten two sharded dims, which einsum's
    batched products do). Differentiable. Otherwise ``fn(*args)`` on the
    ``DTensor``s, counted in ``LOCAL_FALLBACKS``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    lead = next((a for a in args if isinstance(a, DTensor)), None)
    if lead is None:
        return fn(*args)
    pl = tuple(lead.placements)
    if not all(isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim in dims)
               for p in pl):
        LOCAL_FALLBACKS[0] += 1
        return fn(*args)
    return _on_local(fn, lead.device_mesh, pl, args)


def shards_whole_along(fn, dim: int, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an ``fn`` that works along ``dim`` alone (a roll of
    the positions): a ``DTensor`` is laid out with ``dim`` whole (and any
    pending sum reduced), its other shards kept, and ``fn`` runs on each
    rank's local tensor; the result comes back in that layout. torch
    2.11's ``DTensor`` has no rule for such ops (``aten.roll``). A plain
    tensor: ``fn(x)``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return fn(x)
    dim = dim % x.dim()
    pl = tuple(p if isinstance(p, Shard) and p.dim != dim else Replicate()
               for p in x.placements)
    return _on_local(fn, x.device_mesh, pl, (x,))


def batch_shards(fn, *args, weights=(), heads=None):
    """``fn(*args)`` on each rank's shard of the batch (dim 0), for an
    ``fn`` computed independently along it: every ``DTensor`` argument is
    laid out with dim 0 sharded as the first one's is and every other dim
    whole, ``fn`` runs on the local tensors and its result (a tensor, or
    a dict of them) comes back in that layout. The mLSTM's parallel form
    runs so: on a shard of the head width (4 heads on a model axis wider
    than 4) ``DTensor`` cannot run its batched products' backward (it views
    a permuted local gradient that cannot be viewed); and its final state:
    torch 2.11's einsum views the local shard of a batch split over two
    mesh axes ("pod", "data") at the wrong size. Differentiable. Without a
    ``DTensor`` argument this is ``fn(*args, *weights)``.

    With ``heads``, for an ``fn`` that is also independent along a head
    dim and returns a tuple (the sLSTM's scan, whose recurrence is
    block-diagonal by head): ``(n_heads, dims, out_dims)``, the head dim
    of each of ``args`` and ``weights`` and of each result. The first mesh
    axis past the batch's whose size (above 1) divides ``n_heads`` splits
    the heads; with none, the heads stay whole. ``weights`` (given with
    ``heads``) follow ``args`` into ``fn``, with no batch dim: whole on
    every rank but for the head split; each rank's gradient of a weight is
    its share of the sum over the batch's ranks (``Partial()`` there)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    lead = next((a for a in args if isinstance(a, DTensor)), None)
    if lead is None:
        return fn(*args, *weights)
    mesh = lead.device_mesh
    batch = [isinstance(p, Shard) and p.dim == 0 for p in lead.placements]
    if heads is None:
        pl = tuple(Shard(0) if b else Replicate() for b in batch)
        return _on_local(fn, mesh, pl, args)
    n_heads, dims, out_dims = heads
    head_axis = split_heads_axis(lead, n_heads)

    def layout(batch_dim, head_dim):
        return tuple(Shard(batch_dim) if b and batch_dim is not None
                     else Shard(head_dim) if i == head_axis else Replicate()
                     for i, b in enumerate(batch))

    local = []
    for i, a in enumerate((*args, *weights)):
        if not isinstance(a, DTensor):
            local.append(a)
            continue
        is_weight = i >= len(args)
        pl = layout(None if is_weight else 0, dims[i])
        grad_pl = [Partial() if b else p for b, p in zip(batch, pl)] if is_weight else None
        local.append(_ContiguousGrad.apply(
            a.redistribute(mesh, pl).to_local(grad_placements=grad_pl)))
    return tuple(DTensor.from_local(t.contiguous(), mesh, layout(0, d), run_check=False)
                 for t, d in zip(fn(*local), out_dims))


def split_heads_axis(x: torch.Tensor, n_heads: int) -> int | None:
    """The mesh dim over which :func:`batch_shards` splits ``n_heads`` heads
    of ``DTensor`` ``x``: the first past those that shard its batch (dim 0)
    whose size, above 1, divides ``n_heads``; ``None`` where none does (or
    ``x`` is a plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return None
    return next((i for i, (p, k) in enumerate(zip(x.placements, x.device_mesh.shape))
                 if not (isinstance(p, Shard) and p.dim == 0) and k > 1 and n_heads % k == 0),
                None)


def split_shards(fn, args, dims, out_dims, positions: int | None = None, weights=()):
    """``fn(*args)`` on each rank's share, for an ``fn`` computed
    independently along the batch (dim 0 of every argument and result) and
    along one more dim of some of its arguments and results: ``dims`` (one
    entry an argument) and ``out_dims`` (one a result of the tuple ``fn``
    returns) name that dim, or ``None`` for a tensor each rank needs whole
    (``fn``'s row t of the mLSTM's parallel form reads query row t and
    every key; the RG-LRU's scan, elementwise along its width, needs
    nothing whole). Every ``DTensor`` argument is laid out with the batch
    split as the first one's is and its dim split over every other mesh
    axis above size 1 (whole on every rank where ``None``); each result
    comes back a ``DTensor`` laid out so. Each rank's gradient of a whole
    argument is its share of the sum over those axes (``Partial()``
    there). The split dims must divide evenly. With ``positions`` (the
    length of a split dim), ``fn`` also gets ``rows=``: the positions of
    the rank's share of that dim, where an axis splits it. ``weights``
    follow ``args`` into ``fn``, with no batch dim: whole on every rank,
    each rank's gradient its share of the sum over the batch's and the
    split axes. Differentiable. Without a ``DTensor`` argument this is
    ``fn(*args, *weights)``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    lead = next((a for a in args if isinstance(a, DTensor)), None)
    if lead is None:
        return fn(*args, *weights)
    mesh = lead.device_mesh
    batch = [isinstance(p, Shard) and p.dim == 0 for p in lead.placements]
    split = [not b and k > 1 for b, k in zip(batch, mesh.shape)]

    def layout(dim, whole):
        return tuple(Shard(0) if b else Replicate() if not r else
                     Shard(dim) if dim is not None else whole
                     for b, r in zip(batch, split))

    local = [a if not isinstance(a, DTensor) else _ContiguousGrad.apply(
        a.redistribute(mesh, layout(d, Replicate())).to_local(
            grad_placements=layout(d, Partial()))) for a, d in zip(args, dims)]
    summed = [Partial() if b or r else Replicate() for b, r in zip(batch, split)]
    local += [w if not isinstance(w, DTensor) else _ContiguousGrad.apply(
        w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=summed))
        for w in weights]
    kw = {} if positions is None or not any(split) else {"rows": distribute_tensor(
        torch.arange(positions, device=lead.to_local().device), mesh,
        [Shard(0) if r else Replicate() for r in split], src_data_rank=None).to_local()}
    return tuple(DTensor.from_local(t.contiguous(), mesh, layout(d, Replicate()),
                                    run_check=False)
                 for t, d in zip(fn(*local, **kw), out_dims))


def _on_local(fn, mesh, pl, args):
    """``fn`` on the local tensors of ``args`` laid out as ``pl``; its
    result a ``DTensor`` of that layout."""
    from torch.distributed.tensor import DTensor

    out = fn(*(_ContiguousGrad.apply(a.redistribute(mesh, pl).to_local())
               if isinstance(a, DTensor) else a for a in args))
    # contiguous, here and in the gradients: a DTensor's views are planned
    # on its global strides, which a permuted shard need not match (torch
    # 2.11 fails to view one with a size-1 head dim)
    return tree_map(lambda t: DTensor.from_local(t.contiguous(), mesh, pl, run_check=False),
                    out)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


# ---------------------------------------------------------------------------
# Layout primitives on a mesh (a ``DeviceMesh`` or a ``LocalMesh``)
# ---------------------------------------------------------------------------

def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, a
    ``LocalMesh``'s ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(mesh.axis_names if names is None else names)


def axis_size(mesh, axis) -> int:
    """Devices along ``axis``: a name, a tuple of names (their product) or
    ``None`` (1)."""
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(axis_size(mesh, a) for a in axis)
    return tuple(mesh.shape)[axis_names(mesh).index(axis)]


def fit_spec(spec: P | None, shape: tuple[int, ...], mesh) -> P:
    """Drop spec axes that don't divide their dimension (replicate there);
    of a compound entry keep the axes that still divide, in order."""
    if spec is None:
        return P()
    parts = list(spec)
    while len(parts) < len(shape):
        parts.append(None)
    out = []
    for dim, axis in zip(shape, parts[: len(shape)]):
        if axis is None:
            out.append(None)
            continue
        if dim % axis_size(mesh, axis) == 0:
            out.append(axis)
        elif isinstance(axis, (tuple, list)):
            kept = []
            for a in axis:
                if dim % axis_size(mesh, tuple(kept + [a])) == 0:
                    kept.append(a)
            out.append(tuple(kept) if kept else None)
        else:
            out.append(None)
    return P(*out)


def placements_for(spec: P, mesh) -> tuple:
    """``DTensor`` placements of a fitted spec on a ``DeviceMesh``."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        group = entry if isinstance(entry, tuple) else (entry,)
        group = tuple(a for a in group if a is not None)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order {names}")
        for a in group:
            if a in owner:
                raise ValueError(f"axis {a!r} shards two dims of {spec}")
            owner[a] = d
    return tuple(Shard(owner[n]) if n in owner and axis_size(mesh, n) > 1 else Replicate()
                 for n in names)


def relayout(tree, like):
    """Each ``DTensor`` leaf of ``tree`` redistributed to the placements of
    the same leaf of ``like`` (a step's outputs back in its inputs' layouts,
    the reference's ``out_shardings``); plain leaves as they are."""
    def one(new, old):
        if hasattr(old, "placements") and tuple(new.placements) != tuple(old.placements):
            return new.redistribute(old.device_mesh, old.placements)
        return new

    return tree_map(one, tree, like)


def set_constrainer(fn: Callable[[torch.Tensor, str], torch.Tensor] | None) -> None:
    global _CONSTRAINER
    _CONSTRAINER = fn


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    if _CONSTRAINER is None:
        return x
    return _CONSTRAINER(x, name)


def set_moe_ctx(info: dict | None) -> None:
    """Enable the explicit all-to-all MoE dispatch under a mesh."""
    global _MOE_CTX
    _MOE_CTX = info


def get_moe_ctx() -> dict | None:
    return _MOE_CTX
