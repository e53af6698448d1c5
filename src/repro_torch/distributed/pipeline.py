"""GPipe-style pipeline parallelism over a slow mesh axis ("pod").

Across pods the link is far slower than within one, so instead of
stretching the DP all-reduce across it, the layer stack is split into one
stage per rank of the axis and microbatches stream through: cross-pod
traffic becomes point-to-point activations instead of a parameter
all-reduce.

Every rank of the axis runs the same schedule over T = n_micro +
n_stages - 1 ticks:

    tick t: x_in  <- ring shift +1 of x_out of tick t-1   # from the left
            if stage == 0 and t < n_micro: x_in = microbatch[t]
            x_out = stage_fn(stage_params, x_in)            # bubble ticks
                                                            # compute garbage
    outputs: the last stage's x_out at ticks n_stages-1 .. T-1

The ring shift is an autograd function over ``batch_isend_irecv`` whose
backward is the reverse shift, so training backprops through the pipe.
Each backward shift pairs a send with the neighbours' receive, so every
rank must run the backward of every shift: each shift's output (and the
microbatches) is tied into the result by a select that adds an exact 0,
so none drops out of a rank's graph (stage 0 ignores its input while it
injects; a bubble tick's output may reach no real output).
The last stage's outputs reach every rank by an ``all_reduce`` of a
SELECT (``torch.where``), never a multiply: a stage_fn that turns a
bubble tick's zero carry into NaN / inf would otherwise poison the real
outputs through ``NaN * 0``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.convert import tree_map


def _ring(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    r = dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, (r + shift) % n),
                      group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """Send to the rank ``shift`` places on, receive from the one as many
    places back; the backward is the reverse shift."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ring(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, ctx.group, -ctx.shift), None, None


class _Broadcast(torch.autograd.Function):
    """Sum of the per-rank values (one rank holds the result, the others
    zeros) into every rank; the backward hands each rank the replicated
    gradient unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _stage_block(x: torch.Tensor, sub_mesh):
    """This rank's stage slice ``x[stage]`` of a (n_stages, ...) leaf: a
    plain tensor (the same on every rank) or a ``DTensor`` on the axis; its
    gradient is gathered back into ``x``'s layout in the backward."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, sub_mesh, [Replicate()], run_check=False)
    return x.redistribute(sub_mesh, [Shard(0)]).to_local()[0]


def _replicated_input(x: torch.Tensor, sub_mesh) -> torch.Tensor:
    """``x`` (the same on every rank) as this rank's operand: only stage 0
    reads it, so its gradient is the sum over the ranks."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return DTensor.from_local(x, sub_mesh, [Replicate()], run_check=False).to_local(
        grad_placements=[Partial()])


def pipeline_forward(stage_params, microbatches: torch.Tensor, stage_fn: Callable, mesh,
                     axis: str = "pod") -> torch.Tensor:
    """``stage_params``: a tree of (n_stages, ...) leaves; ``microbatches``
    (n_micro, mb, ...) the same on every rank; ``stage_fn(params, x) -> y``
    of x's shape. Every rank of ``mesh`` calls it; every rank returns the
    (n_micro, mb, ...) outputs of the final stage."""
    sub = mesh[axis] if mesh.ndim > 1 else mesh
    group = sub.get_group()
    n_stages = sub.size()
    stage = sub.get_local_rank()
    n_micro = microbatches.shape[0]
    ticks = n_micro + n_stages - 1

    params_local = tree_map(lambda x: _stage_block(x, sub), stage_params)
    mbs = _replicated_input(microbatches, sub)

    no = torch.zeros((), dtype=torch.bool, device=mbs.device)
    zero = torch.zeros((), dtype=mbs.dtype, device=mbs.device)
    anchor = torch.where(no, mbs, zero).sum()       # an exact 0 tied to each input

    x_prev = torch.zeros(mbs.shape[1:], dtype=mbs.dtype, device=mbs.device)
    ys = []
    for t in range(ticks):
        x_in = _RingShift.apply(x_prev, group, 1)          # receive from the left
        if x_in.requires_grad:
            anchor = anchor + torch.where(no, x_in, zero).sum()
        if stage == 0 and t < n_micro:
            x_in = mbs[t]
        x_prev = stage_fn(params_local, x_in)
        ys.append(x_prev)
    out = torch.stack(ys[n_stages - 1:n_stages - 1 + n_micro])
    is_last = torch.full((), stage == n_stages - 1, dtype=torch.bool, device=out.device)
    return _Broadcast.apply(torch.where(is_last, out, torch.zeros_like(out)), group) + anchor


def split_layers_to_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (n_stages, L // n_stages, ...)."""
    def re(x):
        n = x.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])

    return tree_map(re, stacked_params)
