"""Int8 error-feedback gradient compression for the data-parallel
all-reduce: each replica quantises its gradient to int8 with a shared
per-tensor scale and keeps the residual in a local buffer that is added
back next step (error-feedback SGD). Cross-replica gradient traffic drops
4x (fp32) or 2x (bf16).

Each replica is one rank: ``compressed_psum_tree`` runs the quantise ->
sum -> dequantise sequence explicitly with ``torch.distributed``
collectives on that rank's own gradients (the reference stacks the
replicas on a leading axis of one array and splits it with ``shard_map``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch._arith import clip, div
from repro_torch.convert import tree_flatten_with_paths, tree_map, tree_unflatten
from repro_torch.models.sharding_ctx import axis_size


def quantize_ef(g: torch.Tensor, err: torch.Tensor,
                scale: torch.Tensor | float) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, new error buffer) for a given (shared) scale."""
    corrected = g.to(torch.float32) + err
    q = corrected / scale if isinstance(scale, torch.Tensor) else div(corrected, scale)
    codes = clip(torch.round(q), -127.0, 127.0).to(torch.int8)
    new_err = corrected - codes.to(torch.float32) * scale
    return codes, new_err


def init_error_buffers(params):
    """A float32 zero buffer per parameter, on its device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compressed_sum(g: torch.Tensor, err: torch.Tensor, group
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf over the ranks of ``group``: ``(int32 code sum, shared
    scale, new error buffer)``. An ``all_reduce(MAX)`` of |g + err|'s max
    gives the scale (4 bytes a tensor); the int8 codes (with error
    feedback) are summed in int32, exactly."""
    corrected = g.to(torch.float32) + err
    amax = torch.amax(torch.abs(corrected))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = div(torch.clamp_min(amax, 1e-12), 127.0)
    codes, new_err = quantize_ef(g, err, scale)
    # a collective needs a dense tensor (autograd can hand back strided grads)
    codes_sum = codes.to(torch.int32, memory_format=torch.contiguous_format)
    dist.all_reduce(codes_sum, op=dist.ReduceOp.SUM, group=group)
    return codes_sum, scale, new_err


def compressed_psum_tree(grads, err_tree, group, n_replicas: int):
    """This rank's ``(mean_grads, new_err_tree)``: per leaf
    :func:`compressed_sum`, then the dequantised mean."""
    def one(g, err):
        codes_sum, scale, new_err = compressed_sum(g, err, group)
        return div(codes_sum.to(torch.float32) * scale, float(n_replicas)), new_err

    flat_g = [x for _, x in tree_flatten_with_paths(grads)]
    flat_e = [x for _, x in tree_flatten_with_paths(err_tree)]
    outs = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(err_tree, [o[1] for o in outs]))


def make_compressed_allreduce(mesh, axis: str = "data"):
    """``fn(grads, err) -> (mean_grads, err')`` over the ranks of ``axis``
    of a ``DeviceMesh``: every rank passes its own gradients and error
    buffers (plain tensors) and gets the compressed mean and its new
    buffers."""
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)

    def fn(grads, err):
        with torch.no_grad():
            return compressed_psum_tree(grads, err, group, n)

    return fn
