"""The LM's training step (the reference's ``repro.train.train_step``): a
cast of the float32 master weights to the compute dtype, the gradient by
``torch.autograd``, an AdamW update under the cosine schedule, and
optional gradient accumulation over microbatches.

The cast is differentiable, so the gradients arrive in float32 on the
float32 masters while the forward runs in ``compute_dtype``. Nothing here
reads a value back to the host.

The sharded step is the same function on ``DTensor`` parameters and
optimiser state (laid out by ``launch.shardings.shardings_for``) and a
batch sharded over the dp axes, run under ``launch.shardings.
constrainer_ctx``: every op propagates its operands' placements, the
activation constraints redistribute, and the constants the model makes
as plain tensors (positions, masks, zeros) count as replicated
(``implicit_replication``).
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import tree_flatten_with_paths, tree_map, tree_unflatten
from repro_torch.models import lm
from repro_torch.models.layers import ParallelPlan
from repro_torch.models.sharding_ctx import relayout
from repro_torch.optim import AdamWConfig, adamw_update, cosine_with_warmup


def cast_tree(tree, dtype: torch.dtype):
    """Every floating leaf cast to ``dtype`` (differentiably); other leaves
    as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def make_grads_fn(cfg: ModelConfig, plan: ParallelPlan, opt: AdamWConfig,
                  compute_dtype: torch.dtype = torch.bfloat16, microbatches: int = 1):
    """``grads_of(params, batch) -> (loss, metrics, grads)``: the gradient of
    ``lm.loss_fn`` on the params cast to ``compute_dtype``, in the params'
    tree and dtype. With ``microbatches > 1`` the batch is cut into that
    many slices along its first dim; their gradients are summed into zeros
    of ``opt.moment_dtype`` and scaled by ``1 / microbatches``, the loss
    likewise, and ``metrics`` is ``{}`` (as the reference returns)."""

    def loss_and_grads(params, batch):
        live = [x.detach().requires_grad_(True) for _, x in tree_flatten_with_paths(params)]
        loss, metrics = lm.loss_fn(cast_tree(tree_unflatten(params, live), compute_dtype),
                                   batch, cfg, plan)
        grads = torch.autograd.grad(loss, live)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, list(grads)))

    def grads_of(params, batch):
        if microbatches == 1:
            return loss_and_grads(params, batch)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=opt.moment_dtype,
                                             device=p.device), params)
        first = tree_flatten_with_paths(params)[0][1]
        loss_sum = torch.zeros((), dtype=torch.float32, device=first.device)
        for i in range(microbatches):
            mb = {k: _slice(v, i, microbatches) for k, v in batch.items()}
            loss, _, g = loss_and_grads(params, mb)
            acc = tree_map(lambda a, gg: a + gg.to(a.dtype), acc, g)
            loss_sum = loss_sum + loss
        inv = 1.0 / microbatches
        return loss_sum * inv, {}, tree_map(lambda g: g * inv, acc)

    return grads_of


def _spmd(params):
    """``implicit_replication`` when the parameters are ``DTensor``s (plain
    tensors made inside the step are then replicated operands), else
    nothing."""
    from torch.distributed.tensor import DTensor

    first = tree_flatten_with_paths(params)[0][1]
    if isinstance(first, DTensor):
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def _slice(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` along the first dim. A ``DTensor`` whose
    first dim is sharded is cut within each rank's shard (microbatch i is
    the i-th slice of every rank's rows), so it stays sharded: a slice of
    the global rows would be gathered onto every rank. Every microbatch
    holds as many rows either way, so the mean of their losses and
    gradients is the batch's."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(x, DTensor) and any(isinstance(p, Shard) and p.dim == 0
                                      for p in x.placements):
        loc = x.to_local()
        mb = loc.shape[0] // n
        return DTensor.from_local(loc[i * mb:(i + 1) * mb], x.device_mesh, x.placements,
                                  run_check=False)
    mb = x.shape[0] // n
    return x[i * mb:(i + 1) * mb]


def make_train_step(cfg: ModelConfig, plan: ParallelPlan, opt: AdamWConfig,
                    compute_dtype: torch.dtype = torch.bfloat16, warmup: int = 200,
                    total_steps: int = 10_000, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`make_grads_fn`'s gradient, then one AdamW update at
    ``cosine_with_warmup(step)``. ``metrics`` holds ``loss``, ``lr``,
    ``grad_norm`` and the loss's own metrics (``ce``, ``moe_aux``; none
    with microbatches), as device tensors."""
    grads_of = make_grads_fn(cfg, plan, opt, compute_dtype, microbatches)

    def train_step(params, opt_state, batch):
        with _spmd(params):
            loss, metrics, grads = grads_of(params, batch)
            lr_t = cosine_with_warmup(opt_state["step"], opt.lr, warmup, total_steps)
            new_params, new_opt, opt_metrics = adamw_update(grads, opt_state, params, opt,
                                                            lr_t)
            # the layouts the step was given (the reference's out_shardings)
            new_params = relayout(new_params, params)
            new_opt = relayout(new_opt, opt_state)
        out = {"loss": loss, "lr": lr_t, **opt_metrics}
        out.update({k: v for k, v in metrics.items() if k != "loss"})
        return new_params, new_opt, out

    return train_step
