"""AdamW with optional bfloat16 moments, as pure functions on dicts of
tensors (the reference's ``repro.optim.adamw``).

The state lives on the parameters' device, ``step`` included (an int32
0-dim tensor), so the bias corrections ``c1`` / ``c2`` are device tensors
and ``m / c1`` is a true division on every device: on CUDA a division by a
Python scalar would be a multiply by its reciprocal. Nothing in an update
reads a value back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.convert import tree_flatten_with_paths, tree_map, tree_unflatten
from repro_torch.models.sharding_ctx import P


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32   # torch.bfloat16 halves the state


def _full(v, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return torch.full((), v, dtype=dtype, device=like.device)


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` and ``step`` 0, each on its
    parameter's device."""
    first = tree_flatten_with_paths(params)[0][1]
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)  # noqa: E731
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def opt_state_specs(param_specs) -> dict:
    """Moments shard exactly like their parameters."""
    return {"m": param_specs, "v": param_specs, "step": P()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for _, x in tree_flatten_with_paths(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig, lr_t):
    """Returns ``(new_params, new_opt_state, {"grad_norm": ...})``. ``lr_t``
    is a 0-dim float32 tensor on the parameters' device or a Python float.
    Gradients are clipped to ``cfg.grad_clip`` by their global norm; the
    norm is reported unclipped. Runs without autograd."""
    with torch.no_grad():
        step = opt_state["step"] + 1
        gnorm = global_norm(grads)
        clip = torch.minimum(_full(1.0, gnorm),
                             _full(cfg.grad_clip, gnorm)
                             / torch.maximum(gnorm, _full(1e-9, gnorm)))
        b1, b2 = cfg.b1, cfg.b2
        step_f = step.to(torch.float32)
        c1 = 1.0 - torch.pow(_full(b1, step_f), step_f)
        c2 = 1.0 - torch.pow(_full(b2, step_f), step_f)
        if not isinstance(lr_t, torch.Tensor):
            lr_t = _full(lr_t, gnorm)

        def upd(g, m, v, p):
            g = g.to(torch.float32) * clip
            m32 = m.to(torch.float32) * b1 + g * (1.0 - b1)
            v32 = v.to(torch.float32) * b2 + g * g * (1.0 - b2)
            mhat = m32 / c1
            vhat = v32 / c2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
            newp = (p.to(torch.float32) - lr_t * delta).to(p.dtype)
            return newp, m32.to(cfg.moment_dtype), v32.to(cfg.moment_dtype)

        def leaves(tree):
            return [x for _, x in tree_flatten_with_paths(tree)]

        outs = [upd(*a) for a in zip(leaves(grads), leaves(opt_state["m"]),
                                     leaves(opt_state["v"]), leaves(params))]
        new_params, new_m, new_v = (tree_unflatten(params, [o[i] for o in outs])
                                    for i in range(3))
        return new_params, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm}
