"""Learning-rate schedules (pure functions of the step)."""

from __future__ import annotations

import math

import torch

from repro_torch._arith import clip, div


def cosine_with_warmup(step: torch.Tensor, base_lr: float, warmup: int, total: int,
                       min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_ratio * base_lr`` at ``total``; float32 on ``step``'s
    device."""
    step = step.to(torch.float32)
    warm = div(base_lr * step, max(warmup, 1))
    prog = clip(div(step - warmup, max(total - warmup, 1)), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
