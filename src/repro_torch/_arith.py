"""Arithmetic helpers that keep the reference's float32 rounding."""

from __future__ import annotations

import torch


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true float32 division by ``float32(c)``.

    On CUDA, PyTorch turns a division by a Python scalar into a
    multiplication by its reciprocal, which rounds differently (and moves
    PWM levels and ADC codes at their boundaries). Dividing by a 0-dim
    tensor on the same device keeps the IEEE division on every device."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)
