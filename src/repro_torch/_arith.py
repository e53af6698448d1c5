"""Arithmetic helpers that keep the reference's float32 rounding, and
device constants made without a host-to-device copy."""

from __future__ import annotations

import torch


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true float32 division by ``float32(c)``.

    On CUDA, PyTorch turns a division by a Python scalar into a
    multiplication by its reciprocal, which rounds differently (and moves
    PWM levels and ADC codes at their boundaries). Dividing by a 0-dim
    tensor on the same device keeps the IEEE division on every device; the
    divisor is filled on that device, so no host-to-device copy (and no
    host sync) is made."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def clip(x: torch.Tensor, lo: float | None = None, hi: float | None = None) -> torch.Tensor:
    """``clip(x, lo, hi)`` with JAX's gradient at the rails.

    ``jnp.clip`` is ``minimum(maximum(x, lo), hi)``, and JAX splits the
    gradient of a tie between the two operands: 0.5 at ``x`` exactly on a
    rail, where ``torch.clamp`` passes 1. ``torch.maximum`` /
    ``torch.minimum`` against 0-dim bounds split it the same way and give
    ``torch.clamp``'s forward bit for bit. The bounds are filled on
    ``x``'s device (no host-to-device copy, no host sync). ``None`` leaves
    that side open."""
    if lo is not None:
        x = torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.full((), hi, dtype=x.dtype, device=x.device))
    return x


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(int32)`` as JAX casts a float: saturating at the int32
    range (``inf`` too), NaN to 0. PyTorch's cast wraps an out-of-range
    value (3e10 becomes -2**31). Device ops only, no host sync."""
    big = x >= 2147483648.0
    y = torch.clamp(torch.nan_to_num(x, nan=0.0), -2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(big, torch.full_like(y, 2147483647), y)


_VECTORS: dict = {}


def const_vector(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A 1-D tensor of Python numbers on ``device``, filled there element by
    element (no host-to-device copy, so no host sync) and cached per
    (values, dtype, device). Shared: callers never write into it."""
    key = (tuple(values), dtype, torch.device(device))
    out = _VECTORS.get(key)
    if out is None:
        with torch.inference_mode(False):  # usable outside inference mode too
            out = torch.stack([torch.full((), v, dtype=dtype, device=device)
                               for v in values])
        _VECTORS[key] = out
    return out
