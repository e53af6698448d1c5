"""Shared layers: dense init, RMS norm, the GELU MLP. Parameters are plain
dicts of tensors in the reference's layouts."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(generator: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    """(d_in, d_out) normal / sqrt(d_in), drawn on the CPU."""
    scale = 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=generator, dtype=torch.float32) * scale


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * gamma.to(torch.float32)).to(dt)


def init_mlp(generator: torch.Generator, d: int, d_ff: int, kind: str = "gelu") -> dict:
    if kind != "gelu":
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
    return {
        "w_up": dense_init(generator, d, d_ff),
        "b_up": torch.zeros((d_ff,), dtype=torch.float32),
        "w_down": dense_init(generator, d_ff, d),
        "b_down": torch.zeros((d,), dtype=torch.float32),
    }


def apply_mlp(p: dict, x: torch.Tensor, kind: str = "gelu") -> torch.Tensor:
    if kind != "gelu":
        raise NotImplementedError(f"mlp kind {kind!r} is not ported yet")
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh") @ p["w_down"] + p["b_down"]
