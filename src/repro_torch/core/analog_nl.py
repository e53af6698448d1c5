"""2-transistor current-mode nonlinearity with rail saturation (paper §2.1)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._arith import clip


@dataclasses.dataclass(frozen=True)
class AnalogNLSpec:
    kind: str = "relu"     # "relu" | "sigmoid" | "none"
    v_sat: float = 1.0     # output rail (normalized full scale)
    sigmoid_gain: float = 4.0  # transconductance slope at the bias point


def analog_nonlinearity(v: torch.Tensor, spec: AnalogNLSpec = AnalogNLSpec()) -> torch.Tensor:
    if spec.kind == "none":
        return clip(v, -spec.v_sat, spec.v_sat)
    if spec.kind == "relu":
        return clip(v, 0.0, spec.v_sat)
    if spec.kind == "sigmoid":
        # torch.sigmoid is the overflow-safe form (no exp(-g·v) to inf)
        return torch.sigmoid(spec.sigmoid_gain * v) * spec.v_sat
    raise ValueError(f"unknown analog nonlinearity {spec.kind!r}")
