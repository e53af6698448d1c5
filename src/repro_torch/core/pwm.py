"""PWM / weight-DAC quantization models (paper §2.1).

Both factors of the in-pixel multiply ``Q = I(w) * t(P)`` are quantized:
the pixel to a pulse width on the PWM clock grid, the weight by a signed
current DAC. Straight-through gradients are kept as ``exact + (q -
exact).detach()``, the same expression as the reference, so the forward
value is bit-for-bit the reference's too.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._arith import div

DEFAULT_PWM_BITS = 6
DEFAULT_WEIGHT_BITS = 6


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of the analog quantization in the pixel array."""

    pwm_bits: int = DEFAULT_PWM_BITS        # pixel -> pulse-width converter
    weight_bits: int = DEFAULT_WEIGHT_BITS  # weight current DAC (signed)
    ste: bool = True                        # straight-through gradients

    @property
    def pwm_levels(self) -> int:
        return 2 ** self.pwm_bits

    @property
    def weight_levels(self) -> int:
        # signed DAC: symmetric around zero, e.g. 6 bits -> [-31, 31]
        return 2 ** (self.weight_bits - 1) - 1


def _ste(exact: torch.Tensor, quantized: torch.Tensor, enable: bool) -> torch.Tensor:
    """Straight-through estimator: forward=quantized, backward=identity."""
    if not enable:
        return quantized
    return exact + (quantized - exact).detach()


def pwm_quantize(pixels: torch.Tensor, spec: QuantSpec = QuantSpec()) -> torch.Tensor:
    """Pixel intensity in [0, 1] -> pulse width on the grid k / (2**bits - 1).
    Divides by n (the kernels multiply by 1/n; the two are kept apart)."""
    n = spec.pwm_levels - 1
    clipped = torch.clamp(pixels, 0.0, 1.0)
    q = div(torch.round(clipped * n), n)
    return _ste(clipped, q, spec.ste)


def quantize_weights(
    weights: torch.Tensor,
    spec: QuantSpec = QuantSpec(),
    per_output_scale: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weight matrix (..., n_out, n_in) -> (DAC-grid weights, scale).

    One DAC full-scale per output row by default; ``codes =
    round(weights / scale)`` are integers in [-L, L]."""
    levels = spec.weight_levels
    if per_output_scale:
        amax = torch.amax(torch.abs(weights), dim=-1, keepdim=True)
    else:
        amax = torch.amax(torch.abs(weights))
    scale = div(torch.clamp_min(amax, 1e-12), levels)
    codes = torch.clamp(torch.round(weights / scale), -levels, levels)
    w_q = codes * scale
    return _ste(weights, w_q, spec.ste), scale
