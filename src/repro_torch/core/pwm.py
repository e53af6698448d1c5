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

from repro_torch._arith import clip, div

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
    clipped = clip(pixels, 0.0, 1.0)
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
    codes, scale = _dac_codes(weights, spec, per_output_scale)
    w_q = codes * scale
    return _ste(weights, w_q, spec.ste), scale


def _dac_codes(weights: torch.Tensor, spec: QuantSpec,
               per_output_scale: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Float DAC codes in [-L, L] and the full-scale ``max|w| / L`` (per
    output row, or one global)."""
    levels = spec.weight_levels
    if per_output_scale:
        amax = torch.amax(torch.abs(weights), dim=-1, keepdim=True)
    else:
        amax = torch.amax(torch.abs(weights))
    scale = div(torch.clamp_min(amax, 1e-12), levels)
    return torch.clamp(torch.round(weights / scale), -levels, levels), scale


def pwm_codes(pixels: torch.Tensor, spec: QuantSpec = QuantSpec()) -> torch.Tensor:
    """Integer PWM codes (the counter values driving the pulse generator),
    int32."""
    n = spec.pwm_levels - 1
    return torch.round(torch.clamp(pixels, 0.0, 1.0) * n).to(torch.int32)


def weight_codes(weights: torch.Tensor, spec: QuantSpec = QuantSpec(),
                 per_output_scale: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer DAC codes (int8) + float scale, for the integer-domain path."""
    codes, scale = _dac_codes(weights, spec, per_output_scale)
    return codes.to(torch.int8), scale


def analog_multiply(pixels: torch.Tensor, weights: torch.Tensor,
                    spec: QuantSpec = QuantSpec()) -> torch.Tensor:
    """The per-pixel charge ``Q_i = I(w_i) · t(P_i)``, both factors
    quantised, before charge sharing (``switched_cap`` sums it)."""
    p_q = pwm_quantize(pixels, spec)
    w_q, _ = quantize_weights(weights, spec)
    return w_q * p_q
