"""Edge ADC model (paper §2.1) and the digital wire format.

What crosses the imager boundary is the ADC code: signed integer codes
plus static ``(scale, zero)`` metadata, ``digital_v = code * scale +
zero`` with ``scale = lsb`` and ``zero = v_min + half·lsb - V_R + b``.
The float readout is defined as the dequantized codes, so the two views
agree bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch._arith import clip, div


@dataclasses.dataclass(frozen=True)
class ADCSpec:
    bits: int = 8
    v_min: float = -1.0
    v_max: float = 1.0
    ste: bool = True

    @property
    def levels(self) -> int:
        return 2 ** self.bits

    @property
    def lsb(self) -> float:
        return (self.v_max - self.v_min) / (self.levels - 1)

    @property
    def code_dtype(self) -> torch.dtype:
        """Smallest signed integer dtype that holds the (centered) codes."""
        if self.bits <= 8:
            return torch.int8
        if self.bits <= 16:
            return torch.int16
        return torch.int32


class ADCCodes(NamedTuple):
    """One frame's conversions in wire format: integer codes plus the
    static affine metadata that dequantises them."""

    codes: torch.Tensor   # (..., M) signed integer codes (code_dtype)
    scale: torch.Tensor   # () float32, volts per LSB
    zero: torch.Tensor    # (M,) or () float32, v_min + half·lsb - (V_R - b)


def _code_grid(v: torch.Tensor, spec: ADCSpec) -> torch.Tensor:
    """Centered code values as float32: round half to even of
    ``(clip(v) - v_min) / lsb``, with a true division by the float32 LSB."""
    half = spec.levels // 2
    clipped = clip(v, spec.v_min, spec.v_max)
    return torch.round(div(clipped - spec.v_min, spec.lsb)) - half


def encode(v: torch.Tensor, spec: ADCSpec = ADCSpec()) -> torch.Tensor:
    """Voltage -> signed integer code (codes carry no gradients)."""
    return _code_grid(v, spec).to(spec.code_dtype)


def readout_scale_zero(
    v_ref: float, bias: torch.Tensor | float = 0.0, spec: ADCSpec = ADCSpec()
) -> tuple[torch.Tensor, torch.Tensor]:
    """The static ``(scale, zero)`` metadata of the code wire for a given
    reference and bias. Each constant is rounded to float32 once, filled
    on the bias's device (no host-to-device copy)."""
    half = spec.levels // 2
    dev = bias.device if isinstance(bias, torch.Tensor) else None
    scale = torch.full((), spec.lsb, dtype=torch.float32, device=dev)
    zero = torch.full((), spec.v_min + half * spec.lsb - v_ref, dtype=torch.float32,
                      device=dev)
    if isinstance(bias, torch.Tensor):
        return scale, zero + bias.to(torch.float32)
    return scale, zero + torch.full((), bias, dtype=torch.float32, device=dev)


def dequantize(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """codes -> float readout, the one affine allowed to leave code space."""
    return codes.to(torch.float32) * scale + zero


def digital_codes(out_v: torch.Tensor, v_ref: float, bias: torch.Tensor | float = 0.0,
                  spec: ADCSpec = ADCSpec()) -> ADCCodes:
    """ADC conversion in wire format: codes + ``(scale, zero)`` such that
    ``dequantize(*digital_codes(...)) == digital_readout(...)`` exactly."""
    scale, zero = readout_scale_zero(v_ref, bias, spec)
    return ADCCodes(encode(out_v, spec), scale, zero)


#: reconstruction magnitude of a sign-only readout (the event meter's
#: mean-signal calibration)
SIGN_V_MAG = 0.1


def sign_scale_zero(bias: torch.Tensor | float = 0.0, v_mag: float = SIGN_V_MAG
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The static ``(scale, zero)`` metadata of the sign wire:
    ``dequantize(bit, scale, zero) = ±v_mag + bias`` for bit in {0, 1}.
    Each constant is rounded to float32 once, filled on the bias's device
    (no host-to-device copy), as :func:`readout_scale_zero` does."""
    dev = bias.device if isinstance(bias, torch.Tensor) else None
    scale = torch.full((), 2.0 * v_mag, dtype=torch.float32, device=dev)
    mag = torch.full((), v_mag, dtype=torch.float32, device=dev)
    if isinstance(bias, torch.Tensor):
        return scale, bias.to(torch.float32) - mag
    return scale, torch.full((), bias, dtype=torch.float32, device=dev) - mag


def sign_encode(out_v: torch.Tensor, v_ref: float) -> torch.Tensor:
    """The ADC-less comparator: one bit per vector, ``out_v >= V_R``."""
    return out_v >= v_ref


def sign_code_points(v_ref: float, spec: ADCSpec = ADCSpec(),
                     v_mag: float = SIGN_V_MAG) -> tuple[int, int, int]:
    """The sign readout on the code grid: ``c' = c_pos if c >= c_thresh
    else c_neg``. ``c_thresh`` is the code of the comparator boundary
    ``out_v == V_R``; ``c_pos`` / ``c_neg`` dequantize through the wire's
    own ``(scale, zero)`` to ``±v_mag + bias``. Python ints, independent of
    the bias (the governor's sign tier applies them as data)."""
    half = spec.levels // 2
    lo, hi = -half, spec.levels - 1 - half
    v_r = min(max(v_ref, spec.v_min), spec.v_max)
    c_thresh = round((v_r - spec.v_min) / spec.lsb) - half
    # code*lsb + (v_min + half*lsb - v_ref) = ±v_mag  (the bias cancels)
    off = spec.v_min + half * spec.lsb - v_ref
    c_pos = min(max(round((v_mag - off) / spec.lsb), lo), hi)
    c_neg = min(max(round((-v_mag - off) / spec.lsb), lo), hi)
    return c_thresh, c_pos, c_neg


def adc_quantize(v: torch.Tensor, spec: ADCSpec = ADCSpec()) -> torch.Tensor:
    """Uniform mid-rise ADC over [v_min, v_max] on the voltage grid (no
    ``V_R - b`` subtraction), on the code grid of :func:`encode`, with an
    exact-forward STE (``lin - lin.detach()`` adds exactly 0.0)."""
    half = spec.levels // 2
    q = (_code_grid(v, spec) + half) * spec.lsb + spec.v_min
    if spec.ste:
        lin = clip(v, spec.v_min, spec.v_max)
        return q + (lin - lin.detach())
    return q


def digital_readout(
    out_v: torch.Tensor,
    v_ref: float,
    bias: torch.Tensor | float = 0.0,
    spec: ADCSpec = ADCSpec(),
) -> torch.Tensor:
    """ADC conversion followed by the digital ``V_R - b`` subtraction,
    defined as the dequantized codes plus an exact-forward STE residual."""
    deq = dequantize(*digital_codes(out_v, v_ref, bias, spec))
    if spec.ste:
        lin = clip(out_v, spec.v_min, spec.v_max)
        return deq + (lin - lin.detach())
    return deq
