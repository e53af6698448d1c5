"""Switched-capacitor charge-sharing summer and its leakage (paper §2.1.2).

Charge sharing over the N² pixel caps divides the weighted sum by N²; the
summing node droops by leakage (passive) or by the OpAmp's finite gain.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch._arith import div

# Calibrated so the passive summer loses 10% in 10 microseconds (paper datum).
TAU_LEAK_65NM_S = -10e-6 / math.log(0.9)  # ≈ 94.91 µs
# 22 nm FDSOI thick-ox switches: ~two decades lower leakage.
TAU_LEAK_22NM_FDX_S = TAU_LEAK_65NM_S * 100.0


@dataclasses.dataclass(frozen=True)
class SummerSpec:
    """Static config of the per-patch summing circuit."""

    mode: str = "opamp"            # "opamp" | "passive"
    tau_leak_s: float = TAU_LEAK_65NM_S
    hold_time_s: float = 10e-6     # time from switch close to ADC sample
    opamp_dc_gain: float = 10_000.0  # A0, 80 dB typical for a small OTA
    v_ref: float = 0.0             # V_R bias added at the amplifier

    def droop_factor(self) -> float:
        """Multiplicative signal retention after hold_time."""
        if self.mode == "passive":
            return math.exp(-self.hold_time_s / self.tau_leak_s)
        # OpAmp virtual ground: only the closed-loop gain error remains
        return self.opamp_dc_gain / (1.0 + self.opamp_dc_gain)


def charge_share_sum(charges: torch.Tensor, spec: SummerSpec = SummerSpec(),
                     axis: int = -1) -> torch.Tensor:
    """Charge-conserving summation onto the patch node: ``V_R + droop ·
    mean(charges, axis)``, the OpAmp output the ADC sees. ``axis`` runs
    over the N² capacitors of one patch."""
    mean = torch.mean(charges, dim=axis)
    return spec.v_ref + spec.droop_factor() * mean


def passive_droop_trace(v0: torch.Tensor, times_s: torch.Tensor,
                        tau_leak_s: float = TAU_LEAK_65NM_S) -> torch.Tensor:
    """V(t) = V0 · exp(-t / tau) of a passive summing node."""
    return v0 * torch.exp(div(-times_s, tau_leak_s))


def capacitor_divider(v: torch.Tensor, n_extra_caps: int) -> torch.Tensor:
    """Quantised division: one charged cap shared with ``n_extra_caps``
    discharged ones divides its voltage by ``1 + n_extra_caps``."""
    return div(v, 1.0 + float(n_extra_caps))


def series_add(v_a: torch.Tensor, v_b: torch.Tensor, subtract: bool = False) -> torch.Tensor:
    """Series connection of two cap voltages; ``subtract`` reverses the
    second capacitor's polarity first."""
    return v_a - v_b if subtract else v_a + v_b
