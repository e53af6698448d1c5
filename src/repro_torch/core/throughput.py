"""Fig. 3 processing-rate model (paper §2.1.4), plain Python.

One output vector's weights are broadcast to every patch over C
weight-voltage lines per pixel column, so a patch of ``patch_rows`` rows
needs ``ceil(patch_rows / C)`` weight-load cycles per vector, then one PWM
compute window:

    t_vector = t_load · ceil(patch_rows / C) + t_pwm
    t_frame  = M · t_vector          (all patches compute in parallel)
    rate     = sensor_pixels / t_frame   [pix/s]

t_pwm is the 10 µs summing/hold window of §2.1.2; t_load = 1.1 µs gives
the paper's operating point, 1080p at C = 2 and 400 vectors per 32×32
patch -> ~90 Hz.
"""

from __future__ import annotations

import dataclasses
import math

T_LOAD_S = 1.1e-6   # weight-line DAC settle per row-group
T_PWM_S = 10.0e-6   # PWM charging + charge-share window (= §2.1.2 hold time)

SENSOR_FORMATS = {
    "720p": (1280, 720),
    "1080p": (1920, 1080),
}


@dataclasses.dataclass(frozen=True)
class RatePoint:
    fmt: str
    c_lines: int
    patch: int
    n_vectors: int
    frame_hz: float
    mpix_per_s: float
    t_vector_s: float


def vector_time(patch_rows: int, c_lines: int,
                t_load: float = T_LOAD_S, t_pwm: float = T_PWM_S) -> float:
    return t_load * math.ceil(patch_rows / c_lines) + t_pwm


def frame_rate(patch: int, n_vectors: int, c_lines: int) -> float:
    return 1.0 / (n_vectors * vector_time(patch, c_lines))


def rate_point(fmt: str, c_lines: int, patch: int, n_vectors: int) -> RatePoint:
    w, h = SENSOR_FORMATS[fmt]
    tv = vector_time(patch, c_lines)
    hz = 1.0 / (n_vectors * tv)
    return RatePoint(fmt, c_lines, patch, n_vectors, hz, w * h * hz / 1e6, tv)


def figure3_sweep() -> list[RatePoint]:
    """The Fig. 3b grid: 720p/1080p × 400/768 vectors per 32×32 × C in
    {1, 2, 4, 8}."""
    return [rate_point(fmt, c, 32, nv)
            for fmt in ("720p", "1080p") for nv in (400, 768) for c in (1, 2, 4, 8)]
