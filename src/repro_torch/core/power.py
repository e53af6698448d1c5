"""Area (Table 1) and event-metered energy of the IP2 front-end (paper
§2.1.3).

:class:`AreaBudget` reproduces Table 1 (65 nm: 485 µm² -> 22.0 µm pitch).
:class:`EventCounts` counts what costs energy (ADC conversions, DAC loads,
cap charges, CDS samples, dumps, comparator/OpAmp windows);
:class:`EnergyMeter` prices any bag of counts. Pricing is plain arithmetic
on the leaves, so it works on Python floats, numpy arrays and tensors.
:func:`power_report` is the meter on the paper's closed-form steady-state
counts (:func:`steady_state_events`), in Python float64 as the reference
computes it. The delta-gated backend's executed MACs are counted in closed
form by :func:`backend_frame_macs`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

# Table 1: in-pixel circuit size per pixel, 65 nm (name, count, unit µm²)
TABLE1_ROWS = (
    ("Photo Sensor", 1, 64.0),
    ("Cap 30 fF", 3, 64.0),
    ("Transistors", 41, 5.0),
    ("Wiring", 1, 16.0),
    ("Margin", 1, 8.0),
)


@dataclasses.dataclass(frozen=True)
class AreaBudget:
    rows: tuple = TABLE1_ROWS

    def totals(self) -> dict:
        total = sum(n * s for _, n, s in self.rows)
        out = {name: {"count": n, "unit_um2": s, "total_um2": n * s,
                      "occupancy": n * s / total}
               for name, n, s in self.rows}
        out["Total"] = {"total_um2": total, "pitch_um": math.sqrt(total)}
        return out


@dataclasses.dataclass(frozen=True)
class EnergyConstants:
    """Per-event energies / static currents, 65 nm-plausible defaults."""

    e_adc_j: float = 4.0e-9
    e_dac_j: float = 0.5e-9
    cap_f: float = 30e-15
    v_dd: float = 1.0
    mean_signal_v: float = 0.1
    i_pwm_comparator_a: float = 20e-9
    i_opamp_a: float = 2e-6
    compute_duty: float = 0.5
    e_pixel_dump_j: float = 1e-15
    e_sign_cmp_j: float = 5e-14
    e_dac_reprogram_j: float = 2e-9
    e_backend_mac_j: float = 1e-12


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    n_pixels: float = 2.0e6
    frame_hz: float = 30.0
    patch_h: int = 32
    patch_w: int = 32
    n_vectors: int = 400
    active_fraction: float = 0.25


class EventCounts(NamedTuple):
    """One frame's (or one window's) energy-costing events; leaves may be
    scalars or slot-major tensors."""

    adc_conversions: object = 0.0
    dac_loads: object = 0.0
    cap_charges: object = 0.0
    cds_samples: object = 0.0
    pixel_dumps: object = 0.0
    pwm_pixel_frames: object = 0.0
    opamp_patch_frames: object = 0.0
    sign_comparisons: object = 0.0
    dac_reprograms: object = 0.0
    backend_macs: object = 0.0

    def add(self, other: "EventCounts") -> "EventCounts":
        return EventCounts(*(a + b for a, b in zip(self, other)))

    def scale(self, s) -> "EventCounts":
        return EventCounts(*(a * s for a in self))

    @classmethod
    def zeros(cls) -> "EventCounts":
        return cls()


def frontend_frame_events(
    n_pixels: float,
    pixels_per_patch: int,
    n_vectors: int,
    n_selected_patches,
    n_converted_patches,
    readout: str = "adc",
) -> EventCounts:
    """The events one compact frontend frame executes. ``readout="adc"``
    converts every (patch, vector) output at the edge ADC; ``"sign"``
    fires one comparator instead: the same count, as ``sign_comparisons``.
    The ``0·count`` terms broadcast the per-frame constants to the batch
    shape."""
    if readout not in ("adc", "sign"):
        raise ValueError(f"unknown readout mode {readout!r}")
    n2 = pixels_per_patch
    m = n_vectors
    converted_px = n_converted_patches * n2
    conversions = n_converted_patches * m
    return EventCounts(
        adc_conversions=conversions if readout == "adc" else 0.0 * conversions,
        dac_loads=0.0 * n_converted_patches + float(m * n2),
        cap_charges=converted_px * m,
        cds_samples=0.0 * n_converted_patches + 2.0 * n_pixels,
        pixel_dumps=n_pixels - n_selected_patches * n2,
        pwm_pixel_frames=converted_px,
        opamp_patch_frames=1.0 * n_converted_patches,
        sign_comparisons=conversions if readout == "sign" else 0.0 * conversions,
        dac_reprograms=0.0 * n_converted_patches,
        backend_macs=0.0 * n_converted_patches,
    )


def conv_frame_events(n_pixels: float, pixels_per_window: int, n_channels: int,
                      n_windows, readout: str = "adc",
                      reprogram: bool = False) -> EventCounts:
    """The events one conv-in-pixel frame executes. Conv is dense: each of
    the ``n_windows`` K×K windows (overlapping when stride < K) runs one
    charge-share cycle per channel, so overlap is counted, never averaged;
    no patch deselects, so nothing is dumped. The one K²×C kernel bank is
    broadcast every frame (``dac_loads``); ``reprogram=True`` prices
    cycling kernel banks through it, C·K² register rewrites per frame
    (``dac_reprograms``)."""
    if readout not in ("adc", "sign"):
        raise ValueError(f"unknown readout mode {readout!r}")
    k2 = pixels_per_window
    c = n_channels
    window_px = n_windows * k2
    conversions = n_windows * c
    return EventCounts(
        adc_conversions=conversions if readout == "adc" else 0.0 * conversions,
        dac_loads=0.0 * n_windows + float(c * k2),
        cap_charges=window_px * c,
        cds_samples=0.0 * n_windows + 2.0 * n_pixels,
        pixel_dumps=0.0 * n_windows,
        pwm_pixel_frames=window_px,
        opamp_patch_frames=1.0 * n_windows,
        sign_comparisons=conversions if readout == "sign" else 0.0 * conversions,
        dac_reprograms=(0.0 * n_windows + float(c * k2)) if reprogram
        else 0.0 * n_windows,
        backend_macs=0.0 * n_windows,
    )


def backend_frame_macs(n_vectors: int, d_model: int, d_ff: int, n_classes: int,
                       j_embed, j_qkv, q_attn, n_keys, computed=1.0):
    """MACs of one delta-gated backend frame: ``j_embed`` re-embedded rows
    (M·d each), per layer ``j_qkv[l]`` fresh Q/K/V rows (3·d²) and
    ``q_attn[l]`` re-attended query rows (2·n_keys·d + d² + 2·d·d_ff), plus
    the pool and head (C·d) when the frame ran (``computed``)."""
    d = d_model
    per_attn = 2.0 * n_keys * d + float(d * d) + 2.0 * d * d_ff
    layers = 0.0
    for j_l, q_l in zip(j_qkv, q_attn):
        layers = layers + j_l * (3.0 * d * d) + q_l * per_attn
    return (j_embed * (float(n_vectors) * d) + layers
            + computed * float(n_classes * d))


def dense_backend_macs(n_tokens, n_layers: int, n_vectors: int, d_model: int,
                       d_ff: int, n_classes: int):
    """MACs of the dense backend on ``n_tokens`` valid rows."""
    return backend_frame_macs(
        n_vectors, d_model, d_ff, n_classes, j_embed=n_tokens,
        j_qkv=[n_tokens] * n_layers, q_attn=[n_tokens] * n_layers,
        n_keys=n_tokens, computed=1.0)


def steady_state_events(cfg: SensorConfig, readout: str = "adc") -> EventCounts:
    """The paper's closed-form per-frame counts: a fraction ``f`` of the
    patches selected and converted every frame, no temporal reuse."""
    n2 = cfg.patch_h * cfg.patch_w
    n_patches = cfg.n_pixels / n2
    f = cfg.active_fraction
    return frontend_frame_events(
        n_pixels=cfg.n_pixels, pixels_per_patch=n2, n_vectors=cfg.n_vectors,
        n_selected_patches=n_patches * f, n_converted_patches=n_patches * f,
        readout=readout)


class PowerBreakdown(NamedTuple):
    components: dict            # name -> W
    total_w: object

    def share(self) -> dict:
        return {k: v / self.total_w for k, v in self.components.items()}

    @property
    def dominant(self) -> str:
        """Largest component (call on unbatched breakdowns)."""
        return max(self.components, key=lambda k: float(self.components[k]))


@dataclasses.dataclass(frozen=True)
class EnergyMeter:
    """Prices :class:`EventCounts` with :class:`EnergyConstants`."""

    k: EnergyConstants = EnergyConstants()

    def energy_j(self, ev: EventCounts, frame_hz: float) -> dict:
        k = self.k
        e_cap = k.cap_f * k.mean_signal_v * k.v_dd
        e_cds = 0.5 * k.cap_f * k.v_dd ** 2
        window_s = k.compute_duty / frame_hz
        return {
            "adc": ev.adc_conversions * k.e_adc_j,
            "weight_dac": ev.dac_loads * k.e_dac_j,
            "cap_charging": ev.cap_charges * e_cap,
            "pwm_comparators": ev.pwm_pixel_frames
            * k.i_pwm_comparator_a * k.v_dd * window_s,
            "opamps": ev.opamp_patch_frames * k.i_opamp_a * k.v_dd * window_s,
            "cds_sampling": ev.cds_samples * e_cds,
            "pixel_dump": ev.pixel_dumps * k.e_pixel_dump_j,
            "sign_comparators": ev.sign_comparisons * k.e_sign_cmp_j,
            "weight_reprogram": ev.dac_reprograms * k.e_dac_reprogram_j,
            "backend": ev.backend_macs * k.e_backend_mac_j,
        }

    def power_w(self, ev: EventCounts, frame_hz: float,
                n_frames: float = 1.0) -> PowerBreakdown:
        e = self.energy_j(ev, frame_hz)
        scale = frame_hz / n_frames
        comp = {name: v * scale for name, v in e.items()}
        return PowerBreakdown(comp, sum(comp.values()))

    def power_mw(self, ev: EventCounts, frame_hz: float, n_frames: float = 1.0):
        """Total milliwatts only."""
        return self.power_w(ev, frame_hz, n_frames).total_w * 1e3

    def slot_recompute_power_w(self, pixels_per_patch: int, n_vectors: int,
                               frame_hz: float) -> float:
        """Marginal power of re-projecting and converting one more patch
        every frame: the governor's control gain."""
        ev = EventCounts(
            adc_conversions=float(n_vectors),
            cap_charges=float(pixels_per_patch * n_vectors),
            pwm_pixel_frames=float(pixels_per_patch),
            opamp_patch_frames=1.0,
        )
        return self.power_w(ev, frame_hz).total_w


class PowerReport(NamedTuple):
    """The analytical front-end power report (the meter on the
    steady-state events); ``share`` and ``dominant`` are
    :class:`PowerBreakdown`'s."""

    components: dict            # name -> W
    total_w: float
    mw_per_mpix: float

    def _breakdown(self) -> PowerBreakdown:
        return PowerBreakdown(self.components, self.total_w)

    def share(self) -> dict:
        return self._breakdown().share()

    @property
    def dominant(self) -> str:
        return self._breakdown().dominant

    @property
    def adc_dominated(self) -> bool:
        return self.dominant == "adc"


def power_report(cfg: SensorConfig, k: EnergyConstants = EnergyConstants()) -> PowerReport:
    """Per-component front-end power and totals: :class:`EnergyMeter` on
    :func:`steady_state_events`, so the closed-form report and the runtime
    meter are one arithmetic. Excludes the digital interface, as the
    paper's figure does."""
    bd = EnergyMeter(k).power_w(steady_state_events(cfg), cfg.frame_hz)
    return PowerReport(components=bd.components, total_w=bd.total_w,
                       mw_per_mpix=bd.total_w * 1e3 / (cfg.n_pixels / 1e6))


def data_reduction(cfg: SensorConfig, vs_rgb: bool = False) -> float:
    """Input samples per frame over output features per frame (paper: 10x,
    30x against the Bayer->RGB interpolation)."""
    n2 = cfg.patch_h * cfg.patch_w
    n_patches = cfg.n_pixels / n2
    out = n_patches * cfg.active_fraction * cfg.n_vectors
    inp = cfg.n_pixels * (3.0 if vs_rgb else 1.0)
    return inp / out
