"""The sensor-to-features path on the compact dataflow (paper Fig. 1/2).

scene RGB -> optics AA filter -> Bayer mosaic -> patch grid -> select k
salient patches -> analog projection -> edge ADC -> int8 codes (the wire).

Ported so far: the compact mode without the temporal cache, on the code
wire, with selection by indices, mask or patch energy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import adc as adc_mod
from repro_torch.core import bayer as bayer_mod
from repro_torch.core import power as power_mod
from repro_torch.core import projection as proj_mod
from repro_torch.core import saliency as sal_mod
from repro_torch.core import temporal as temporal_mod


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    image_h: int = 256
    image_w: int = 256
    patch: proj_mod.PatchSpec = proj_mod.PatchSpec(patch_h=32, patch_w=32, n_vectors=400)
    analog: bool = True
    bayer: bool = True                 # raw mosaic input (HW); False = RGB (sim)
    aa_cutoff: float | None = 0.5      # Gaussian AA at 0.5/0.25 Nyquist; None = off
    active_fraction: float = 0.25
    adc: adc_mod.ADCSpec = adc_mod.ADCSpec()
    temporal: temporal_mod.TemporalSpec = temporal_mod.TemporalSpec()

    @property
    def grid(self) -> tuple[int, int]:
        return (self.image_h // self.patch.patch_h, self.image_w // self.patch.patch_w)

    @property
    def n_patches(self) -> int:
        gh, gw = self.grid
        return gh * gw

    @property
    def n_active(self) -> int:
        return max(1, int(round(self.n_patches * self.active_fraction)))


class CompactFeatures(NamedTuple):
    """The bandwidth-true frontend output: only the k active patches, as
    int8 ADC codes (or the float32 STE readout with ``wire="float"``), plus
    the static dequant metadata, the per-token gain, the full-grid patch
    energy proxy and this frame's energy events."""

    features: torch.Tensor   # (..., k, M) int8 codes (or f32, wire="float")
    indices: torch.Tensor    # (..., k) int32 patch indices
    valid: torch.Tensor      # (..., k) bool
    energy: torch.Tensor     # (..., P) float32 patch-energy proxy
    scale: torch.Tensor      # () float32 — ADC LSB (volts per code)
    zero: torch.Tensor       # (M,) float32 — dequant offset incl. V_R - b
    gain: torch.Tensor       # (..., k) float32 — valid mask
    events: power_mod.EventCounts = power_mod.EventCounts()


class CompactSelection(NamedTuple):
    """The resolved selection before any projection is spent, shared by
    the staged and fused compact paths."""

    patches: torch.Tensor    # (..., P, N) dense CDS patch voltages
    weights: torch.Tensor    # (M, N) effective projection weights
    indices: torch.Tensor    # (..., k) int32 ranked patch indices
    valid: torch.Tensor      # (..., k) bool prefix mask
    energy: torch.Tensor     # (..., P) float32 patch-energy proxy


ProjectFn = Callable[[torch.Tensor, torch.Tensor, proj_mod.PatchSpec], torch.Tensor]


def dequantize_features(cf: CompactFeatures) -> torch.Tensor:
    """The one permitted dequant site: codes -> float32 readout through the
    static affine, times the per-token gain."""
    return adc_mod.dequantize(cf.features, cf.scale, cf.zero) * cf.gain[..., None]


def init_frontend_params(cfg: FrontendConfig, generator: torch.Generator) -> dict:
    """A in vectorized-RGB space (M, N²·3), std 0.4·√N² (full-scale match
    to the /N² charge share), drawn on the CPU from ``generator``."""
    n2 = cfg.patch.pixels_per_patch
    m = cfg.patch.n_vectors
    scale = 0.4 * torch.sqrt(torch.tensor(n2, dtype=torch.float32))
    a = torch.randn((m, n2 * 3), generator=generator, dtype=torch.float32) * scale
    return {"a_rgb": a, "bias": torch.zeros((m,), dtype=torch.float32)}


def sensor_patches(
    params: dict, rgb: torch.Tensor, cfg: FrontendConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Optics + mosaic + patch extraction: rgb (..., H, W, 3) ->
    (patches (..., P, N), effective weights (M, N))."""
    p = cfg.patch
    if cfg.aa_cutoff is not None:
        rgb = bayer_mod.antialias(rgb.movedim(-1, -3), cfg.aa_cutoff).movedim(-3, -1)
    if cfg.analog or cfg.bayer:
        frame = bayer_mod.mosaic(rgb)
        patches = proj_mod.extract_patches(frame, p.patch_h, p.patch_w)
        weights = bayer_mod.strike_columns(params["a_rgb"], p.patch_h, p.patch_w)
    else:
        per_c = [proj_mod.extract_patches(rgb[..., c], p.patch_h, p.patch_w)
                 for c in range(3)]
        patches = torch.cat(per_c, dim=-1)
        weights = params["a_rgb"]
    return patches, weights


def feature_scale_zero(params: dict, cfg: FrontendConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Static (scale, zero) dequant metadata of this frontend's code wire."""
    return adc_mod.readout_scale_zero(cfg.patch.summer.v_ref, params["bias"], cfg.adc)


def project_wire(
    patches: torch.Tensor,
    weights: torch.Tensor,
    cfg: FrontendConfig,
    project_fn: ProjectFn | None,
) -> torch.Tensor:
    """Project a gathered patch set onto the code wire: int8 ADC codes,
    straight from a kernel adapter that advertises ``emits_codes``, else
    the plain projection encoded here. (The float and sign wires are not
    ported yet.)"""
    if not cfg.analog:
        raise NotImplementedError("the float simulation (analog=False) has no "
                                  "code wire; its float wire is not ported yet")
    if project_fn is not None and getattr(project_fn, "emits_codes", False):
        return project_fn(patches, weights, cfg.patch)
    out_v = (project_fn or proj_mod.analog_project_patches)(patches, weights, cfg.patch)
    return adc_mod.encode(out_v, cfg.adc)


def select_compact(
    params: dict,
    rgb: torch.Tensor,
    cfg: FrontendConfig,
    mask: torch.Tensor | None = None,
    indices: torch.Tensor | None = None,
    precomputed: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> CompactSelection:
    """Resolve the compact selection: ``indices`` > ``mask`` > energy top-k."""
    k = cfg.n_active
    if precomputed is not None:
        patches, weights = precomputed
    else:
        patches, weights = sensor_patches(params, rgb, cfg)
    energy = sal_mod.patch_energy(patches)
    if indices is not None:
        idx = indices.to(torch.int32)
        if idx.shape[-1] != k:
            raise ValueError(f"indices last dim {idx.shape[-1]} != n_active {k}")
        valid = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    elif mask is not None:
        idx, valid = sal_mod.indices_from_mask(mask, k)
    else:
        idx = sal_mod.topk_patch_indices(energy, k)
        valid = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    return CompactSelection(patches, weights, idx, valid, energy)


def apply_frontend(
    params: dict,
    rgb: torch.Tensor,
    cfg: FrontendConfig,
    mask: torch.Tensor | None = None,
    project_fn: ProjectFn | None = None,
    mode: str = "compact",
    indices: torch.Tensor | None = None,
    precomputed: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> CompactFeatures:
    """rgb (..., H, W, 3) in [0,1] -> :class:`CompactFeatures` on the
    compact path: select -> gather -> project only the k active patches."""
    if mode != "compact":
        raise NotImplementedError(f"mode={mode!r} is not ported yet")
    sel = select_compact(params, rgb, cfg, mask=mask, indices=indices,
                         precomputed=precomputed)
    active = sal_mod.gather_patches(sel.patches, sel.indices)
    payload = project_wire(active, sel.weights, cfg, project_fn)
    scale, zero = feature_scale_zero(params, cfg)
    n_selected = torch.sum(sel.valid, dim=-1).to(torch.float32)
    events = power_mod.frontend_frame_events(
        float(cfg.image_h * cfg.image_w), cfg.patch.pixels_per_patch,
        cfg.patch.n_vectors, n_selected_patches=n_selected,
        n_converted_patches=n_selected,
    )
    return CompactFeatures(payload, sel.indices, sel.valid, sel.energy, scale,
                           zero, sel.valid.to(torch.float32), events)
