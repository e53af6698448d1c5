"""The sensor-to-features path (paper Fig. 1/2).

scene RGB -> optics AA filter -> Bayer mosaic -> patch grid -> select k
salient patches -> analog projection -> edge ADC -> the wire.

``analog=True`` is the circuit (Bayer patches, PWM / DAC quantisation,
charge share, droop, edge ADC); ``analog=False`` the float simulation
(full-RGB patches through the unquantised matrix, no ADC).

``mode="dense"`` projects every patch and zeroes the deselected ones
((..., P, M) float features and the mask); ``mode="compact"`` selects,
gathers and projects only the k active patches and returns
:class:`CompactFeatures` on one of three wires: ``"codes"`` (int ADC
codes), ``"float"`` (the STE readout, bitwise the dequantised codes) or
``"sign"`` (one comparator bit per vector). The compact path also takes
the governor's token shed (``k_cap``) and the temporal gate (``cache``,
``stale_cap``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch._arith import div
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
    int8 ADC codes (the float32 STE readout with ``wire="float"``, comparator
    bits with ``wire="sign"``), plus
    the static dequant metadata, the per-token gain, the full-grid patch
    energy proxy and this frame's energy events."""

    features: torch.Tensor   # (..., k, M) int8 codes (f32 wire="float", bool "sign")
    indices: torch.Tensor    # (..., k) int32 patch indices
    valid: torch.Tensor      # (..., k) bool
    energy: torch.Tensor     # (..., P) float32 patch-energy proxy
    scale: torch.Tensor      # () float32 — ADC LSB (sign wire: 2·v_mag)
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
    """The one permitted dequant site: the payload as float32 readout,
    times the per-token gain. Codes and sign bits go through the static
    affine; a float payload already is the (bitwise equal) readout."""
    feats = cf.features
    if not feats.is_floating_point():
        feats = adc_mod.dequantize(feats, cf.scale, cf.zero)
    return feats * cf.gain[..., None]


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


def _call_project_fn(fn, patches, weights, spec, row_counts):
    """Call a ProjectFn, handing the per-slot row counts only to adapters
    that advertise ``supports_row_counts`` (rows past a count come back
    zero, so callers pass counts only where those rows are discarded or
    gained out)."""
    if row_counts is not None and getattr(fn, "supports_row_counts", False):
        return fn(patches, weights, spec, row_counts=row_counts)
    return fn(patches, weights, spec)


def project_readout(
    patches: torch.Tensor,
    weights: torch.Tensor,
    params: dict,
    cfg: FrontendConfig,
    project_fn: ProjectFn | None,
    row_counts=None,
) -> torch.Tensor:
    """Projection plus the float readout over whatever patches it is
    handed (the full grid, or the gathered active set): the STE dequant of
    the ADC codes on the analog path (bitwise the code wire dequantised),
    or the float simulation ``A·p / n_in + b``."""
    if project_fn is not None and getattr(project_fn, "emits_codes", False):
        raise ValueError(
            "project_fn emits wire-format codes (ops.ip2_codes_fn) but this is a "
            "float path (dense mode or wire='float'): its int8 output is not analog "
            "voltage. Use ops.ip2_project_fn here, or mode='compact' with "
            "wire='codes'.")
    if project_fn is not None and getattr(project_fn, "emits_sign", False):
        raise ValueError(
            "project_fn emits the 1-bit sign wire (ops.ip2_sign_fn) but this is a "
            "float path (dense mode or wire='float'): its bool output is not analog "
            "voltage. Use ops.ip2_project_fn here, or mode='compact' with "
            "wire='sign'.")
    if cfg.analog:
        out_v = _call_project_fn(project_fn or proj_mod.analog_project_patches,
                                 patches, weights, cfg.patch, row_counts)
        return adc_mod.digital_readout(out_v, cfg.patch.summer.v_ref, params["bias"],
                                       cfg.adc)
    n_in = patches.shape[-1]
    return div(torch.einsum("...pi,vi->...pv", patches, weights), n_in) + params["bias"]


def project_wire(
    patches: torch.Tensor,
    weights: torch.Tensor,
    params: dict,
    cfg: FrontendConfig,
    project_fn: ProjectFn | None,
    wire: str,
    row_counts=None,
) -> torch.Tensor:
    """Project a gathered patch set onto the requested wire: ``"codes"``
    (int ADC codes, from an adapter that advertises ``emits_codes`` or
    encoded here), ``"float"`` (:func:`project_readout`) or ``"sign"``
    (bool comparator bits, from an adapter that advertises ``emits_sign``
    or compared against V_R here). Codes and signs need ``analog=True``.
    ``row_counts`` rides to ragged-capable adapters."""
    if wire == "float":
        return project_readout(patches, weights, params, cfg, project_fn,
                               row_counts=row_counts)
    if not cfg.analog:
        raise ValueError(
            f"wire={wire!r} requires analog=True: the float simulation has no edge "
            "ADC or comparator, so there is no digital wire — use wire='float' (the "
            "default resolution for analog=False)")
    emits_codes = project_fn is not None and getattr(project_fn, "emits_codes", False)
    emits_sign = project_fn is not None and getattr(project_fn, "emits_sign", False)
    if wire == "sign":
        if emits_codes:
            raise ValueError(
                "project_fn emits wire-format ADC codes (ops.ip2_codes_fn) but "
                "wire='sign' carries 1-bit comparator output — use ops.ip2_sign_fn "
                "(or a plain projector) here")
        if emits_sign:
            return _call_project_fn(project_fn, patches, weights, cfg.patch, row_counts)
        out_v = _call_project_fn(project_fn or proj_mod.analog_project_patches,
                                 patches, weights, cfg.patch, row_counts)
        return adc_mod.sign_encode(out_v, cfg.patch.summer.v_ref)
    if emits_sign:
        raise ValueError(
            "project_fn emits the 1-bit sign wire (ops.ip2_sign_fn) but wire='codes' "
            "carries int8 ADC codes — use ops.ip2_codes_fn (or a plain projector) here")
    if emits_codes:
        return _call_project_fn(project_fn, patches, weights, cfg.patch, row_counts)
    out_v = _call_project_fn(project_fn or proj_mod.analog_project_patches,
                             patches, weights, cfg.patch, row_counts)
    return adc_mod.encode(out_v, cfg.adc)


def _check_k_cap_ranked(k_cap, mask, indices) -> None:
    if k_cap is not None and mask is not None and indices is None:
        raise ValueError(
            "k_cap sheds trailing selection slots and therefore needs a selection "
            "ranked most-salient-first; mask-derived indices come out in ascending "
            "patch order (indices_from_mask), so the shed tokens would be arbitrary "
            "— pass ranked indices instead (see topk_patch_indices)")


def select_compact(
    params: dict,
    rgb: torch.Tensor,
    cfg: FrontendConfig,
    mask: torch.Tensor | None = None,
    indices: torch.Tensor | None = None,
    precomputed: tuple[torch.Tensor, torch.Tensor] | None = None,
    k_cap: torch.Tensor | None = None,
) -> CompactSelection:
    """Resolve the compact selection: ``indices`` > ``mask`` > energy top-k,
    then the governor's ``k_cap`` shed of the trailing slots (data only:
    shed slots are marked invalid)."""
    _check_k_cap_ranked(k_cap, mask, indices)
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
    if k_cap is not None:
        valid = valid & (torch.arange(k, device=idx.device) < k_cap[..., None])
    return CompactSelection(patches, weights, idx, valid, energy)


def apply_frontend(
    params: dict,
    rgb: torch.Tensor,
    cfg: FrontendConfig,
    mask: torch.Tensor | None = None,
    project_fn: ProjectFn | None = None,
    mode: str = "dense",
    indices: torch.Tensor | None = None,
    precomputed: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache: temporal_mod.FeatureCache | None = None,
    wire: str | None = None,
    k_cap: torch.Tensor | None = None,
    stale_cap: torch.Tensor | None = None,
):
    """rgb (..., H, W, 3) in [0,1] -> frontend features.

    Selection: ``indices`` (..., k) first, then ``mask`` (..., P), else the
    patch-energy top-k. ``mode="dense"`` returns ``(features (..., P, M),
    mask (..., P))``, float, deselected patches zeroed. ``mode="compact"``
    returns :class:`CompactFeatures` on ``wire`` (``None``: ``"codes"``
    when analog, ``"float"`` otherwise).

    Compact only: ``cache`` turns on the temporal gate (its dtype must
    match the wire): of the k selected patches only the stale ones
    (exactly j slots, ``n_stale`` of them real) are projected, the rest
    are served from the held payload, and the return value is
    ``(CompactFeatures, FeatureCache)``. ``k_cap`` (...,) sheds selection
    slots at or past it; ``stale_cap`` (...,) truncates the gate's
    recompute set (needs ``cache``). Both are data: no shape moves."""
    if mode not in ("dense", "compact"):
        raise ValueError(f"mode must be 'dense' or 'compact', got {mode!r}")
    if wire is None:
        wire = "codes" if cfg.analog else "float"
    if wire not in ("codes", "float", "sign"):
        raise ValueError(f"wire must be 'codes', 'float' or 'sign', got {wire!r}")
    if cache is not None and mode != "compact":
        raise ValueError("the temporal cache only applies to mode='compact'; dense "
                         "(training) execution must bypass it")
    if (k_cap is not None or stale_cap is not None) and mode != "compact":
        raise ValueError("k_cap/stale_cap are governor knobs of the compact serving "
                         "path; dense execution has no gate to cap")
    if stale_cap is not None and cache is None:
        raise ValueError("stale_cap caps the temporal gate's recompute allocation; "
                         "pass a FeatureCache (there is no gate to cap without one)")
    _check_k_cap_ranked(k_cap, mask, indices)
    if precomputed is None:
        precomputed = sensor_patches(params, rgb, cfg)

    if mode == "dense":
        patches, weights = precomputed
        if indices is not None:                  # same precedence as compact
            mask = sal_mod.mask_from_indices(indices, cfg.n_patches)
        elif mask is None:
            mask = sal_mod.topk_patch_mask(sal_mod.patch_energy(patches),
                                           cfg.active_fraction)
        feats = project_readout(patches, weights, params, cfg, project_fn)
        return sal_mod.apply_patch_mask(feats, mask), mask

    sel = select_compact(params, rgb, cfg, mask=mask, indices=indices,
                         precomputed=precomputed, k_cap=k_cap)
    idx, valid, energy = sel.indices, sel.valid, sel.energy
    # the sign wire: a 1-bit payload with the ±v_mag affine, whose
    # conversions are comparator firings
    readout = "sign" if wire == "sign" else "adc"
    if wire == "sign":
        scale, zero = adc_mod.sign_scale_zero(params["bias"])
    else:
        scale, zero = feature_scale_zero(params, cfg)
    n_pixels = float(cfg.image_h * cfg.image_w)
    n_selected = torch.sum(valid, dim=-1).to(torch.float32)
    if cache is None:
        # shed tokens (a prefix of valid) cost a ragged adapter nothing
        row_counts = (torch.sum(valid, dim=-1).to(torch.int32)
                      if k_cap is not None else None)
        payload = project_wire(sal_mod.gather_patches(sel.patches, idx), sel.weights,
                               params, cfg, project_fn, wire, row_counts=row_counts)
        events = power_mod.frontend_frame_events(
            n_pixels, cfg.patch.pixels_per_patch, cfg.patch.n_vectors,
            n_selected_patches=n_selected, n_converted_patches=n_selected,
            readout=readout)
        return CompactFeatures(payload, idx, valid, energy, scale, zero,
                               valid.to(torch.float32), events)

    # temporal gate: project only the stale subset, write it into the
    # held-charge cache and serve the whole selection from the cache
    cdt = cache.features.dtype
    cache_ok = (cdt.is_floating_point if wire == "float"
                else cdt == torch.bool if wire == "sign"
                else cdt.is_signed and not cdt.is_floating_point)
    if not cache_ok:
        dt = str(cdt).removeprefix("torch.")
        raise ValueError(f"cache dtype {dt} does not match wire={wire!r}; build it "
                         "with init_feature_cache(cfg, ..., dtype=...) to match")
    stale_idx, needed, n_stale = temporal_mod.select_stale(
        energy, idx, cache, cfg.temporal, cfg.patch.summer, cfg.adc,
        sel_valid=valid, cap=stale_cap)
    # stale-first ranking: n_stale is a prefix count, so a ragged adapter
    # skips the idle spare slots (refresh merges the needed rows only)
    new_feats = project_wire(sal_mod.gather_patches(sel.patches, stale_idx),
                             sel.weights, params, cfg, project_fn, wire,
                             row_counts=n_stale)
    cache = temporal_mod.refresh(cache, stale_idx, needed, new_feats, energy, n_stale)
    payload = temporal_mod.take_rows(cache.features, idx)
    gain = temporal_mod.held_gain(cache, idx, cfg.patch.summer) * valid.to(torch.float32)
    events = temporal_mod.gated_frame_events(
        n_pixels, cfg.patch.pixels_per_patch, cfg.patch.n_vectors,
        n_selected=n_selected, n_stale=n_stale.to(torch.float32), readout=readout)
    return CompactFeatures(payload, idx, valid, energy, scale, zero, gain, events), cache


def compact_features(feats: torch.Tensor, mask: torch.Tensor,
                     cfg: FrontendConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The bandwidth-true view of already computed dense features: the
    active patches gathered. ``apply_frontend(mode="compact")`` avoids
    computing the deselected ones in the first place."""
    return sal_mod.compact_active(feats, mask, cfg.n_active)
