"""Temporal delta-gated execution: reuse held charge across frames
(paper §2.1.2 non-destructive readout).

A patch whose content has not changed since it was last projected keeps
its feature as charge on the summing caps, so of the k selected patches
only the *stale* ones are re-projected and converted; the rest are served
from a per-patch :class:`FeatureCache` of the wire's payload (ADC codes,
float32 readouts or sign bits).

* :func:`select_stale` picks exactly j patches to recompute (static
  shape): stale patches (energy moved by ``delta_threshold``, never
  computed, or held past the droop budget) rank first by hold age plus
  normalised energy delta, so ``n_stale`` is a prefix count of the j slots.
* :func:`refresh` ages every held entry and writes the recomputed stale
  rows back (only the ``needed`` ones).
* :func:`held_gain` folds the droop ``d^age`` in at serve time; stored
  codes are never aged in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core import adc as adc_mod
from repro_torch.core import power as power_mod


class FeatureCache(NamedTuple):
    """Held per-patch features over the full grid; leading dims are the
    batch/slot dims of the frames."""

    features: torch.Tensor   # (..., P, M) the wire's payload: codes, f32 or bool
    energy: torch.Tensor     # (..., P) f32 — energy at last recompute
    age: torch.Tensor        # (..., P) int32 — frames since last recompute
    valid: torch.Tensor      # (..., P) bool — entry has ever been computed
    n_stale: torch.Tensor    # (...,) int32 — stale patches recomputed last frame


@dataclasses.dataclass(frozen=True)
class TemporalSpec:
    """delta_threshold: energy change that marks a selected patch stale
    (0.0 marks every patch stale); recompute_budget: j, the static number
    of patches re-projected per frame (None = k); droop_lsb_budget: LSBs of
    droop a held entry may accrue before it is forced stale."""

    delta_threshold: float = 0.0
    recompute_budget: int | None = None
    droop_lsb_budget: float = 0.5

    def budget(self, k: int) -> int:
        j = k if self.recompute_budget is None else self.recompute_budget
        if j < 1:
            raise ValueError(f"recompute_budget must be >= 1, got {j}")
        return min(j, k)

    def max_hold_frames(self, summer, adc) -> int:
        """Largest number of holds whose worst-case droop stays within
        ``droop_lsb_budget`` LSBs of a full-scale code."""
        d = summer.droop_factor()
        code_fs = max(abs(adc.v_min), abs(adc.v_max)) / adc.lsb
        tol = self.droop_lsb_budget / code_fs
        if d >= 1.0 or tol >= 1.0:
            return 2**31 - 2            # no droop (ideal summer): hold forever
        if tol <= 0.0:
            return 0                    # zero budget: refresh every frame
        return int(math.floor(math.log(1.0 - tol) / math.log(d)))


def init_feature_cache(cfg, batch_shape: tuple[int, ...] = (), dtype=None,
                       device=None) -> FeatureCache:
    """Empty (all-invalid) cache for a ``FrontendConfig`` over
    ``batch_shape`` on ``device`` (the GPU by default); ``dtype`` defaults
    to the ADC code dtype."""
    device = resolve_device(device)
    p, m = cfg.n_patches, cfg.patch.n_vectors
    dtype = cfg.adc.code_dtype if dtype is None else dtype
    return FeatureCache(
        features=torch.zeros((*batch_shape, p, m), dtype=dtype, device=device),
        energy=torch.zeros((*batch_shape, p), dtype=torch.float32, device=device),
        age=torch.zeros((*batch_shape, p), dtype=torch.int32, device=device),
        valid=torch.zeros((*batch_shape, p), dtype=torch.bool, device=device),
        n_stale=torch.zeros(batch_shape, dtype=torch.int32, device=device),
    )


def take_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: arr (..., P[, M]) at idx (..., k)."""
    i = idx.long()
    if arr.dim() == idx.dim():
        return torch.gather(arr, -1, i)
    return torch.gather(arr, -2, i[..., None].expand(*i.shape, arr.shape[-1]))


def _scatter_rows(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Batched row set: dst (..., P[, M]) rows at idx (..., j) replaced by
    src. The indices of one row are distinct (a subset of a top-k)."""
    lead = idx.shape[:-1]
    b = math.prod(lead)
    flat_dst = dst.reshape((b,) + dst.shape[len(lead):]).clone()
    rows = torch.arange(b, device=idx.device)[:, None]
    flat_dst[rows, idx.reshape(b, -1).long()] = src.reshape(
        (b,) + src.shape[len(lead):])
    return flat_dst.reshape(dst.shape)


def select_stale(energy: torch.Tensor, indices: torch.Tensor, cache: FeatureCache,
                 spec: TemporalSpec, summer, adc,
                 sel_valid: torch.Tensor | None = None,
                 cap: torch.Tensor | None = None):
    """Which of the k selected patches to recompute this frame.

    ``sel_valid`` (..., k) marks slots that will not be served (shed or
    filler); ``cap`` (...,) truncates the needed set to its first ``cap``
    ranked slots (the governor's recompute allocation). Returns
    ``(stale_idx (..., j), needed (..., j), n_stale (...,))``; ``n_stale``
    is a prefix count of the slot axis."""
    k = indices.shape[-1]
    j = spec.budget(k)
    max_hold = spec.max_hold_frames(summer, adc)

    e_now = take_rows(energy, indices)
    e_ref = take_rows(cache.energy, indices)
    age = take_rows(cache.age, indices)
    valid = take_rows(cache.valid, indices)

    delta = torch.abs(e_now - e_ref)
    stale = (~valid) | (delta >= spec.delta_threshold) | (age >= max_hold)
    if sel_valid is not None:
        stale = stale & sel_valid

    # stale first (score >= 2: age plus the row-normalised delta), fresh
    # after in [0, 1), oldest first
    agef = age.to(torch.float32)
    dmax = torch.amax(delta, dim=-1, keepdim=True)
    dn = delta / torch.clamp_min(dmax, 1e-12)
    fresh_rank = 1.0 - 1.0 / (1.0 + agef)
    score = torch.where(stale, 2.0 + agef + dn, fresh_rank)
    # lax.top_k puts the lower position first on ties: a stable descending sort
    pos = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :j]
    stale_idx = torch.gather(indices, -1, pos)
    needed = torch.gather(stale, -1, pos)
    if cap is not None:
        needed = needed & (torch.arange(j, device=cap.device) < cap[..., None])
    n_stale = torch.sum(needed, dim=-1).to(torch.int32)
    return stale_idx, needed, n_stale


def refresh(cache: FeatureCache, stale_idx: torch.Tensor, needed: torch.Tensor,
            new_features: torch.Tensor, energy: torch.Tensor,
            n_stale: torch.Tensor) -> FeatureCache:
    """Age every held entry by one frame, then write the recomputed
    ``needed`` rows (new code, new energy reference, age 0, valid)."""
    age = torch.where(cache.valid, cache.age + 1, cache.age)
    feats = _scatter_rows(
        cache.features, stale_idx,
        torch.where(needed[..., None], new_features, take_rows(cache.features, stale_idx)))
    e_ref = _scatter_rows(
        cache.energy, stale_idx,
        torch.where(needed, take_rows(energy, stale_idx),
                    take_rows(cache.energy, stale_idx)))
    age = _scatter_rows(
        age, stale_idx,
        torch.where(needed, torch.zeros_like(age[..., :1]), take_rows(age, stale_idx)))
    valid = _scatter_rows(cache.valid, stale_idx,
                          needed | take_rows(cache.valid, stale_idx))
    return FeatureCache(feats, e_ref, age, valid, n_stale)


def held_gain(cache: FeatureCache, indices: torch.Tensor, summer) -> torch.Tensor:
    """Per-served-row droop multiplier ``d^age`` (0 on never-computed
    entries), with ``d`` rounded to float32 once as the reference does."""
    age = take_rows(cache.age, indices).to(torch.float32)
    d = torch.full((), summer.droop_factor(), dtype=torch.float32, device=age.device)
    return torch.pow(d, age) * take_rows(cache.valid, indices).to(torch.float32)


def gated_frame_events(n_pixels: float, pixels_per_patch: int, n_vectors: int,
                       n_selected, n_stale, readout: str = "adc") -> power_mod.EventCounts:
    """The events one gated frame executes: only the ``n_stale``
    recomputed patches pay for projection and conversion (ADC, or one
    comparator each with ``readout="sign"``); holds are free."""
    return power_mod.frontend_frame_events(
        n_pixels=n_pixels, pixels_per_patch=pixels_per_patch, n_vectors=n_vectors,
        n_selected_patches=n_selected, n_converted_patches=n_stale, readout=readout)


def held_features(cache: FeatureCache, indices: torch.Tensor, summer,
                  scale: torch.Tensor | None = None,
                  zero: torch.Tensor | None = None) -> torch.Tensor:
    """Serve the (..., k) selection from held charge as floats: gather the
    rows, dequantise them (a code or sign cache needs the static ``(scale,
    zero)`` metadata; a float cache ignores it) and apply each entry's
    droop through :func:`held_gain`."""
    feats = take_rows(cache.features, indices)
    if not feats.is_floating_point():
        if scale is None or zero is None:
            raise ValueError("code-format cache: held_features needs the (scale, zero) "
                             "metadata from repro_torch.core.adc.readout_scale_zero")
        feats = adc_mod.dequantize(feats, scale, zero)
    return feats * held_gain(cache, indices, summer)[..., None]
