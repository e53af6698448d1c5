"""Salient patch selection (paper §1, §2.1), index-first.

``topk_patch_indices`` keeps exactly k patches and breaks ties toward the
lower patch index, as the reference's ``lax.top_k`` does. ``torch.topk``
makes no promise on ties, so the selector is a stable descending sort.
The boolean masks of the dense path are views derived from it.
"""

from __future__ import annotations

import torch


def topk_patch_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """(..., n_patches) scores -> (..., k) int32 indices by descending score,
    equal scores in ascending patch order."""
    n = scores.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for {n} patches")
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return idx[..., :k].to(torch.int32)


def mask_from_indices(indices: torch.Tensor, n_patches: int) -> torch.Tensor:
    """(..., k) indices -> (..., n_patches) boolean mask."""
    mask = torch.zeros(indices.shape[:-1] + (n_patches,), dtype=torch.bool,
                       device=indices.device)
    return mask.scatter(-1, indices.long(), True)


def indices_from_mask(mask: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., P) boolean mask -> ((..., k) indices, (..., k) valid); active
    indices ascending, fillers repeat inactive slots marked invalid."""
    idx = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices[..., :k]
    valid = torch.gather(mask, -1, idx)
    return idx.to(torch.int32), valid


def topk_patch_mask(scores: torch.Tensor, active_fraction: float) -> torch.Tensor:
    """Boolean mask of exactly the top ``active_fraction`` of patches, built
    on the index-first selector so that tied scores never over-select."""
    n = scores.shape[-1]
    k = max(1, int(round(n * active_fraction)))
    return mask_from_indices(topk_patch_indices(scores, k), n)


def patch_energy(patches: torch.Tensor) -> torch.Tensor:
    """AC energy of each patch (..., P, N²) -> (..., P)."""
    centered = patches - torch.mean(patches, dim=-1, keepdim=True)
    return torch.mean(centered * centered, dim=-1)


def gather_patches(patches: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Select->gather: (..., P, N) rows at (..., k) indices -> (..., k, N)."""
    idx = indices.long()[..., None].expand(*indices.shape, patches.shape[-1])
    return torch.gather(patches, -2, idx)


def apply_patch_mask(features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero out deselected patches: (..., P, M) * (..., P, 1)."""
    return features * mask[..., None].to(features.dtype)


def compact_active(features: torch.Tensor, mask: torch.Tensor,
                   k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather exactly k active patch features: ((..., k, M), (..., k)
    indices); fewer than k active repeat inactive fillers, more keep the
    lowest k indices."""
    idx, _ = indices_from_mask(mask, k)
    return gather_patches(features, idx), idx


def active_fraction(mask: torch.Tensor) -> torch.Tensor:
    return torch.mean(mask.to(torch.float32), dim=-1)
