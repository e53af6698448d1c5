"""Patch-based analog linear projection (paper §2.1, §2.1.1).

For every non-overlapping N×N patch and output vector v:

    Out_v = V_R + droop · Σ_i (W_{i,v} · P_i) / N²

This is the plain frontend; the CUDA kernel in ``kernels/`` computes the
same function in its own arithmetic order (``acc·(droop/N²) + V_R``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._arith import div
from repro_torch.core import pwm as pwm_mod
from repro_torch.core import switched_cap as sc
from repro_torch.core.analog_nl import AnalogNLSpec, analog_nonlinearity

BASE_TILE = 8  # minimum patch size / OpAmp granularity (paper §2.1.1)


@dataclasses.dataclass(frozen=True)
class PatchSpec:
    """Geometry of the analog projection array."""

    patch_h: int = 32
    patch_w: int = 32
    n_vectors: int = 400          # M output vector elements per patch
    quant: pwm_mod.QuantSpec = pwm_mod.QuantSpec()
    summer: sc.SummerSpec = sc.SummerSpec()
    nl: AnalogNLSpec = AnalogNLSpec(kind="none")

    def __post_init__(self):
        for d, name in ((self.patch_h, "patch_h"), (self.patch_w, "patch_w")):
            if d % BASE_TILE != 0 or not (BASE_TILE <= d <= 4 * BASE_TILE):
                raise ValueError(
                    f"{name}={d}: patches are ganged 8x8 tiles, sizes 8/16/24/32"
                )

    @property
    def pixels_per_patch(self) -> int:
        return self.patch_h * self.patch_w


def extract_patches(frame: torch.Tensor, patch_h: int, patch_w: int) -> torch.Tensor:
    """(H, W) or (B, H, W) frame -> (..., n_patches, patch_h*patch_w)."""
    batched = frame.ndim == 3
    if not batched:
        frame = frame[None]
    b, h, w = frame.shape
    if h % patch_h or w % patch_w:
        raise ValueError(f"frame {h}x{w} not divisible by patch {patch_h}x{patch_w}")
    gh, gw = h // patch_h, w // patch_w
    x = frame.reshape(b, gh, patch_h, gw, patch_w)
    x = x.permute(0, 1, 3, 2, 4).reshape(b, gh * gw, patch_h * patch_w)
    return x if batched else x[0]


def analog_project_patches(
    patches: torch.Tensor,
    weights: torch.Tensor,
    spec: PatchSpec,
) -> torch.Tensor:
    """(..., n_patches, N²) CDS voltages and (M, N²) weights ->
    (..., n_patches, M) ``V_R + droop·(W_q @ P_q)/N²`` through the 2T stage."""
    n2 = patches.shape[-1]
    if tuple(weights.shape) != (spec.n_vectors, n2):
        raise ValueError(f"weights {tuple(weights.shape)} != ({spec.n_vectors}, {n2})")
    p_q = pwm_mod.pwm_quantize(patches, spec.quant)
    w_q, _ = pwm_mod.quantize_weights(weights, spec.quant)
    acc = div(torch.einsum("...pi,vi->...pv", p_q, w_q), n2)
    out = spec.summer.v_ref + spec.summer.droop_factor() * acc
    return analog_nonlinearity(out, spec.nl)
