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


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Geometry of the conv-in-pixel mode: the same ganged-8×8-tile fabric
    reprogrammed with a K×K kernel per output channel, the patch selector
    walking the frame with ``stride`` (overlapping windows when stride < K
    are separate charge-share cycles over the same pixels). K inherits the
    OpAmp ganging constraint (8/16/24/32); the stride is free."""

    kernel: int = 8               # K, ganged 8x8 tiles like patch dims
    stride: int = 8               # window step in pixels (< K overlaps)
    n_channels: int = 16          # output channels (the conv "M")
    quant: pwm_mod.QuantSpec = pwm_mod.QuantSpec()
    summer: sc.SummerSpec = sc.SummerSpec()
    nl: AnalogNLSpec = AnalogNLSpec(kind="none")

    def __post_init__(self):
        if self.stride < 1:
            raise ValueError(f"stride={self.stride}: must be >= 1")
        self.patch_spec()  # validates the kernel geometry

    def patch_spec(self) -> PatchSpec:
        """One conv window as the projection array sees it: a K×K patch
        with ``n_channels`` output vectors."""
        return PatchSpec(patch_h=self.kernel, patch_w=self.kernel,
                         n_vectors=self.n_channels, quant=self.quant,
                         summer=self.summer, nl=self.nl)

    def out_grid(self, h: int, w: int) -> tuple[int, int]:
        if (h - self.kernel) % self.stride or (w - self.kernel) % self.stride:
            raise ValueError(f"frame {h}x{w} not covered by K={self.kernel} "
                             f"stride={self.stride} windows")
        return ((h - self.kernel) // self.stride + 1,
                (w - self.kernel) // self.stride + 1)


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


def extract_windows(frame: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """(H, W) or (B, H, W) frame -> (..., n_windows, kernel²) strided
    im2col: row-major window order, row-major pixels inside each window, so
    ``extract_windows(f, k, k)`` equals ``extract_patches(f, k, k)`` bit
    for bit."""
    batched = frame.ndim == 3
    if not batched:
        frame = frame[None]
    b, h, w = frame.shape
    if (h - kernel) % stride or (w - kernel) % stride:
        raise ValueError(f"frame {h}x{w} not covered by K={kernel} stride={stride} windows")
    # (b, gh, w, K rows) -> (b, gh, gw, K rows, K cols)
    x = frame.unfold(1, kernel, stride).unfold(2, kernel, stride)
    x = x.reshape(b, x.shape[1] * x.shape[2], kernel * kernel)
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


def analog_project_frame(frame: torch.Tensor, weights: torch.Tensor,
                         spec: PatchSpec) -> torch.Tensor:
    """Frame -> per-patch analog feature vectors (the plain path)."""
    patches = extract_patches(frame, spec.patch_h, spec.patch_w)
    return analog_project_patches(patches, weights, spec)


def grid_shape(h: int, w: int, spec: PatchSpec) -> tuple[int, int]:
    return h // spec.patch_h, w // spec.patch_w
