"""Bayer mosaic + anti-aliasing model (paper §2.1.5).

The sensor produces a raw RGGB mosaic; the trained RGB projection matrix
keeps only each pixel site's own colour column. The optics are a Gaussian
low-pass filter with its -3 dB point at a fraction of Nyquist.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch._arith import div

def bayer_channel_map(h: int, w: int, device=None) -> torch.Tensor:
    """(H, W) int64 colour-channel index of each pixel site. The RGGB unit
    cell (R G / G B: channels 0 1 / 1 2) is ``row % 2 + col % 2``, computed
    on the device."""
    rows = torch.arange(h, device=device)[:, None] % 2
    cols = torch.arange(w, device=device)[None, :] % 2
    return rows + cols


def mosaic(rgb: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB -> (..., H, W) raw Bayer frame.

    The reference sums ``rgb * one_hot`` over the channel axis; adding exact
    zeros leaves the kept channel's value unchanged, so a gather is the same
    function bit for bit."""
    h, w = rgb.shape[-3], rgb.shape[-2]
    ch = bayer_channel_map(h, w, rgb.device)
    idx = ch.expand(rgb.shape[:-1])[..., None]
    return torch.gather(rgb, -1, idx)[..., 0]


def strike_columns(a_rgb: torch.Tensor, patch_h: int, patch_w: int) -> torch.Tensor:
    """Trained matrix A (M, N²·3) -> A' (M, N²) for the Bayer sensor."""
    m, n2x3 = a_rgb.shape
    n2 = patch_h * patch_w
    if n2x3 != n2 * 3:
        raise ValueError(f"A has {n2x3} cols, expected {n2 * 3}")
    ch = bayer_channel_map(patch_h, patch_w, a_rgb.device).reshape(-1)
    a = a_rgb.reshape(m, n2, 3)
    return torch.gather(a, -1, ch[None, :, None].expand(m, n2, 1))[..., 0]


def gaussian_kernel_1d(cutoff_nyquist: float, radius: int | None = None,
                       device=None) -> torch.Tensor:
    """1-D Gaussian whose magnitude response is -3 dB at cutoff·Nyquist."""
    fc = cutoff_nyquist * 0.5  # cycles / pixel
    sigma = math.sqrt(math.log(2.0) / 2.0) / (2.0 * math.pi * fc)
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * div(x, sigma) ** 2)
    return k / torch.sum(k)


def antialias(frame: torch.Tensor, cutoff_nyquist: float = 0.5) -> torch.Tensor:
    """Separable Gaussian AA filter on (..., H, W) with reflect padding."""
    k = gaussian_kernel_1d(cutoff_nyquist, device=frame.device)
    r = (k.shape[0] - 1) // 2

    def conv_last(x):
        lead = x.shape[:-1]
        xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (r, r), mode="reflect")
        windows = xp.reshape(*lead, -1).unfold(-1, 2 * r + 1, 1)
        return windows @ k

    out = conv_last(frame)                                          # along W
    return conv_last(out.transpose(-1, -2)).transpose(-1, -2)       # along H


def downsample2(frame: torch.Tensor) -> torch.Tensor:
    """The ½-resolution sensor option (1920x1080 RGB -> 960x540 Bayer)."""
    return frame[..., ::2, ::2]
