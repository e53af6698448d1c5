"""Small CNN baseline (the paper's comparison point: the patch-based linear
projection "can perform as well as the CNN"). Three stride-2 conv blocks
and a global-average-pool head on the full RGB frame, no frontend.

Parameters keep the reference's layouts (conv weights HWIO, frames NHWC);
the convolutions run NCHW through ``F.conv2d``. XLA's ``"SAME"`` padding
at stride 2 is asymmetric (at H 64, k 3: 0 rows before, 1 after), which
``F.conv2d``'s symmetric ``padding`` cannot express, so each conv pads
explicitly first."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.convert import tree_to


def init_cnn(generator: torch.Generator, n_classes: int = 4, width: int = 32,
             device=None) -> dict:
    """Random parameters drawn on the CPU from ``generator`` and placed on
    ``device`` (the GPU by default)."""
    dev = resolve_device(device)

    def conv(cin, cout):
        return torch.randn((3, 3, cin, cout), generator=generator) / torch.sqrt(
            torch.tensor(9.0 * cin))

    p = {
        "c1": conv(3, width),
        "c2": conv(width, width * 2),
        "c3": conv(width * 2, width * 4),
        "head": torch.randn((width * 4, n_classes), generator=generator) * 0.02,
    }
    return tree_to(p, dev)


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding (before, after) along one spatial dim."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """NCHW activations, HWIO weights, SAME padding."""
    kh, kw = w.shape[:2]
    ph, pw = _same_pad(x.shape[2], kh, stride), _same_pad(x.shape[3], kw, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def cnn_forward(params: dict, rgb: torch.Tensor) -> torch.Tensor:
    """rgb (B, H, W, 3) -> logits (B, n_classes)."""
    x = rgb.permute(0, 3, 1, 2)
    x = torch.relu(_conv(x, params["c1"]))
    x = torch.relu(_conv(x, params["c2"]))
    x = torch.relu(_conv(x, params["c3"]))
    pooled = torch.mean(x, dim=(2, 3))
    return pooled @ params["head"]


def cnn_loss(params: dict, rgb: torch.Tensor, labels: torch.Tensor):
    """Mean cross-entropy and accuracy."""
    logits = cnn_forward(params, rgb)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, acc
