"""Attention parameters in the reference's layouts: wq/wk/wv (d, h, dh),
wo (h, dh, d), biases (h, dh). Only the ViT's multi-head init is ported."""

from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init


def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   head_dim: int, qkv_bias: bool = True) -> dict:
    d, h, dh = d_model, n_heads, head_dim
    p = {
        "wq": dense_init(generator, d, h * dh).reshape(d, h, dh),
        "wk": dense_init(generator, d, h * dh).reshape(d, h, dh),
        "wv": dense_init(generator, d, h * dh).reshape(d, h, dh),
        "wo": dense_init(generator, h * dh, d).reshape(h, dh, d),
    }
    if qkv_bias:
        for name in ("bq", "bk", "bv"):
            p[name] = torch.zeros((h, dh), dtype=torch.float32)
    return p
