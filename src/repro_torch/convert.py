"""Carry parameters across from the JAX package.

``params_from_numpy`` takes the reference's ViT parameter tree after
``jax.tree.map(np.asarray, params)`` (dicts, lists and tuples of numpy
arrays, as ``init_vit`` / ``prepare_quant_embed`` build it) and returns the
same tree of tensors, layouts unchanged: ``ip2.{a_rgb, bias}``, ``embed``,
``pos``, ``final_norm``, ``head``, per layer ``norm1``,
``attn.{wq, bq, wk, bk, wv, bv, wo}`` ((d, h, dh) / (h, dh, d)), ``norm2``,
``mlp.{w_up, b_up, w_down, b_down}``, and ``embed_q = (w8, s_w)``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device


def tree_to(tree, device):
    """Move every tensor of a nested dict / list / tuple to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def _from_numpy(tree):
    if isinstance(tree, dict):
        return {k: _from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_numpy(v) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True))


def params_from_numpy(tree, device=None):
    """Numpy parameter tree -> the port's tensors on ``device`` (the GPU by
    default; raises when there is none)."""
    dev = resolve_device(device)
    return tree_to(_from_numpy(tree), dev)
