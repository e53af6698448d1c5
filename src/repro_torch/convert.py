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


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict / list / tuple (and of the
    trees ``rest`` of the same structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_flatten_with_paths(tree, prefix=()):
    """``[(path, leaf)]`` in JAX's order, dict keys sorted, each path as
    JAX's ``keystr`` parts joined by ``/`` (``"['layers']/[0]/['w']"``):
    the reference's checkpoint manifests name leaves this way."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_flatten_with_paths(tree[k], prefix + (f"[{k!r}]",))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_flatten_with_paths(v, prefix + (f"[{i}]",))]
    return [("/".join(prefix), tree)]


def tree_unflatten(tree_like, leaves):
    """The structure of ``tree_like`` with its leaves replaced, in the order
    of :func:`tree_flatten_with_paths`, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree_like)


def tree_to(tree, device):
    """Move every tensor of a nested dict / list / tuple to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


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
