"""Delta-gated incremental backend: cross-frame reuse of ViT work.

The temporal frontend serves a held token's wire row bitwise unchanged
(same codes, gain, patch index and valid bit), and every per-token
computation downstream of the wire is deterministic, so an unchanged row
reproduces its embedding and Q/K/V for free; only attention mixes rows.
:class:`BackendCache` keeps the wire key of the last computed frame, each
layer's block outputs, and the logits and saliency to serve a frame in
which nothing changed.

:func:`delta_forward` runs one of three regimes per frame:

* fully cached — no served row changed: the cached logits and saliency
  are served, with zero MACs. The choice is made on the device (the
  reference's ``lax.cond``): the encoder runs every frame and a
  ``torch.where`` on one 0-dim flag picks the cached or computed outputs,
  so no call waits for the device (the cost: an encoder pass on a fully
  cached frame);
* exact (eps <= 0) — once any valid row of a layer changed, every query
  row of that layer is recomputed, which reproduces the dense encoder;
* budgeted (eps > 0) — recomputed rows that moved by at most eps
  (inf-norm) snap back to their cached value.

With ``ViTConfig.delta_kernel`` the layers whose attention probabilities
nobody reads score only the stale query prefix with the ragged
``delta_attention`` kernel; rows past the prefix keep their cached values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._arith import div
from repro_torch._device import resolve_device
from repro_torch.core import power as power_mod
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_mlp, rms_norm


class BackendCache(NamedTuple):
    """Per-slot backend reuse state (leading dims = batch/slot axes).
    ``feats``/``gain``/``indices``/``tvalid`` are the reuse key; ``x_out[l]``
    is layer l's block output; ``valid`` is False until a computed frame."""

    feats: torch.Tensor     # (..., k, M) wire payload (codes)
    gain: torch.Tensor      # (..., k) f32 held-charge gain
    indices: torch.Tensor   # (..., k) i32 patch indices
    tvalid: torch.Tensor    # (..., k) bool token-valid pattern
    x_out: torch.Tensor     # (..., L, k, d) f32 per-layer block outputs
    logits: torch.Tensor    # (..., C) f32 cached class logits
    received: torch.Tensor  # (..., k) f32 cached saliency (pre-mask)
    valid: torch.Tensor     # (...,) bool slot has a computed frame


def init_backend_cache(cfg, k: int, batch_shape: tuple = (), dtype=torch.int8,
                       device=None) -> BackendCache:
    """Empty cache for a ``ViTConfig`` serving ``k`` tokens per frame, on
    ``device`` (the GPU by default); ``dtype`` must be the wire payload's."""
    device = resolve_device(device)
    m = cfg.frontend.patch.n_vectors

    def z(shape, dt):
        return torch.zeros(batch_shape + shape, dtype=dt, device=device)

    return BackendCache(
        feats=z((k, m), dtype), gain=z((k,), torch.float32),
        indices=z((k,), torch.int32), tvalid=z((k,), torch.bool),
        x_out=z((cfg.n_layers, k, cfg.d_model), torch.float32),
        logits=z((cfg.n_classes,), torch.float32),
        received=z((k,), torch.float32), valid=z((), torch.bool))


def wipe_rows(bc: BackendCache, hit: torch.Tensor) -> BackendCache:
    """Zero every leaf of the slots flagged in ``hit`` (dtype-preserving)."""

    def wipe(leaf):
        h = hit.reshape(hit.shape + (1,) * (leaf.dim() - hit.dim()))
        return torch.where(h, torch.zeros((), dtype=leaf.dtype, device=leaf.device), leaf)

    return BackendCache(*(wipe(leaf) for leaf in bc))


def _stale_prefix_counts(q_stale: torch.Tensor) -> torch.Tensor:
    """Per-slot prefix length covering every stale query row (exactly the
    stale count under a stale-first ranking; over-covers otherwise)."""
    k = q_stale.shape[-1]
    pos = torch.arange(1, k + 1, dtype=torch.int32, device=q_stale.device)
    return torch.amax(torch.where(q_stale, pos, torch.zeros_like(pos)), dim=-1).to(torch.int32)


def delta_forward(params: dict, cfg, cf, embed_fn, bc: BackendCache,
                  eps: torch.Tensor, act: torch.Tensor | None = None):
    """Delta-gated encoder over the compact wire ``cf`` against ``bc``.

    ``embed_fn()`` gives the embedded tokens (B, k, d); ``eps`` (B,) is
    the snap budget (<= 0: exact);
    ``act`` (B,) restricts the skip test to the slots that advance this
    frame. Returns ``(logits, received, new_bc, macs)`` with ``macs`` the
    per-slot executed MACs (zero on a cached frame). Both regimes are
    computed; a device-side flag selects, bitwise what a host branch would
    return."""
    from repro_torch.models import vit as vit_mod  # vit imports this module

    token_valid = cf.valid
    n_layers = len(params["layers"])
    same = (torch.all(cf.features == bc.feats, dim=-1)
            & (cf.gain == bc.gain)
            & (cf.indices == bc.indices)
            & (cf.valid == bc.tvalid)
            & bc.valid[..., None])
    s0 = ~same
    # rows entering or leaving the valid set change the logits too
    gate = s0 & (token_valid | bc.tvalid)
    if act is not None:
        gate = gate & act[..., None]
    cached = ~torch.any(gate)            # 0-dim: nothing changed anywhere
    mask_changed = torch.any(cf.valid != bc.tvalid, dim=-1) | ~bc.valid

    exact = eps <= 0.0
    x = embed_fn()
    qv = token_valid.to(torch.float32)
    n_q = torch.clamp_min(torch.sum(qv, dim=-1, keepdim=True), 1.0)
    received = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    s = s0
    outs, j_qkv, q_attn = [], [], []
    for li, lp in enumerate(params["layers"]):
        any_l = torch.any(s & token_valid, dim=-1)
        if li == 0:
            any_l = any_l | mask_changed
        # exact slots: one changed key re-mixes every query
        q_stale = s | (any_l & exact)[:, None]
        need = cfg.saliency_layers == "all" or li == n_layers - 1
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        covered = None
        if cfg.delta_kernel and not need and not cfg.qth:
            counts = _stale_prefix_counts(q_stale)
            out = ops.delta_attention(lp["attn"], h, token_valid, counts, cfg.n_heads)
            probs = None
            covered = positions < counts[:, None]
        else:
            out, probs = vit_mod._encoder_attention(lp, h, cfg, token_valid,
                                                    need_probs=need)
        x_mid = x + out
        full = x_mid + apply_mlp(lp["mlp"], rms_norm(x_mid, lp["norm2"], cfg.norm_eps),
                                 "gelu")
        held = bc.x_out[:, li]
        delta = torch.amax(torch.abs(full - held), dim=-1)
        # exact: the q_stale rule; budgeted: rows that moved by <= eps snap back
        keep = torch.where(exact[:, None], q_stale, delta > eps[:, None])
        keep = keep | ~bc.valid[:, None]
        if covered is not None:
            # the kernel computed only the stale prefix; rows past it are
            # zero attention and stay on their cached values
            keep = keep & covered
        x = torch.where(keep[..., None], full, held)
        outs.append(x)
        j_qkv.append(torch.sum(s & token_valid, dim=-1).to(torch.float32))
        q_attn.append(torch.sum(q_stale & token_valid, dim=-1).to(torch.float32))
        if need:
            per_key = torch.einsum("bhqs,bq->bs", probs.to(torch.float32), qv)
            received = received + per_key / (n_q * probs.shape[1])
        s = keep
    xf = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = token_valid.to(xf.dtype)[..., None]
    pooled = torch.sum(xf * w, dim=1) / torch.clamp_min(torch.sum(w, dim=1), 1.0)
    logits = pooled @ params["head"]
    if cfg.saliency_layers == "all":
        received = div(received, n_layers)
    macs = power_mod.backend_frame_macs(
        cfg.frontend.patch.n_vectors, cfg.d_model, cfg.d_ff, cfg.n_classes,
        j_embed=torch.sum(s0 & token_valid, dim=-1).to(torch.float32),
        j_qkv=j_qkv, q_attn=q_attn,
        n_keys=torch.sum(token_valid, dim=-1).to(torch.float32), computed=1.0)
    new_bc = BackendCache(
        feats=cf.features, gain=cf.gain, indices=cf.indices, tvalid=cf.valid,
        x_out=torch.stack(outs, dim=1), logits=logits, received=received,
        valid=torch.ones(bc.valid.shape, dtype=torch.bool, device=bc.valid.device))
    new_bc = BackendCache(*(torch.where(cached, o, n) for o, n in zip(bc, new_bc)))
    macs = torch.where(cached, torch.zeros_like(macs), macs)
    return new_bc.logits, new_bc.received, new_bc, macs
