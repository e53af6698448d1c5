"""IP2-ViT: the paper's backend, a patch-token transformer classifier fed by
the analog frontend.

``vit_forward`` runs the dense (..., P) token grid with the deselected
patches zeroed and masked out of attention; ``vit_forward_compact`` runs
exactly the k active tokens (positional embeddings looked up by patch
index). For the same selection the two give the same logits. The compact
forward returns the attention each token received, scattered back onto
the patch grid: the next frame's saccade signal. Its wire is the int8 ADC
codes, the float STE readout or the sign bits; with ``quant_embed`` the
codes feed the w8a8 embed kernel; with ``fused_embed`` one kernel
gathers, projects, converts and embeds. A temporal cache gates the
frontend, and a backend cache gates the encoder
(``models/backend_delta.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._arith import div
from repro_torch._device import resolve_device
from repro_torch.convert import tree_to
from repro_torch.core import adc as adc_mod
from repro_torch.core import power as power_mod
from repro_torch.core.frontend import (
    CompactFeatures,
    FrontendConfig,
    apply_frontend,
    dequantize_features,
    feature_scale_zero,
    init_frontend_params,
    select_compact,
)
from repro_torch.core.qth_attention import QTHSpec, qth_attention_weights
from repro_torch.kernels import ops
from repro_torch.models import backend_delta as bdel
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import init_attention
from repro_torch.models.layers import DEFAULT_PLAN, apply_mlp, dense_init, init_mlp, rms_norm

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    frontend: FrontendConfig = FrontendConfig()
    n_classes: int = 4
    n_layers: int = 4
    d_model: int = 128
    n_heads: int = 4
    d_ff: int = 256
    qth: bool = False          # Fig. 4 power-of-2 attention in the backend
    quant_embed: bool = False  # consume ADC codes via the w8a8 kernel
    fused_embed: bool = False  # one kernel: project + ADC + embed
    saliency_layers: str = "all"  # "all" (mean over layers) or "last"
    delta_kernel: bool = False    # delta-gated backend: the ragged
                                  # delta_attention kernel on layers whose
                                  # attention probabilities are not read
    norm_eps: float = 1e-5

    def backbone_cfg(self) -> ModelConfig:
        return ModelConfig(
            name="ip2-vit-backbone", family="vision",
            n_layers=self.n_layers, d_model=self.d_model,
            n_heads=self.n_heads, n_kv_heads=self.n_heads,
            d_ff=self.d_ff, vocab=0, head_dim=self.d_model // self.n_heads,
            mlp_kind="gelu", qkv_bias=True, remat=False,
        )


def init_vit(cfg: ViTConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters in the reference's tree layout, drawn on the CPU
    from ``generator`` and placed on ``device`` (the GPU by default)."""
    dev = resolve_device(device)
    d = cfg.d_model
    bb = cfg.backbone_cfg()
    p = {
        "ip2": init_frontend_params(cfg.frontend, generator),
        "embed": dense_init(generator, cfg.frontend.patch.n_vectors, d),
        "pos": torch.randn((cfg.frontend.n_patches, d), generator=generator) * 0.02,
        "layers": [],
        "final_norm": torch.ones((d,), dtype=torch.float32),
        "head": dense_init(generator, d, cfg.n_classes),
    }
    for _ in range(cfg.n_layers):
        p["layers"].append({
            "norm1": torch.ones((d,), dtype=torch.float32),
            "attn": init_attention(generator, bb, DEFAULT_PLAN),
            "norm2": torch.ones((d,), dtype=torch.float32),
            "mlp": init_mlp(generator, d, cfg.d_ff, "gelu"),
        })
    return tree_to(p, dev)


def prepare_quant_embed(params: dict) -> dict:
    """Quantise the embed matrix to int8 once, as ``params["embed_q"]``."""
    return {**params, "embed_q": ops.quantize_weights_int8(params["embed"])}


def _embed_q(params: dict):
    eq = params.get("embed_q")
    return eq if eq is not None else ops.quantize_weights_int8(params["embed"])


def _encoder_attention(lp: dict, h: torch.Tensor, cfg: ViTConfig,
                       token_valid: torch.Tensor, need_probs: bool = True):
    """Bidirectional self-attention over the tokens: scores / sqrt(dh),
    invalid keys masked to -1e30, softmax, or with ``cfg.qth`` the Fig. 4
    power-of-2 coefficients. Returns (out (B, S, d), probs (B, H, S, S) or
    None)."""
    dh = cfg.d_model // cfg.n_heads
    a = lp["attn"]
    q = torch.einsum("bsd,dhk->bshk", h, a["wq"]) + a["bq"]
    k = torch.einsum("bsd,dhk->bshk", h, a["wk"]) + a["bk"]
    v = torch.einsum("bsd,dhk->bshk", h, a["wv"]) + a["bv"]
    scores = torch.einsum("bqhk,bshk->bhqs", q, k) / torch.sqrt(
        torch.full((), dh, dtype=h.dtype, device=h.device))
    if cfg.qth:
        probs = qth_attention_weights(scores, QTHSpec(), key_valid=token_valid[:, None])
    else:
        scores = torch.where(token_valid[:, None, None, :], scores,
                             torch.full((), NEG_INF, dtype=scores.dtype,
                                        device=scores.device))
        probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqs,bshk->bqhk", probs.to(v.dtype), v)
    out = torch.einsum("bshk,hkd->bsd", o, a["wo"])
    return out, (probs if need_probs else None)


def _encoder(params: dict, x: torch.Tensor, cfg: ViTConfig,
             token_valid: torch.Tensor):
    """Transformer trunk + masked mean pool -> (logits, received): the
    attention mass each token collected over heads and valid queries."""
    if cfg.saliency_layers not in ("all", "last"):
        raise ValueError(f"saliency_layers must be 'all' or 'last', "
                         f"got {cfg.saliency_layers!r}")
    n_layers = len(params["layers"])
    received = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
    qv = token_valid.to(torch.float32)
    n_q = torch.clamp_min(torch.sum(qv, dim=-1, keepdim=True), 1.0)
    for li, lp in enumerate(params["layers"]):
        need = cfg.saliency_layers == "all" or li == n_layers - 1
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        out, probs = _encoder_attention(lp, h, cfg, token_valid, need_probs=need)
        x = x + out
        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + apply_mlp(lp["mlp"], h, "gelu")
        if need:
            per_key = torch.einsum("bhqs,bq->bs", probs.to(torch.float32), qv)
            received = received + per_key / (n_q * probs.shape[1])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = token_valid.to(x.dtype)[..., None]
    pooled = torch.sum(x * w, dim=1) / torch.clamp_min(torch.sum(w, dim=1), 1.0)
    logits = pooled @ params["head"]
    if cfg.saliency_layers == "all":
        received = div(received, n_layers)
    return logits, received


def _embed_tokens(params: dict, cf: CompactFeatures, cfg: ViTConfig) -> torch.Tensor:
    """The backend's first matmul, the one place the wire is dequantised.
    With ``quant_embed`` integer codes feed the w8a8 kernel and the affine
    distributes: ((c·s + z)⊙g) @ W = g⊙(s·(c @ W8)·s_w + z @ dequant(W8)).
    Sign bits (their own affine) and float payloads take the generic
    dequant, never the kernel."""
    feats = cf.features
    if cfg.quant_embed and feats.dtype != torch.bool and not feats.is_floating_point():
        w8, s_w = _embed_q(params)
        y = ops.quant_matmul_pre(feats, cf.scale, w8, s_w)
        return (y + ops.fused_embed_zero_term(cf.zero, w8, s_w)) * cf.gain[..., None]
    return dequantize_features(cf) @ params["embed"]


def _saliency(received, indices, valid, n_patches):
    """Backend attention scattered back onto the patch grid (max per patch,
    unobserved patches 0)."""
    received = torch.where(valid, received, torch.zeros_like(received))
    grid = torch.zeros((received.shape[0], n_patches), dtype=torch.float32,
                       device=received.device)
    return grid.scatter_reduce(1, indices.long(), received, reduce="amax",
                               include_self=True)


def _forward_compact_fused(params, rgb, cfg: ViTConfig, indices, mask,
                           project_fn, precomputed, cache, wire, k_cap, stale_cap):
    """The fused compact path: one kernel gathers, projects, converts and
    embeds; the affine and gain algebra is exactly ``_embed_tokens``'."""
    fe_cfg = cfg.frontend
    if not cfg.quant_embed:
        raise ValueError("fused_embed requires quant_embed=True")
    if not fe_cfg.analog:
        raise ValueError("fused_embed requires an analog frontend")
    if wire == "float":
        raise ValueError("fused_embed has no float wire: codes are consumed in-kernel "
                         "and never materialized — use fused_embed=False for the STE "
                         "float view")
    if wire == "sign":
        raise ValueError("fused_embed has no sign wire: it converts through the edge "
                         "ADC in-kernel — use fused_embed=False with wire='sign'")
    if project_fn is not None:
        raise ValueError("fused_embed IS the projector; a project_fn cannot "
                         "be substituted into it — use fused_embed=False")
    if cache is not None or stale_cap is not None:
        raise ValueError("fused_embed does not thread the temporal cache (held "
                         "codes live outside the kernel); use fused_embed=False "
                         "with a FeatureCache")
    sel = select_compact(params["ip2"], rgb, fe_cfg, mask=mask, indices=indices,
                         precomputed=precomputed, k_cap=k_cap)
    counts = torch.sum(sel.valid, dim=-1).to(torch.int32)
    w8, s_w = _embed_q(params)
    y = ops.ip2_fused_embed(sel.patches, sel.weights, sel.indices, fe_cfg.patch,
                            fe_cfg.adc, w8, s_w, row_counts=counts)
    _, zero = feature_scale_zero(params["ip2"], fe_cfg)
    gain = sel.valid.to(torch.float32)
    x = (y + ops.fused_embed_zero_term(zero, w8, s_w)) * gain[..., None]
    x = x + params["pos"][sel.indices.long()]
    logits, received = _encoder(params, x, cfg, sel.valid)
    n_selected = torch.sum(sel.valid, dim=-1).to(torch.float32)
    events = power_mod.frontend_frame_events(
        float(fe_cfg.image_h * fe_cfg.image_w), fe_cfg.patch.pixels_per_patch,
        fe_cfg.patch.n_vectors, n_selected_patches=n_selected,
        n_converted_patches=n_selected,
    )
    aux = {
        "indices": sel.indices, "valid": sel.valid,
        "saliency": _saliency(received, sel.indices, sel.valid, fe_cfg.n_patches),
        "energy": sel.energy, "events": events,
    }
    return logits, aux


def vit_forward_compact(params: dict, rgb: torch.Tensor, cfg: ViTConfig,
                        indices: torch.Tensor | None = None,
                        mask: torch.Tensor | None = None,
                        project_fn=None, precomputed=None, cache=None,
                        wire: str | None = None,
                        k_cap: torch.Tensor | None = None,
                        stale_cap: torch.Tensor | None = None,
                        sign_mode: torch.Tensor | None = None,
                        backend_cache: bdel.BackendCache | None = None,
                        backend_eps: torch.Tensor | None = None,
                        backend_act: torch.Tensor | None = None):
    """Compact path: rgb (B, H, W, 3) -> (logits (B, n_classes), aux) with
    aux ``indices`` (B, k), ``valid`` (B, k), ``saliency`` (B, P),
    ``energy`` (B, P) and ``events`` (EventCounts of (B,) tensors).

    ``wire`` is the frontend's payload: ``"codes"``, ``"float"`` or
    ``"sign"`` (``None``: codes when analog, float otherwise).
    ``cache`` (a FeatureCache) turns on the temporal gate and adds
    ``aux["cache"]`` and ``aux["n_stale"]``; ``k_cap`` / ``stale_cap`` are
    the governor's per-slot knobs. ``sign_mode`` (B,) bool is its sign
    tier: flagged rows serve the sign view of their codes (the two code
    points of ``adc.sign_code_points``) and price this frame's conversions
    as sign comparisons; the cache keeps the real codes.
    ``backend_cache`` turns on the delta-gated backend (``backend_eps``
    (B,) its snap budget, default exact; ``backend_act`` (B,) the slots
    that advance): its executed MACs land on ``events.backend_macs`` and
    the new cache on ``aux["backend_cache"]``."""
    if backend_cache is None and (backend_eps is not None or backend_act is not None):
        raise ValueError("backend_eps/backend_act configure the delta-gated backend "
                         "and need a BackendCache to gate against — pass "
                         "backend_cache, or drop them for the dense encoder")
    if cfg.fused_embed:
        if backend_cache is not None:
            raise ValueError("fused_embed does not thread the backend cache; use "
                             "fused_embed=False for the delta-gated backend")
        if sign_mode is not None:
            raise ValueError("fused_embed consumes codes in-kernel; the sign-tier "
                             "degradation needs the staged code wire — use "
                             "fused_embed=False in a sign-tier governed engine")
        return _forward_compact_fused(params, rgb, cfg, indices, mask, project_fn,
                                      precomputed, cache, wire, k_cap, stale_cap)
    out = apply_frontend(params["ip2"], rgb, cfg.frontend, mask=mask,
                         indices=indices, mode="compact", project_fn=project_fn,
                         precomputed=precomputed, cache=cache, wire=wire, k_cap=k_cap,
                         stale_cap=stale_cap)
    cf, new_cache = out if cache is not None else (out, None)
    if sign_mode is not None:
        if cf.features.is_floating_point():
            raise ValueError("sign_mode degrades the int8 code wire; the float wire has "
                             "no codes to degrade — it is the STE training view, not a "
                             "served payload")
        c_thresh, c_pos, c_neg = adc_mod.sign_code_points(cfg.frontend.patch.summer.v_ref,
                                                          cfg.frontend.adc)
        dt, dev = cf.features.dtype, cf.features.device
        signed = torch.where(cf.features >= c_thresh,
                             torch.full((), c_pos, dtype=dt, device=dev),
                             torch.full((), c_neg, dtype=dt, device=dev))
        ev = cf.events
        cf = cf._replace(
            features=torch.where(sign_mode[:, None, None], signed, cf.features),
            events=ev._replace(
                adc_conversions=torch.where(sign_mode, torch.zeros_like(ev.adc_conversions),
                                            ev.adc_conversions),
                sign_comparisons=torch.where(sign_mode, ev.adc_conversions,
                                             ev.sign_comparisons)))
    events = cf.events
    new_bcache = None
    if backend_cache is not None:
        if backend_cache.feats.dtype != cf.features.dtype:
            raise ValueError(f"backend cache dtype {backend_cache.feats.dtype} does not "
                             f"match wire payload {cf.features.dtype}; build it with "
                             f"init_backend_cache(..., dtype=<wire dtype>)")
        if backend_cache.feats.shape[-2:] != cf.features.shape[-2:]:
            raise ValueError(f"backend cache rows {tuple(backend_cache.feats.shape[-2:])} "
                             f"do not match the served wire "
                             f"{tuple(cf.features.shape[-2:])}")
        b = cf.valid.shape[0]
        dev = cf.valid.device
        if backend_eps is None:
            eps = torch.zeros((b,), dtype=torch.float32, device=dev)
        elif isinstance(backend_eps, torch.Tensor):
            eps = torch.broadcast_to(backend_eps.to(torch.float32), (b,))
        else:
            eps = torch.full((b,), backend_eps, dtype=torch.float32, device=dev)

        def embed_fn():
            return _embed_tokens(params, cf, cfg) + params["pos"][cf.indices.long()]

        logits, received, new_bcache, macs = bdel.delta_forward(
            params, cfg, cf, embed_fn, backend_cache, eps, act=backend_act)
        events = events._replace(backend_macs=macs)
    else:
        x = _embed_tokens(params, cf, cfg) + params["pos"][cf.indices.long()]
        logits, received = _encoder(params, x, cfg, cf.valid)
    aux = {
        "indices": cf.indices, "valid": cf.valid,
        "saliency": _saliency(received, cf.indices, cf.valid,
                              cfg.frontend.n_patches),
        "energy": cf.energy, "events": events,
    }
    if new_cache is not None:
        aux["cache"] = new_cache
        aux["n_stale"] = new_cache.n_stale
    if new_bcache is not None:
        aux["backend_cache"] = new_bcache
    return logits, aux


def vit_forward(params: dict, rgb: torch.Tensor, cfg: ViTConfig,
                mask: torch.Tensor | None = None, return_aux: bool = False):
    """Dense path: rgb (B, H, W, 3) -> logits (B, n_classes) over the
    zero-masked (B, P) token grid, attention keys restricted to the mask.
    With ``return_aux`` also ``{"mask", "saliency"}``: the attention each
    patch received, 0 off the mask."""
    feats, mask = apply_frontend(params["ip2"], rgb, cfg.frontend, mask=mask)
    x = feats @ params["embed"] + params["pos"][None]
    logits, received = _encoder(params, x, cfg, mask)
    if not return_aux:
        return logits
    saliency = torch.where(mask, received, torch.zeros_like(received))
    return logits, {"mask": mask, "saliency": saliency}


def vit_loss(params: dict, rgb: torch.Tensor, labels: torch.Tensor, cfg: ViTConfig):
    """Mean cross-entropy and accuracy of the dense forward."""
    logits = vit_forward(params, rgb, cfg)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, acc
