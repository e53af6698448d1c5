"""Per-kind block init / spec / apply dispatch and decode-state init.

A model is ``block_pattern`` tiled over n_layers; each pattern position
has its own parameter stack (leading repeat dim), so heterogeneous
patterns (RG-LRU / local attention, mLSTM / sLSTM) stack cleanly.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import (
    ATTN,
    LOCAL_ATTN,
    MLSTM,
    MOE,
    RECURRENT,
    SLSTM,
    ModelConfig,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import ParallelPlan, apply_mlp, init_mlp, rms_norm, spec_mlp
from repro_torch.models.moe_a2a import apply_moe_a2a
from repro_torch.models.sharding_ctx import P, constrain, get_moe_ctx, shards_whole_along


def init_block(generator: torch.Generator, kind: str, cfg: ModelConfig,
               plan: ParallelPlan, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    p: dict = {"norm1": torch.ones((d,), dtype=dtype)}
    if kind in (ATTN, LOCAL_ATTN, MOE):
        p["attn"] = attn_mod.init_attention(generator, cfg, plan, dtype)
        p["norm2"] = torch.ones((d,), dtype=dtype)
        if kind == MOE:
            p["moe"] = moe_mod.init_moe(generator, cfg, dtype)
        else:
            p["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.mlp_kind, dtype)
    elif kind == RECURRENT:
        p["rec"] = rglru_mod.init_rglru_block(generator, cfg, dtype)
        p["norm2"] = torch.ones((d,), dtype=dtype)
        p["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.mlp_kind, dtype)
    elif kind == MLSTM:
        p["mlstm"] = xlstm_mod.init_mlstm_block(generator, cfg, dtype)
    elif kind == SLSTM:
        p["slstm"] = xlstm_mod.init_slstm_block(generator, cfg, dtype)
    else:
        raise ValueError(kind)
    return p


def spec_block(kind: str, cfg: ModelConfig, plan: ParallelPlan) -> dict:
    s: dict = {"norm1": P(None)}
    if kind in (ATTN, LOCAL_ATTN, MOE):
        s["attn"] = attn_mod.spec_attention(cfg, plan)
        s["norm2"] = P(None)
        if kind == MOE:
            s["moe"] = moe_mod.spec_moe(cfg, plan)
        else:
            s["mlp"] = spec_mlp(cfg.mlp_kind, plan)
    elif kind == RECURRENT:
        s["rec"] = rglru_mod.spec_rglru_block(cfg, plan)
        s["norm2"] = P(None)
        s["mlp"] = spec_mlp(cfg.mlp_kind, plan)
    elif kind == MLSTM:
        s["mlstm"] = xlstm_mod.spec_mlstm_block(cfg, plan)
    elif kind == SLSTM:
        s["slstm"] = xlstm_mod.spec_slstm_block(cfg, plan)
    return s


def _roll_positions(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll`` along the positions (dim 1); on a ``DTensor``, on each
    rank's shards with the positions whole (torch 2.11's ``DTensor`` has
    no rule for ``aten.roll``)."""
    return shards_whole_along(lambda a: torch.roll(a, shift, dims=1), 1, x)


def _cache_from_prefill(k: torch.Tensor, t: int, cache_dtype: torch.dtype) -> torch.Tensor:
    """Lay prefill keys / values into the (possibly rolling) cache buffer so
    decode's slot arithmetic (slot = pos % t) lines up."""
    s = k.shape[1]
    if s < t:
        return torch.nn.functional.pad(k.to(cache_dtype), (0, 0, 0, 0, 0, t - s))
    return _roll_positions(k[:, -t:].to(cache_dtype), s % t)


def _scale_from_prefill(sc: torch.Tensor, t: int) -> torch.Tensor:
    """Same layout for the (B, S, H) int8-cache scales (padding 1.0)."""
    s = sc.shape[1]
    if s < t:
        return torch.nn.functional.pad(sc, (0, 0, 0, t - s), value=1.0)
    return _roll_positions(sc[:, -t:], s % t)


# kinds whose decode state is a KV cache, which a decode step can write in place
CACHED_KINDS = (ATTN, LOCAL_ATTN, MOE)


def apply_block(p: dict, kind: str, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor | None, state: dict | None, causal: bool = True,
                decode_pos: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """One block over x (B, S, D) -> (x, new_state, aux). With a state and
    S == 1 an attention block decodes at ``decode_pos``; with a state and
    S > 1 it fills the cache from the prompt. ``state`` is left as it was."""
    return _apply_block(p, kind, x, cfg, positions, state, causal, decode_pos)


def _apply_block(p: dict, kind: str, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor | None, state: dict | None, causal: bool = True,
                 decode_pos: torch.Tensor | None = None, in_place: bool = False
                 ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """:func:`apply_block`; with ``in_place`` a decoding attention block
    writes its new slot into ``state``'s caches themselves and returns
    them (a caller's own copy: ``lm._run_stacks``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_state = state
    if kind in CACHED_KINDS:
        window = cfg.local_window if kind == LOCAL_ATTN else None
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        if state is not None and x.shape[1] == 1:
            scales = ({"k": state["k_scale"], "v": state["v_scale"]}
                      if "k_scale" in state else None)
            out, nk, nv, nsc = attn_mod._decode_into(
                p["attn"], h, state["k"], state["v"], decode_pos, cfg,
                window=window, cache_scales=scales, in_place=in_place)
            new_state = {"k": nk, "v": nv}
            if nsc is not None:
                new_state["k_scale"], new_state["v_scale"] = nsc["k"], nsc["v"]
        else:
            out, (k, v) = attn_mod.attention_forward(
                p["attn"], h, cfg, positions, causal=causal, window=window)
            if state is not None:
                t = state["k"].shape[1]
                if state["k"].dtype == torch.int8:
                    k8, ks = attn_mod.quantize_kv(k)
                    v8, vs = attn_mod.quantize_kv(v)
                    new_state = {
                        "k": _cache_from_prefill(k8, t, torch.int8),
                        "v": _cache_from_prefill(v8, t, torch.int8),
                        "k_scale": _scale_from_prefill(ks, t),
                        "v_scale": _scale_from_prefill(vs, t),
                    }
                else:
                    new_state = {
                        "k": _cache_from_prefill(k, t, state["k"].dtype),
                        "v": _cache_from_prefill(v, t, state["v"].dtype),
                    }
        x = constrain(x + out, "act")
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        if kind == MOE:
            moe_ctx = get_moe_ctx()
            if moe_ctx is not None:
                out, aux = apply_moe_a2a(p["moe"], h, cfg, moe_ctx["mesh"],
                                         moe_ctx["dp"], moe_ctx["tp"])
            else:
                out, aux = moe_mod.apply_moe(p["moe"], h, cfg)
        else:
            out = apply_mlp(p["mlp"], h, cfg.mlp_kind)
        x = constrain(x + out, "act")
    elif kind == RECURRENT:
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        out, new_state = rglru_mod.recurrent_block_forward(p["rec"], h, state)
        x = constrain(x + out, "act")
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = constrain(x + apply_mlp(p["mlp"], h, cfg.mlp_kind), "act")
    elif kind == MLSTM:
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        out, new_state = xlstm_mod.mlstm_block_forward(
            p["mlstm"], h, state, chunk_size=cfg.xlstm_chunk, final_state=state is not None)
        x = constrain(x + out, "act")
    elif kind == SLSTM:
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        out, new_state = xlstm_mod.slstm_forward(p["slstm"], h, state)
        x = constrain(x + out, "act")
    return x, new_state, aux


def init_block_state(kind: str, cfg: ModelConfig, plan: ParallelPlan, batch: int,
                     max_len: int, cache_dtype: torch.dtype = torch.bfloat16,
                     device=None) -> dict:
    """One block's decode cache or recurrent state on ``device`` (the GPU
    by default)."""
    device = resolve_device(device)
    if kind in (ATTN, MOE, LOCAL_ATTN):
        window = cfg.local_window if kind == LOCAL_ATTN else None
        k, v = attn_mod.make_cache(cfg, plan, batch, max_len, window=window,
                                   dtype=cache_dtype, device=device)
        st = {"k": k, "v": v}
        if cache_dtype == torch.int8:
            sc = attn_mod.make_cache_scales(cfg, plan, batch, max_len, window=window,
                                            device=device)
            st["k_scale"], st["v_scale"] = sc["k"], sc["v"]
        return st
    if kind == RECURRENT:
        return rglru_mod.init_rglru_state(cfg, batch, device)
    if kind == MLSTM:
        return xlstm_mod.init_mlstm_state(cfg, batch, device)
    if kind == SLSTM:
        return xlstm_mod.init_slstm_state(cfg, batch, device)
    raise ValueError(kind)


def state_specs(kind: str, cfg: ModelConfig, plan: ParallelPlan,
                cache_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Partition specs of one block's decode state (batch over dp, heads /
    features over tp where the shape allows)."""
    dp = plan.dp_axes
    tp = plan.tp_axis
    if kind in (ATTN, MOE, LOCAL_ATTN):
        s = {"k": P(dp, None, tp, None), "v": P(dp, None, tp, None)}
        if cache_dtype == torch.int8:
            s["k_scale"] = P(dp, None, tp)
            s["v_scale"] = P(dp, None, tp)
        return s
    if kind == RECURRENT:
        return {"h": P(dp, tp), "conv": P(dp, None, tp)}
    if kind == MLSTM:
        return {"conv": P(dp, None, tp), "C": P(dp, None, None, tp),
                "n": P(dp, None, tp), "m": P(dp, None)}
    if kind == SLSTM:
        return {"c": P(dp, None, tp), "n": P(dp, None, tp),
                "m": P(dp, None, tp), "h": P(dp, tp)}
    raise ValueError(kind)
