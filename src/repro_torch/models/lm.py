"""Top-level models: causal LM, whisper-style enc-dec, VLM (+ IP2 frontend).

  init_params(generator, cfg, plan, dtype, device)   -> params tree
  param_specs(cfg, plan)                             -> partition-spec tree
  forward(params, batch, cfg, plan)                  -> (logits, aux)
  loss_fn(params, batch, cfg, plan)                  -> (loss, metrics)
  init_decode_state(cfg, plan, B, max_len, ...)      -> state tree
  decode_state_specs(cfg, plan, cache_dtype)         -> partition-spec tree
  prefill(params, batch, cfg, plan, state)           -> (logits_last, state)
  decode_step(params, state, tokens, pos, cfg, plan) -> (logits, state)

The trees keep the reference's layout: ``{"embed", "lm_head"?,
"final_norm", "stacks": [one dict per pattern position, leaves with a
leading repeat dim], "tail": [...]}``, plus ``encoder`` / ``enc_norm`` /
``cross`` for enc-dec and ``vision_adapter`` / ``ip2`` for a VLM, so a
reference tree carried across by ``convert.params_from_numpy`` runs here
unchanged. Full repeats of ``block_pattern`` run as a Python loop over the
stacked layers (the reference's ``lax.scan``; ``unroll_layers`` is then the
same program); remainder layers run after them. ``loss_fn`` is
differentiable by ``torch.autograd``; with ``cfg.remat`` a training
forward recomputes each repeat's activations in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), with the
same numbers. Decode takes ``pos`` as a 0-dim device tensor and makes no
host read.
"""

from __future__ import annotations

import functools

import torch

from repro_torch._arith import div
from repro_torch._device import resolve_device
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.convert import tree_flatten_with_paths, tree_map, tree_to, tree_unflatten
from repro_torch.models import blocks as blk
from repro_torch.models.attention import attention_forward, init_attention, spec_attention
from repro_torch.models.layers import DEFAULT_PLAN, ParallelPlan, dense_init, embed_init, rms_norm
from repro_torch.models.sharding_ctx import P, constrain, relayout, replicated, with_layer_dim


# ---------------------------------------------------------------------------
# structure helpers
# ---------------------------------------------------------------------------

def _pattern_layout(cfg: ModelConfig) -> tuple[int, tuple[str, ...], tuple[str, ...]]:
    """(n_repeats, pattern, tail_kinds)."""
    pat = tuple(cfg.block_pattern)
    n_rep = cfg.n_layers // len(pat)
    tail = cfg.layer_kinds[n_rep * len(pat):]
    return n_rep, pat, tuple(tail)


def _stack(trees: list):
    return tree_map(lambda *xs: torch.stack(xs), *trees) if trees else None


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _split_layers(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, each leaf unbound once: the
    backward stacks the layers' gradients once, where a per-layer ``a[i]``
    makes each layer's backward write a zero-filled copy of the whole stack
    (bytes quadratic in the depth). The same values."""
    flat = [torch.unbind(x) for _, x in tree_flatten_with_paths(tree)]
    return [tree_unflatten(tree, [x[i] for x in flat]) for i in range(n)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _ip2_cfg(cfg: ModelConfig):
    from repro_torch.core.frontend import FrontendConfig
    from repro_torch.core.projection import PatchSpec

    return FrontendConfig(
        patch=PatchSpec(patch_h=cfg.ip2_patch, patch_w=cfg.ip2_patch,
                        n_vectors=cfg.ip2_vectors))


def init_params(generator: torch.Generator, cfg: ModelConfig,
                plan: ParallelPlan = DEFAULT_PLAN, dtype: torch.dtype = torch.float32,
                device=None) -> dict:
    """Random parameters drawn from ``generator`` in the reference's order,
    on the generator's device (a CPU generator's draws are the tests'; a
    CUDA generator draws a full-width model on the card in seconds), placed
    on ``device`` (the GPU by default). Each layer goes into its pattern
    position's stack on ``device`` as it is drawn, so the draw holds one
    layer beyond the parameters, not a second copy of the stacks."""
    dev = resolve_device(device)
    n_rep, pat, tail = _pattern_layout(cfg)
    p: dict = {}
    with torch.device(generator.device):
        if cfg.vocab:
            p["embed"] = embed_init(generator, cfg.vocab, cfg.d_model, dtype)
            if not cfg.tie_embeddings:
                p["lm_head"] = embed_init(generator, cfg.vocab, cfg.d_model, dtype)
        p["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype)

        stacks: list = [None] * len(pat)
        p["tail"] = []
        for li, kind in enumerate(cfg.layer_kinds):
            layer = blk.init_block(generator, kind, cfg, plan, dtype)
            r, pi = divmod(li, len(pat))
            if r >= n_rep:
                p["tail"].append(tree_to(layer, dev))
                continue
            if stacks[pi] is None:
                stacks[pi] = tree_map(lambda a: torch.empty((n_rep, *a.shape), dtype=a.dtype,
                                                            device=dev), layer)
            tree_map(lambda st, a: st[r].copy_(a), stacks[pi], layer)
        p["stacks"] = stacks

        if cfg.is_encoder_decoder:
            p["encoder"] = [blk.init_block(generator, "attn", cfg, plan, dtype)
                            for _ in range(cfg.n_encoder_layers)]
            p["enc_norm"] = torch.ones((cfg.d_model,), dtype=dtype)
            # decoder cross-attention, one per decoder layer
            p["cross"] = _stack([
                {"norm": torch.ones((cfg.d_model,), dtype=dtype),
                 "attn": init_attention(generator, cfg, plan, dtype)}
                for _ in range(cfg.n_layers)])
        if cfg.is_vlm:
            vis_in = cfg.ip2_vectors if cfg.vision_frontend == "ip2" else 1024
            p["vision_adapter"] = dense_init(generator, vis_in, cfg.d_model, dtype)
            if cfg.vision_frontend == "ip2":
                from repro_torch.core.frontend import init_frontend_params

                p["ip2"] = init_frontend_params(_ip2_cfg(cfg), generator)
    return tree_to(p, dev)


def param_specs(cfg: ModelConfig, plan: ParallelPlan = DEFAULT_PLAN) -> dict:
    """The partition specs of :func:`init_params`'s tree."""
    n_rep, pat, tail = _pattern_layout(cfg)
    s: dict = {}
    if cfg.vocab:
        s["embed"] = plan.spec_embed()
        if not cfg.tie_embeddings:
            s["lm_head"] = plan.spec_embed()
    s["final_norm"] = P(None)
    s["stacks"] = [with_layer_dim(blk.spec_block(k, cfg, plan)) for k in pat]
    s["tail"] = [blk.spec_block(k, cfg, plan) for k in tail]
    if cfg.is_encoder_decoder:
        s["encoder"] = [blk.spec_block("attn", cfg, plan) for _ in range(cfg.n_encoder_layers)]
        s["enc_norm"] = P(None)
        s["cross"] = with_layer_dim({"norm": P(None), "attn": spec_attention(cfg, plan)})
    if cfg.is_vlm:
        s["vision_adapter"] = P(None, plan.tp_axis)
        if cfg.vision_frontend == "ip2":
            s["ip2"] = {"a_rgb": P(plan.tp_axis, None), "bias": P(plan.tp_axis)}
    return s


# ---------------------------------------------------------------------------
# embedding of mixed inputs
# ---------------------------------------------------------------------------

def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. A ``DTensor`` table is gathered whole (as
    ``DTensor``'s own indexing gathers it) and each rank indexes it with its
    own tokens; the table's gradient is then a sum over the ranks whose
    tokens differ (``Partial`` on their axes). torch 2.11's ``DTensor`` has
    no working rule for the backward of indexing a table by sharded tokens."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    rep = [Replicate()] * mesh.ndim
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, rep, run_check=False)
    grads = [Replicate() if isinstance(p, Replicate) else Partial() for p in tokens.placements]
    local = table.redistribute(mesh, rep).to_local(grad_placements=grads)[tokens.to_local()]
    return DTensor.from_local(local, mesh, tokens.placements, run_check=False)


def embed_inputs(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, D). For a VLM the image tokens are prepended; for enc-dec
    this embeds the decoder tokens only."""
    x = _embed(params["embed"], batch["tokens"].long()) if cfg.vocab else None
    if cfg.is_vlm:
        if cfg.vision_frontend == "ip2":
            from repro_torch.core.frontend import apply_frontend

            # on DTensors through a Replicate() detour: DTensor has no
            # sharding rule for the optics' reflection padding
            vis = replicated(
                lambda a, b, rgb: apply_frontend({"a_rgb": a, "bias": b}, rgb,
                                                 _ip2_cfg(cfg))[0],
                params["ip2"]["a_rgb"], params["ip2"]["bias"], batch["images_rgb"])
        else:
            vis = batch["image_embeds"]                    # (B, n_img, 1024)
        vis = vis.to(params["vision_adapter"].dtype) @ params["vision_adapter"]
        x = vis if x is None else torch.cat([vis, x.to(vis.dtype)], dim=1)
    return x


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _remat_context_fn(policy: str):
    """``context_fn`` of ``torch.utils.checkpoint`` for the reference's
    ``jax.checkpoint`` policies: ``"dots"``
    (``dots_with_no_batch_dims_saveable``) keeps the outputs of the matrix
    products without batch dims (``aten.mm`` / ``aten.addmm``: the weight
    products) and recomputes the rest; ``"nothing"`` saves nothing."""
    from torch.utils.checkpoint import (CheckpointPolicy, create_selective_checkpoint_contexts,
                                        noop_context_fn)

    if policy != "dots":
        return noop_context_fn

    saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(policy_fn)


def _own_caches(stacks: list, kinds: tuple[str, ...]) -> list:
    """A decode step's one copy of each stacked KV cache (the pattern
    positions of attention kinds), which its layers then write in place
    through their views of it; the caller's states are never written. Other
    states (RG-LRU, xLSTM) stay as they are: each layer returns a new one,
    restacked after the step."""
    return [tree_map(torch.clone, s) if k in blk.CACHED_KINDS else s
            for s, k in zip(stacks, kinds)]


def _run_stacks(params, x, cfg, plan, states=None, causal=True, decode_pos=None):
    """Pattern repeats in a loop, then the tail. ``states`` mirrors the
    params layout: {"stacks": [stacked state per position], "tail": [...]}.

    A decode step (``states`` and ``decode_pos``) copies each stacked KV
    cache once (:func:`_own_caches`) and writes every layer's new slot into
    that copy in place; the new state holds the same values as writing each
    layer out of place and restacking, at one cache copy a step, not two.

    With ``cfg.remat``, autograd recording and no decode states (a
    training forward), each repeat of the pattern runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    scan body, policy ``cfg.remat_policy``): its activations are recomputed
    in the backward. The numbers do not change; prefill and decode run as
    without remat."""
    n_rep, pat, tail = _pattern_layout(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    positions = torch.arange(x.shape[1], device=x.device) if decode_pos is None else None
    layers = [_split_layers(stack, n_rep) for stack in params["stacks"]] if n_rep else []
    in_place = states is not None and decode_pos is not None
    layer_states = None if states is None else states["stacks"]
    if in_place and n_rep:
        layer_states = _own_caches(layer_states, pat)

    def body(r, x, aux, layer_states):
        new_states = []
        for pi, kind in enumerate(pat):
            st = None if layer_states is None else _layer(layer_states[pi], r)
            x, st_new, a = blk._apply_block(
                layers[pi][r], kind, x, cfg, positions, st,
                causal=causal, decode_pos=decode_pos, in_place=in_place)
            new_states.append(st_new)
            aux = aux + a
        return x, aux, new_states

    run = body
    if cfg.remat and states is None and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        run = functools.partial(checkpoint, body, use_reentrant=False,
                                context_fn=_remat_context_fn(cfg.remat_policy))

    ys = []
    for r in range(n_rep):
        x, aux_total, new_states = run(r, x, aux_total, layer_states)
        ys.append(new_states)

    tail_states = []
    for i, kind in enumerate(tail):
        st = None if states is None else states["tail"][i]
        x, st_new, a = blk.apply_block(
            params["tail"][i], kind, x, cfg, positions, st,
            causal=causal, decode_pos=decode_pos)
        tail_states.append(st_new)
        aux_total = aux_total + a

    new = None
    if states is not None:
        stacks = ([layer_states[pi] if in_place and kind in blk.CACHED_KINDS
                   else _stack([y[pi] for y in ys]) for pi, kind in enumerate(pat)]
                  if n_rep > 0 else None)
        new = {"stacks": stacks, "tail": tail_states}
    return x, new, aux_total


def _encode(params, frames, cfg, plan):
    """Whisper encoder over precomputed frame embeddings (stub frontend)."""
    x = frames
    pos = torch.arange(x.shape[1], device=x.device)
    for p in params["encoder"]:
        x, _, _ = blk.apply_block(p, "attn", x, cfg, pos, None, causal=False)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_attend(params_cross_i, x, enc_kv, cfg):
    h = rms_norm(x, params_cross_i["norm"], cfg.norm_eps)
    out, _ = attention_forward(
        params_cross_i["attn"], h, cfg, torch.arange(x.shape[1], device=x.device),
        causal=False, kv_override=enc_kv, use_rope=False)
    return constrain(x + out, "act")


def _decoder_layer(params, state, i: int, n_rep: int):
    """Layer i of an enc-dec decoder: (params, state or None)."""
    lp = _layer(params["stacks"][0], i) if i < n_rep else params["tail"][i - n_rep]
    if state is None:
        return lp, None
    st = _layer(state["stacks"][0], i) if i < n_rep else state["tail"][i - n_rep]
    return lp, st


def _logits(params, x, cfg) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = constrain(torch.einsum("bsd,vd->bsv", x, head), "logits")
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(div(logits, c))
    return logits


def forward(params: dict, batch: dict, cfg: ModelConfig,
            plan: ParallelPlan = DEFAULT_PLAN) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward -> (logits (B, S, V), {"moe_aux"})."""
    x = embed_inputs(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.is_encoder_decoder:
        enc = _encode(params, batch["frames"], cfg, plan)
        n_rep, _, _ = _pattern_layout(cfg)
        pos = torch.arange(x.shape[1], device=x.device)
        for i in range(cfg.n_layers):
            lp, _ = _decoder_layer(params, None, i, n_rep)
            x, _, _ = blk.apply_block(lp, "attn", x, cfg, pos, None, causal=True)
            x = _cross_attend(_layer(params["cross"], i), x, enc, cfg)
    else:
        x, _, a = _run_stacks(params, x, cfg, plan)
        aux = aux + a
    return _logits(params, x, cfg), {"moe_aux": aux}


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            plan: ParallelPlan = DEFAULT_PLAN) -> tuple[torch.Tensor, dict]:
    """Next-token CE over the text tokens (image positions excluded) plus
    the MoE aux loss, ``(loss, {"ce", "moe_aux"})``; its gradients come from
    ``torch.autograd`` (the reference's ``jax.grad``)."""
    logits, aux = forward(params, batch, cfg, plan)
    tokens = batch["tokens"].long()
    n_prefix = logits.shape[1] - tokens.shape[1]   # image tokens prepended
    tgt = tokens[:, 1:]
    lg = logits[:, n_prefix:, :][:, :-1, :].to(torch.float32)
    mask = batch.get("loss_mask")
    mask = torch.ones(tgt.shape, dtype=torch.float32, device=lg.device) if mask is None \
        else mask[:, 1:]
    logz = torch.logsumexp(lg, dim=-1)
    onehot = tgt[..., None] == torch.arange(lg.shape[-1], device=lg.device)
    gold = torch.einsum("bsv,bsv->bs", lg, onehot.to(lg.dtype))
    ce = torch.sum((logz - gold) * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    loss = ce + aux["moe_aux"]
    return loss, {"ce": ce, "moe_aux": aux["moe_aux"]}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, plan: ParallelPlan, batch: int, max_len: int,
                      cache_dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Caches and recurrent states for ``batch`` sequences of up to
    ``max_len`` positions, on ``device`` (the GPU by default)."""
    dev = resolve_device(device)
    n_rep, pat, tail = _pattern_layout(cfg)

    def stacked_state(kind):
        one = blk.init_block_state(kind, cfg, plan, batch, max_len, cache_dtype, dev)
        return tree_map(lambda a: a[None].expand(n_rep, *a.shape).clone(), one)

    state = {
        "stacks": [stacked_state(k) for k in pat],
        "tail": [blk.init_block_state(k, cfg, plan, batch, max_len, cache_dtype, dev)
                 for k in tail],
    }
    if cfg.is_encoder_decoder:
        state["enc"] = torch.zeros((batch, cfg.n_encoder_frames, cfg.d_model),
                                   dtype=torch.float32, device=dev)
    return state


def decode_state_specs(cfg: ModelConfig, plan: ParallelPlan,
                       cache_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The partition specs of :func:`init_decode_state`'s tree."""
    n_rep, pat, tail = _pattern_layout(cfg)
    s = {
        "stacks": [with_layer_dim(blk.state_specs(k, cfg, plan, cache_dtype)) for k in pat],
        "tail": [blk.state_specs(k, cfg, plan, cache_dtype) for k in tail],
    }
    if cfg.is_encoder_decoder:
        s["enc"] = P(plan.dp_axes, None, None)
    return s


def _run_decoder(params, x, cfg, state, enc, pos=None, decode_pos=None):
    """The enc-dec decoder over x with its caches: self-attention block i
    (prefill at ``pos`` or decode at ``decode_pos``) then cross-attention
    to ``enc``. Returns (x, new state). A decode step writes into one copy
    of the stacked caches, as :func:`_run_stacks` does."""
    n_rep, _, _ = _pattern_layout(cfg)
    in_place = decode_pos is not None and n_rep > 0
    if in_place:
        state = dict(state, stacks=_own_caches(state["stacks"], (ATTN,)))
    new_stack, new_tail = [], list(state["tail"])
    for i in range(cfg.n_layers):
        lp, st = _decoder_layer(params, state, i, n_rep)
        x, st_new, _ = blk._apply_block(lp, ATTN, x, cfg, pos, st, causal=True,
                                        decode_pos=decode_pos, in_place=in_place and i < n_rep)
        if i < n_rep:
            new_stack.append(st_new)
        else:
            new_tail[i - n_rep] = st_new
        x = _cross_attend(_layer(params["cross"], i), x, enc, cfg)
    stacks = state["stacks"] if in_place else [_stack(new_stack)]
    return x, dict(state, enc=enc, stacks=stacks, tail=new_tail)


def prefill(params: dict, batch: dict, cfg: ModelConfig, plan: ParallelPlan,
            state: dict) -> tuple[torch.Tensor, dict]:
    """Run the prompt through the model, filling caches and states.
    Returns (last-position logits (B, V), state)."""
    x = embed_inputs(params, batch, cfg)
    if cfg.is_encoder_decoder:
        enc = _encode(params, batch["frames"], cfg, plan)
        pos = torch.arange(x.shape[1], device=x.device)
        x, new_states = _run_decoder(params, x, cfg, state, enc, pos=pos)
    else:
        x, new_states, _ = _run_stacks(params, x, cfg, plan, states=state)
    # DTensor states come back in the layout they came in (the reference's
    # out_shardings); plain tensors as they are
    return _logits(params, x[:, -1:, :], cfg)[:, 0], relayout(new_states, state)


def decode_step(params: dict, state: dict, tokens: torch.Tensor, pos: torch.Tensor,
                cfg: ModelConfig, plan: ParallelPlan = DEFAULT_PLAN
                ) -> tuple[torch.Tensor, dict]:
    """One token step: tokens (B,) integers, ``pos`` a 0-dim integer tensor
    on the params' device (absolute position). Returns (logits (B, V),
    new state)."""
    x = params["embed"][tokens.long()][:, None, :]             # (B, 1, D)
    if cfg.is_encoder_decoder:
        x, new_states = _run_decoder(params, x, cfg, state, state["enc"], decode_pos=pos)
    else:
        x, new_states, _ = _run_stacks(params, x, cfg, plan, states=state, decode_pos=pos)
    return _logits(params, x, cfg)[:, 0], relayout(new_states, state)
