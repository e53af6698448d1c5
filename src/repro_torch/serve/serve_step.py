"""Serving steps: batched LM prefill and single-token decode with greedy
or temperature sampling, and the IP2 closed saccade loop, where frame t's
patch selection comes from the backend's attention on frame t-1 (paper §1
"shifted attention")."""

from __future__ import annotations

import torch

from repro_torch._arith import div
from repro_torch.configs.base import ModelConfig
from repro_torch.core import frontend as fe
from repro_torch.core import saliency as sal
from repro_torch.models import lm
from repro_torch.models.layers import ParallelPlan
from repro_torch.models.sharding_ctx import whole_along
from repro_torch.models.vit import vit_forward_compact


def make_prefill_step(cfg: ModelConfig, plan: ParallelPlan):
    """prefill_step(params, batch, state) -> (last-position logits, state)."""
    def prefill_step(params, batch, state):
        return lm.prefill(params, batch, cfg, plan, state)

    return prefill_step


def make_decode_step(cfg: ModelConfig, plan: ParallelPlan, temperature: float = 0.0):
    """decode_one(params, state, tokens, pos, rng) -> (next tokens (B,) int32,
    logits, state). Greedy (``temperature == 0``) takes the argmax, the
    first index on ties as the reference's; otherwise one token per row is
    drawn from softmax(logits / temperature) with ``rng``, a
    ``torch.Generator`` on the logits' device (the reference's JAX key has
    no counterpart, so its draws are not reproduced)."""
    def decode_one(params, state, tokens, pos, rng=None):
        logits, state = lm.decode_step(params, state, tokens, pos, cfg, plan)
        if temperature > 0.0:
            probs = torch.softmax(div(logits, temperature), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=rng)[:, 0]
        else:
            # on a DTensor the vocabulary is made whole first: DTensor's
            # argmax over a sharded dim fails where a rank holds one row (a
            # batch of 1, or one row a data rank)
            nxt = torch.argmax(whole_along(logits, -1), dim=-1)
        return nxt.to(torch.int32), logits, state

    return decode_one


def make_bootstrap_indices(cfg):
    """First-frame selection from the in-pixel patch-energy proxy:
    fn(params, rgb (B,H,W,3)) -> (B, k) int32."""
    fcfg = cfg.frontend

    def bootstrap(params, rgb):
        patches, _ = fe.sensor_patches(params["ip2"], rgb, fcfg)
        return sal.topk_patch_indices(sal.patch_energy(patches), fcfg.n_active)

    return bootstrap


def saccade_scores(aux: dict, explore: float) -> torch.Tensor:
    """Next-frame selection scores (B, P) from one compact forward's aux.

    Unobserved patches score the mean observed attention; ``explore``
    weights the max-normalised patch energy added on top (a 1e-3 floor
    keeps a content-aware tie-break at explore=0)."""
    att = aux["saliency"]                               # (B, P), 0 unobserved
    observed = torch.zeros(att.shape, dtype=torch.int32, device=att.device)
    observed = observed.scatter_reduce(
        1, aux["indices"].long(), aux["valid"].to(torch.int32), reduce="amax",
        include_self=True).to(torch.bool)
    n_obs = torch.clamp_min(observed.sum(-1, keepdim=True), 1)
    baseline = att.sum(-1, keepdim=True) / n_obs
    scores = torch.where(observed, att, baseline)
    energy = aux["energy"]
    energy = energy / torch.clamp_min(torch.amax(energy, dim=-1, keepdim=True), 1e-9)
    return scores + max(explore, 1e-3) * baseline * energy


def make_saccade_step(cfg, explore: float = 0.1, project_fn=None,
                      temporal: bool = False, backend: bool = False):
    """Closed-loop step on the compact path: frame t projects only the k
    patches the backend attended to on frame t-1, and its attention (see
    :func:`saccade_scores`) picks frame t+1's. Seed ``indices`` with
    :func:`make_bootstrap_indices`.

    ``project_fn`` is a kernel-backed projection of the gathered patches
    (``ops.ip2_codes_fn(spec, adc)`` for the staged kernel route);
    ``cfg.fused_embed`` routes the frontend->embed seam through the fused
    kernel instead (plain form only: it takes no cache). The forms, as the
    reference's:

    * ``step(params, rgb, indices) -> (logits, next_indices, aux)``;
    * ``temporal=True``: ``step(params, rgb, indices, cache) -> (...,
      cache)`` threads a :class:`FeatureCache` (the temporal gate
      re-projects only the stale subset of each selection);
    * ``backend=True``: ``step(params, rgb, indices, bcache, eps=None) ->
      (..., bcache)`` threads a :class:`BackendCache` (rows whose served
      wire is bitwise unchanged reuse their backend work; ``eps`` (B,)
      the snap budget, default exact);
    * both: ``step(params, rgb, indices, cache, bcache, eps=None) ->
      (logits, next_indices, aux, cache, bcache)``.

    The caches are popped out of ``aux``; ``aux["n_stale"]`` stays."""
    fcfg = cfg.frontend

    def _finish(logits, aux):
        scores = saccade_scores(aux, explore)
        return logits, sal.topk_patch_indices(scores, fcfg.n_active), aux

    def step(params, rgb, indices):
        logits, aux = vit_forward_compact(params, rgb, cfg, indices=indices,
                                          project_fn=project_fn)
        return _finish(logits, aux)

    def step_temporal(params, rgb, indices, cache):
        logits, aux = vit_forward_compact(params, rgb, cfg, indices=indices,
                                          project_fn=project_fn, cache=cache)
        logits, next_indices, aux = _finish(logits, aux)
        return logits, next_indices, aux, aux.pop("cache")

    def step_backend(params, rgb, indices, bcache, eps=None):
        logits, aux = vit_forward_compact(params, rgb, cfg, indices=indices,
                                          project_fn=project_fn, backend_cache=bcache,
                                          backend_eps=eps)
        logits, next_indices, aux = _finish(logits, aux)
        return logits, next_indices, aux, aux.pop("backend_cache")

    def step_temporal_backend(params, rgb, indices, cache, bcache, eps=None):
        logits, aux = vit_forward_compact(params, rgb, cfg, indices=indices,
                                          project_fn=project_fn, cache=cache,
                                          backend_cache=bcache, backend_eps=eps)
        logits, next_indices, aux = _finish(logits, aux)
        return (logits, next_indices, aux, aux.pop("cache"),
                aux.pop("backend_cache"))

    if backend:
        return step_temporal_backend if temporal else step_backend
    return step_temporal if temporal else step


def make_rollout(step_fn):
    """T engine ticks issued back to back, with no host round-trip between
    them: the reference's ``lax.scan`` rollout as an eager loop.

    ``step_fn`` is one batched engine tick, ``(params, frames (S, H, W, 3),
    fed (S,), state) -> (logits (S, n_classes), state)`` from
    ``engine.make_engine_step``. Returns ``rollout(params, frames, rows,
    slots, fed_seq, counts, state) -> (logits (T, S, n_classes), state)``:
    ``frames`` is the engine's persistent frame buffer, written in place;
    ``rows`` (F, H, W, 3) holds the fed rows of all T ticks in tick order
    and ``slots`` (F,) their slots; ``fed_seq`` (T, S) the per-tick fed
    masks and ``counts`` (host ints) the rows of each tick. Tick t writes
    its rows into ``frames`` and runs ``step_fn`` with the whole state as
    carry, so the rollout is bitwise T single ticks (an all-hold tick runs
    too and leaves the state as it was). The logits stack on the device.

    The loop stays eager: no CUDA graph is captured, so nothing is
    compiled per T and the reference's trace counters (``n_traces``,
    ``n_rollout_traces``) have no counterpart here (the reference's
    ``TestTraceDiscipline`` has no port test). Launches are asynchronous,
    so T ticks are issued ahead of the card."""

    def rollout(params, frames, rows, slots, fed_seq, counts, state):
        out = []
        off = 0
        for t, n in enumerate(counts):
            if n:
                frames.index_copy_(0, slots[off:off + n], rows[off:off + n])
                off += n
            logits, state = step_fn(params, frames, fed_seq[t], state)
            out.append(logits)
        return torch.stack(out), state

    return rollout
