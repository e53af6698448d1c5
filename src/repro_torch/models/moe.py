"""Mixture-of-Experts FFN with sort-based dispatch.

Per MoE layer: router logits -> softmax -> top-k -> flatten the (T·K)
assignments -> stable sort by expert -> position within each expert's run
-> capacity clip (overflow rows go to one extra slot that is cut) ->
(E, C, D) expert buffer -> batched expert GEMMs -> gather back, weighted
by the renormalised gates, plus any shared experts. The Switch aux
load-balance loss is returned for the trainer.

Ties follow the reference: its top-k puts the lower expert first and its
argsort is stable, so both are stable sorts here, and a binding capacity
drops the reference's (token, expert) pairs. Each token's k weighted
expert outputs are summed in a fixed order (ascending expert, the order
of the sorted assignments), so the combine is deterministic on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParallelPlan, dense_init
from repro_torch.models.sharding_ctx import P, constrain, replicated


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype = torch.float32) -> dict:
    m = cfg.moe
    d = cfg.d_model

    def experts(a, b):
        return torch.stack([dense_init(generator, a, b, dtype) for _ in range(m.n_experts)])

    p = {
        "router": dense_init(generator, d, m.n_experts, dtype),
        "w_gate": experts(d, m.d_expert),
        "w_up": experts(d, m.d_expert),
        "w_down": experts(m.d_expert, d),
    }
    if m.n_shared_experts:
        dsh = m.d_expert * m.n_shared_experts
        p["shared"] = {
            "w_gate": dense_init(generator, d, dsh, dtype),
            "w_up": dense_init(generator, d, dsh, dtype),
            "w_down": dense_init(generator, dsh, d, dtype),
        }
    return p


def spec_moe(cfg: ModelConfig, plan: ParallelPlan) -> dict:
    w_in = plan.fsdp_axis if plan.fsdp else None
    s = {
        "router": P(None, None),
        # experts sharded over the tensor axis (EP == TP axis)
        "w_gate": P(plan.tp_axis, w_in, None),
        "w_up": P(plan.tp_axis, w_in, None),
        "w_down": P(plan.tp_axis, None, w_in),
    }
    if cfg.moe.n_shared_experts:
        s["shared"] = {
            "w_gate": P(w_in, plan.tp_axis),
            "w_up": P(w_in, plan.tp_axis),
            "w_down": P(plan.tp_axis, w_in),
        }
    return s


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows per expert: T·K/E·capacity_factor, rounded up to a multiple of 8
    (at least 8)."""
    m = cfg.moe
    cap = int(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def route(p: dict, flat: torch.Tensor, cfg: ModelConfig):
    """flat (T, D) -> (probs (T, E), renormalised gates (T, K), ids (T, K));
    top-k by a stable descending sort (lower expert first on ties)."""
    logits = (flat @ p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gates, ids = vals[:, :k], idx[:, :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, ids


def dispatch(ids: torch.Tensor, n_experts: int, cap: int) -> dict:
    """Sort-based dispatch of the (T, K) assignments: ``order`` (stable sort
    by expert), ``tok_of`` / ``expert`` of each sorted assignment, ``keep``
    (within capacity) and ``dest`` (its buffer row; the overflow row
    E·cap when dropped)."""
    t, k = ids.shape
    flat_ids = ids.reshape(t * k)
    sorted_ids, order = torch.sort(flat_ids, stable=True)
    tok_of = torch.div(order, k, rounding_mode="floor")
    experts = torch.arange(n_experts, device=ids.device, dtype=sorted_ids.dtype)
    start = torch.searchsorted(sorted_ids, experts, side="left")
    pos_in_e = torch.arange(t * k, device=ids.device) - start[sorted_ids]
    keep = pos_in_e < cap
    dest = torch.where(keep, sorted_ids * cap + pos_in_e,
                       torch.full((), n_experts * cap, dtype=pos_in_e.dtype,
                                  device=ids.device))
    return {"order": order, "tok_of": tok_of, "expert": sorted_ids, "keep": keep,
            "dest": dest}


def _inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """``rank`` with ``rank[order[i]] = i``."""
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    return rank


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux_loss 0-dim)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    k = m.top_k
    e = m.n_experts
    flat = x.reshape(t, d)

    probs, gates, ids = route(p, flat, cfg)
    # Switch aux loss: E * sum_e f_e * p_e
    me = torch.mean(probs, dim=0)
    one_hot = ids[..., None] == torch.arange(e, device=x.device)   # no host check
    ce = torch.mean(torch.sum(one_hot.to(torch.float32), dim=1), dim=0)
    aux = e * torch.sum(me * ce) * m.router_aux_loss

    cap = capacity(cfg, t)
    # DTensor has no sharding rule for searchsorted: the dispatch (integer
    # indices, no gradient) runs on replicated ids
    dp = replicated(lambda i: dispatch(i, e, cap), ids)
    order, tok_of, keep, dest = dp["order"], dp["tok_of"], dp["keep"], dp["dest"]

    permuted = constrain(flat[tok_of], "moe_tokens")               # (TK, D)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((dest,), permuted)    # dropped rows land on the cut row
    eb = constrain(buf[: e * cap].reshape(e, cap, d), "moe_buf")   # (E, C, D)

    h = F.silu(torch.einsum("ecd,edf->ecf", eb, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", eb, p["w_up"])
    out_e = torch.einsum("ecf,efd->ecd", h, p["w_down"])

    out_flat = out_e.reshape(e * cap, d)
    gathered = torch.where(keep[:, None], out_flat[torch.clamp(dest, 0, e * cap - 1)],
                           torch.zeros((), dtype=out_flat.dtype, device=x.device))
    gathered = constrain(gathered, "moe_tokens")                   # (TK, D)
    gate_of = gates.reshape(t * k)[order]
    contrib = gathered.to(torch.float32) * gate_of[:, None]        # (TK, D), sorted
    # each token's k contributions back in sorted (ascending expert) order
    # (on DTensors through a Replicate() detour: torch 2.11's DTensor has no
    # rule for the index_put_ of the inverse permutation)
    rank = replicated(_inverse_permutation, order)
    by_expert = torch.sort(rank.reshape(t, k), dim=1).values       # (T, K)
    out_tok = contrib[by_expert[:, 0]]
    for j in range(1, k):
        out_tok = out_tok + contrib[by_expert[:, j]]

    if "shared" in p:
        sp = p["shared"]
        hs = F.silu(flat @ sp["w_gate"]) * (flat @ sp["w_up"])
        out_tok = out_tok + (hs @ sp["w_down"]).to(torch.float32)

    return out_tok.to(x.dtype).reshape(b, s, d), aux
