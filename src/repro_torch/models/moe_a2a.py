"""Explicit all-to-all MoE dispatch under a process-group mesh (the
reference's ``shard_map`` island), as per-rank code with explicit
collectives.

Why: a sort-based dispatch over a sharded token dim cannot be partitioned
op by op; the traffic a switch dispatch needs is one all-to-all of the
dispatched rows.

Per rank (GShard / Switch semantics):

  * tokens arrive sharded (B over dp, S over tp); each rank routes its own
    T_loc tokens with a LOCAL stable sort into an (E, C_loc, D) buffer;
  * ``all_to_all_single`` over the tp group regroups expert-major:
    (E, C_loc, D) -> (E/tp, tp·C_loc, D), rows landing on their expert's
    owner (experts are sharded E over tp);
  * batched expert GEMMs with the local expert slice;
  * the reverse all-to-all, the local combine with the router gates;
  * the Switch aux loss from ``all_reduce``d per-expert sums, and a shared
    expert's output summed over tp by ``all_reduce``, as the reference
    sums them.

Parameters and ``x`` may be ``DTensor``s on ``mesh`` (the sharded train
step) or plain tensors that are the same on every rank; the output is then
a ``DTensor`` in the layout of the local shards, or the whole plain tensor.
Gradients flow through the collectives (the all-to-alls transpose to the
reverse all-to-alls). Capacity is per shard, so token drops match the
unsharded dispatch only when ``capacity_factor`` is generous.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import capacity, dispatch, route
from repro_torch.models.sharding_ctx import P, axis_size, fit_spec, placements_for


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) of per-rank contributions into a value every rank
    then holds; the backward hands each rank the (replicated) gradient
    unchanged, the transpose of that broadcast."""

    @staticmethod
    def forward(ctx, x, groups):
        out = x.clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks along dim 0; the backward is
    the same exchange of the gradient's chunks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def _local(t: torch.Tensor, mesh, spec: P, sharded_dims: set[int]) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``. The gradient of a block
    replicated over a mesh dim whose ranks see different tokens is a
    partial sum there (``Partial``); it is summed back into ``t``'s own
    layout in the backward."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    placements = placements_for(fit_spec(spec, tuple(t.shape), mesh), mesh)
    grads = [p if isinstance(p, Shard) else (Partial() if i in sharded_dims else Replicate())
             for i, p in enumerate(placements)]
    return t.redistribute(mesh, placements).to_local(grad_placements=grads)


def apply_moe_a2a(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh, dp_axes,
                  tp_axis: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in replacement for ``moe.apply_moe`` on a ``DeviceMesh``; every
    rank of the mesh calls it."""
    from torch.distributed.tensor import DTensor

    m = cfg.moe
    names = tuple(mesh.mesh_dim_names)
    tp = axis_size(mesh, tp_axis)
    assert m.n_experts % tp == 0, (m.n_experts, tp)

    w_specs = {
        "router": P(None, None),
        "w_gate": P(tp_axis, None, None),
        "w_up": P(tp_axis, None, None),
        "w_down": P(tp_axis, None, None),
    }
    if "shared" in p:
        w_specs["shared"] = {
            "w_gate": P(None, tp_axis),
            "w_up": P(None, tp_axis),
            "w_down": P(tp_axis, None),
        }
    # local shapes must divide the mesh axes exactly (microbatched steps can
    # shrink the batch below the dp size): an axis that doesn't divide is
    # dropped to replication; the aux ratios are replication-invariant.
    dp_tuple = dp_axes if isinstance(dp_axes, tuple) else (dp_axes,)
    dp_used = dp_tuple if x.shape[0] % axis_size(mesh, dp_tuple) == 0 else None
    seq_used = tp_axis if x.shape[1] % tp == 0 else None
    x_spec = P(dp_used, seq_used, None)
    used = (*(dp_used or ()), *((seq_used,) if seq_used else ()))
    sharded_dims = {names.index(a) for a in used}

    was_dtensor = isinstance(x, DTensor)
    x_loc = _local(x, mesh, x_spec, set())
    p_loc = {k: (_local(p[k], mesh, s, sharded_dims) if isinstance(s, P)
                 else {kk: _local(p[k][kk], mesh, ss, sharded_dims) for kk, ss in s.items()})
             for k, s in w_specs.items()}
    tp_group = mesh.get_group(tp_axis)

    b, s, d = x_loc.shape
    t = b * s
    k, e = m.top_k, m.n_experts
    flat = x_loc.reshape(t, d)

    probs, gates, ids = route(p_loc, flat, cfg)
    # Switch aux loss over the GLOBAL token population (sums over the ranks
    # that hold different tokens)
    groups = [mesh.get_group(a) for a in used]
    me_sum = torch.sum(probs, dim=0)
    one_hot = ids[..., None] == torch.arange(e, device=flat.device)
    ce_sum = torch.sum(torch.sum(one_hot.to(torch.float32), dim=1), dim=0)
    stats = _SumOverRanks.apply(
        torch.cat([me_sum, ce_sum, torch.full((1,), t, dtype=torch.float32,
                                               device=flat.device)]), groups)
    me_sum, ce_sum, n_tok = stats[:e], stats[e:2 * e], stats[2 * e]
    aux = e * torch.sum((me_sum / n_tok) * (ce_sum / n_tok)) * m.router_aux_loss

    cap = capacity(cfg, t)
    dp = dispatch(ids, e, cap)
    order, tok_of, keep, dest = dp["order"], dp["tok_of"], dp["keep"], dp["dest"]
    buf = torch.zeros((e * cap + 1, d), dtype=x_loc.dtype, device=x_loc.device)
    buf = buf.index_put((dest,), flat[tok_of])     # dropped rows land on the cut row
    ebuf = buf[: e * cap].reshape(e, cap, d)

    # dispatch rows to the expert owners: (E, C, D) -> (E/tp, tp*C, D)
    el = e // tp
    if tp > 1:
        ebuf = _AllToAll.apply(ebuf, tp_group)           # chunk r came from rank r
        ebuf = ebuf.reshape(tp, el, cap, d).transpose(0, 1).reshape(el, tp * cap, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", ebuf, p_loc["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", ebuf, p_loc["w_up"])
    out_e = torch.einsum("ecf,efd->ecd", h, p_loc["w_down"])

    # return rows: (E/tp, tp*C, D) -> (E, C, D)
    if tp > 1:
        out_e = out_e.reshape(el, tp, cap, d).transpose(0, 1).contiguous()
        out_e = _AllToAll.apply(out_e, tp_group).reshape(e, cap, d)

    out_flat = out_e.reshape(e * cap, d)
    gathered = torch.where(keep[:, None], out_flat[torch.clamp(dest, 0, e * cap - 1)],
                           torch.zeros((), dtype=out_flat.dtype, device=flat.device))
    gate_of = gates.reshape(t * k)[order]
    contrib = gathered.to(torch.float32) * gate_of[:, None]        # (TK, D), sorted
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=flat.device)
    by_expert = torch.sort(rank.reshape(t, k), dim=1).values
    out_tok = contrib[by_expert[:, 0]]
    for j in range(1, k):
        out_tok = out_tok + contrib[by_expert[:, j]]

    if "shared" in p_loc:
        sp = p_loc["shared"]
        hs = F.silu(flat @ sp["w_gate"]) * (flat @ sp["w_up"])
        y = (hs @ sp["w_down"]).to(torch.float32)
        if tp > 1:
            from torch.distributed.nn.functional import all_reduce

            y = all_reduce(y, group=tp_group)
        out_tok = out_tok + y

    out = out_tok.to(x_loc.dtype).reshape(b, s, d)
    x_place = placements_for(x_spec, mesh)
    out = DTensor.from_local(out, mesh, x_place, run_check=False)
    if was_dtensor:
        from torch.distributed.tensor import Replicate

        return out, DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return out.full_tensor(), aux
