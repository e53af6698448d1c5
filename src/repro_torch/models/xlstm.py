"""xLSTM blocks — mLSTM (matrix memory) + sLSTM (scalar memory), arXiv:2405.04517.

mLSTM: attention-like parallel form for prefill (stabilised exponential
gating), a chunkwise-parallel form for long prompts, and the O(1)-state
recurrent form for decode.

    C_t = f_t C_{t-1} + i_t v_t k_t^T      (matrix memory, per head)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t · q_t|, exp(-m_t))

sLSTM: a strictly sequential scalar-memory cell with block-diagonal
recurrent weights (one block per head), a loop over time.

Block layout (the blocks carry their own up / down projections):
  mLSTM block: LN -> up(2·di) -> [conv4 -> silu -> q,k | v] -> mLSTM
               -> GN -> ⊙ silu(z) -> down
  sLSTM block: LN -> sLSTM cell (4 gates, recurrent h) -> GN -> down
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParallelPlan, dense_init, inv_sqrt
from repro_torch.models.sharding_ctx import (P, _sharded_ranks, batch_shards, merge_last,
                                             replicated, split_heads_axis, split_last,
                                             split_shards, whole_along)
from repro_torch.models.rglru import CONV_K, _causal_conv1d


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a ``DTensor`` through a ``Replicate()`` detour
    (``DTensor`` has no sharding rule for its backward)."""
    return replicated(F.logsigmoid, x)


def _heads(cfg: ModelConfig) -> tuple[int, int, int]:
    di = cfg.d_inner_xlstm
    nh = cfg.n_heads
    return di, nh, di // nh


def _causal_mask(n: int, device) -> torch.Tensor:
    tpos = torch.arange(n, device=device)
    return tpos[:, None] >= tpos[None, :]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _block_diag(generator: torch.Generator, shape: tuple, dh: int, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (w / torch.sqrt(torch.tensor(float(dh)))).to(dtype)


def init_mlstm_block(generator: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype = torch.float32) -> dict:
    d = cfg.d_model
    di, nh, dh = _heads(cfg)
    w_up = dense_init(generator, d, 2 * di, dtype)
    conv_w = (torch.randn((CONV_K, di), generator=generator) * 0.1).to(dtype)
    wq, wk, wv = (_block_diag(generator, (nh, dh, dh), dh, dtype) for _ in range(3))
    w_i = dense_init(generator, di, nh, dtype)
    w_f = dense_init(generator, di, nh, dtype)
    w_down = dense_init(generator, di, d, dtype)
    return {
        "w_up": w_up,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), dtype=dtype),
        "wq": wq, "wk": wk, "wv": wv,
        "w_i": w_i,
        "b_i": torch.zeros((nh,), dtype=dtype),
        "w_f": w_f,
        "b_f": torch.full((nh,), 3.0, dtype=dtype),      # forget-gate bias: remember
        "gn": torch.ones((di,), dtype=dtype),
        "w_down": w_down,
    }


def spec_mlstm_block(cfg: ModelConfig, plan: ParallelPlan) -> dict:
    w_in = plan.fsdp_axis if plan.fsdp else None
    tp = plan.tp_axis
    return {
        "w_up": P(w_in, tp),
        "conv_w": P(None, tp), "conv_b": P(tp),
        # heads (nh=4) generally don't divide tp=16 -> shard the dh dims
        "wq": P(None, None, tp), "wk": P(None, None, tp), "wv": P(None, None, tp),
        "w_i": P(tp, None), "b_i": P(None),
        "w_f": P(tp, None), "b_f": P(None),
        "gn": P(tp),
        "w_down": P(tp, w_in),
    }


def _group_norm(x: torch.Tensor, scale: torch.Tensor, nh: int) -> torch.Tensor:
    """Per-head RMS norm over the head channels. x (..., di)."""
    xh = split_last(x, nh).to(torch.float32)
    var = torch.mean(xh * xh, dim=-1, keepdim=True)
    xh = xh * torch.rsqrt(var + 1e-6)
    return (merge_last(xh) * scale.to(torch.float32)).to(x.dtype)


def _mlstm_out(h, z, gn, w_down) -> torch.Tensor:
    """The block's tail: h (B,S,NH,dh) merged, group-normed, gated by
    silu(z) (B,S,di) and projected down to (B,S,D)."""
    return (_group_norm(merge_last(h), gn, h.shape[-2]) * F.silu(z)) @ w_down


def _inner_width_split(p: dict, x: torch.Tensor) -> bool:
    """Whether the block keeps xi and z at each rank's share of the inner
    width (the ``DTensor`` route of :func:`_mlstm_qkvif`): where the up
    projection's columns lie over mesh ranks and a rank's rows of x (B/dp
    x S) outnumber its width D, so that gathering ``w_up`` (D x 2·di)
    moves fewer bytes than gathering the product (B/dp x S x 2·di):
    prefill and training, not a decode step."""
    return (_sharded_ranks(p["w_up"], 1) > 1
            and x.shape[0] * x.shape[1] > _sharded_ranks(x, 0) * x.shape[-1])


def _up_halves(w_up: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The xi and z halves of ``DTensor`` ``w_up`` (D, 2·di), each (D, di)
    laid out as ``w_up`` is, its columns over the model axis: ``w_up`` is
    gathered whole along its columns (weight bytes), split, and each half's
    share taken on each rank. ``torch.chunk`` of the (B, S, 2·di) product
    would gather the activations instead: ranks 0-7 of 16 hold xi's
    columns, 8-15 z's."""
    w = whole_along(w_up, 1)
    di = w.shape[1] // 2
    return tuple(h.redistribute(w_up.device_mesh, w_up.placements)
                 for h in (w[:, :di], w[:, di:]))


def _gathered(x, group, dim: int = -1) -> torch.Tensor:
    """Local ``x`` gathered whole along ``dim`` over the ranks of
    ``group``."""
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_gather_tensor(x.contiguous(), dim % x.dim(), group))


def _gathered_heads(xs, nh: int, group) -> list[torch.Tensor]:
    """Each local (b, S, di/k) tensor of ``xs`` gathered whole along its
    width over the k ranks of ``group`` and viewed as (b, S, nh, dh): the
    transient gather of :class:`_HeadProducts`."""
    return [g.reshape(*g.shape[:-1], nh, g.shape[-1] // nh)
            for g in (_gathered(x, group) for x in xs)]


def _gathered_heads_backward(xc, xi, wq, wk, wv, w_i, w_f, gq, gk, gv, gi, gf, nh: int,
                             group):
    """:class:`_HeadProducts`' gradients: the inputs gathered again, the
    head weights' shards from them, and each input's gradient of the head
    products, a sum over the ranks' shares of the output width,
    reduce-scattered to its shard; the gates' terms are local (their
    gradients are whole on every rank of the group)."""
    from torch.distributed import _functional_collectives as funcol

    xch, xih = _gathered_heads((xc, xi), nh, group)
    gw = [torch.einsum("bsnd,bsne->nde", a, g) for a, g in ((xch, gq), (xch, gk), (xih, gv))]
    gxs = []
    for terms in (((gq, wq), (gk, wk)), ((gv, wv),)):
        g = sum(torch.einsum("bsne,nde->bsnd", gt, w) for gt, w in terms)
        g = g.reshape(*g.shape[:-2], g.shape[-2] * g.shape[-1])
        gxs.append(funcol.wait_tensor(
            funcol.reduce_scatter_tensor(g.contiguous(), "sum", g.dim() - 1, group)))
    gxs[1] = gxs[1] + gi @ w_i.transpose(0, 1) + gf @ w_f.transpose(0, 1)
    gw += [torch.einsum("bsd,bsn->dn", xi, g) for g in (gi, gf)]
    return (*gxs, *gw)


class _HeadProducts(torch.autograd.Function):
    """The mLSTM's q, k (of xc) and v (of xi) products
    ``einsum("bsnd,nde->bsne", ·, w)`` and its gates' ``xi @ w_i``,
    ``xi @ w_f`` on one rank's shards: xc and xi (b, S, di/k) split along
    their inner width over the k ranks of ``group`` (heads that k does not
    divide), the head weights' output width split over them (NH, dh,
    dh/k), so q, k, v are each rank's (b, S, NH, dh/k) share, and the
    gates' rows (di/k, NH), their (b, S, NH) products whole on each rank.
    Each input is gathered whole along its width for the products (and
    the gates' weights for theirs: each product the one-device dot), and
    again in the backward: the step keeps only the shards for it
    (``DTensor``'s einsums would keep the gathered inputs, and its gate
    products' backward would make xi's gradient whole)."""

    @staticmethod
    def forward(ctx, xc, xi, wq, wk, wv, w_i, w_f, nh, group):
        xch, xih = _gathered_heads((xc, xi), nh, group)
        ctx.save_for_backward(xc, xi, wq, wk, wv, w_i, w_f)
        ctx.nh, ctx.group = nh, group
        xw = xih.reshape(*xih.shape[:-2], xih.shape[-2] * xih.shape[-1])
        return (*(torch.einsum("bsnd,nde->bsne", a, w)
                  for a, w in ((xch, wq), (xch, wk), (xih, wv))),
                *(xw @ _gathered(w, group, 0) for w in (w_i, w_f)))

    @staticmethod
    def backward(ctx, gq, gk, gv, gi, gf):
        return (*_gathered_heads_backward(*ctx.saved_tensors, gq, gk, gv, gi, gf, ctx.nh,
                                          ctx.group), None, None)


def _laid_out(x, placements):
    """``DTensor`` ``x`` redistributed to ``placements`` where it lies
    otherwise (a redistribution to its own layout still adds an autograd
    node, whose backward gathered the gradient)."""
    return x if tuple(x.placements) == tuple(placements) else x.redistribute(
        x.device_mesh, placements)


def _head_products(xc, xi, wq, wk, wv, w_i, w_f):
    """q, k, v (B,S,NH,dh) from xc and xi (B,S,di), and the gates'
    products ``xi @ w_i``, ``xi @ w_f`` (B,S,NH). On ``DTensor``s whose
    inner width lies over ranks that do not divide the heads, through
    :class:`_HeadProducts` on each rank's shards, q, k, v coming out with
    their head width over those ranks as wq's is, the gates' products
    whole over them; elsewhere the einsums of the head views
    (``split_last``) and the products as they are."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    nh = wq.shape[0]
    if not isinstance(xc, DTensor) or nh % _sharded_ranks(xc, -1) == 0:
        xch, xih = split_last(xc, nh), split_last(xi, nh)
        return (*(torch.einsum("bsnd,nde->bsne", a, w)
                  for a, w in ((xch, wq), (xch, wk), (xih, wv))), xi @ w_i, xi @ w_f)
    mesh = xc.device_mesh
    width = [isinstance(p, Shard) and p.dim == xc.dim() - 1 for p in xc.placements]
    batch = [isinstance(p, Shard) and p.dim == 0 for p in xc.placements]
    axis = width.index(True)

    def layout(dim, other):
        """``dim`` split over the width's axis (whole where ``None``), the
        batch's axes laid out as ``other``."""
        return [(Replicate() if dim is None else Shard(dim)) if i == axis
                else other if b else Replicate() for i, b in enumerate(batch)]

    acts = [_laid_out(a, layout(2, Shard(0))).to_local() for a in (xc, xi)]
    ws = [_laid_out(w, layout(w.dim() - 1, Replicate())).to_local(
        grad_placements=layout(w.dim() - 1, Partial())) for w in (wq, wk, wv)]
    ws += [_laid_out(w, layout(0, Replicate())).to_local(grad_placements=layout(0, Partial()))
           for w in (w_i, w_f)]
    out = _HeadProducts.apply(*acts, *ws, nh, (mesh, axis))
    return (*(DTensor.from_local(t, mesh, layout(3, Shard(0)), run_check=False)
              for t in out[:3]),
            *(DTensor.from_local(t, mesh, layout(None, Shard(0)), run_check=False)
              for t in out[3:]))


def _mlstm_qkvif(p: dict, x: torch.Tensor, conv_state=None, z_weight: bool = False):
    """x (B,S,D) -> q,k,v (B,S,NH,dh), i,f raw gates (B,S,NH), z, conv_state.

    On ``DTensor``s whose inner width lies over mesh ranks (outside a
    decode step, :func:`_inner_width_split`), xi and z come out at each
    rank's share of it: x (made whole along S) times each half
    of ``w_up`` (:func:`_up_halves`), and the head products through
    :func:`_head_products`; with ``z_weight`` the z half of ``w_up`` takes
    z's place (the tail that runs on row blocks makes each block's z).
    Elsewhere the up product is split in two."""
    if _inner_width_split(p, x):
        w_xi, w_z = _up_halves(p["w_up"])
        x = whole_along(x, 1)
        xi = x @ w_xi
        z = w_z if z_weight else x @ w_z
    else:
        up = x @ p["w_up"]
        xi, z = torch.chunk(up, 2, dim=-1)
    xc, conv_new = _causal_conv1d(xi, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    q, k, v, i_pre, f_pre = _head_products(xc, xi, p["wq"], p["wk"], p["wv"], p["w_i"],
                                           p["w_f"])
    i_raw = (i_pre + p["b_i"]).to(torch.float32)
    f_raw = (f_pre + p["b_f"]).to(torch.float32)
    return q, k, v, i_raw, f_raw, z, conv_new


def mlstm_parallel(q, k, v, i_raw, f_raw, rows=None) -> torch.Tensor:
    """Stabilised parallel (quadratic) form. q/k/v (B,S,NH,dh) -> (B,S,NH,dh).

    ``rows``: the positions of ``q``'s rows, where ``q`` holds T of the S
    query positions (a rank's block, :func:`_mlstm_parallel_shards`); the
    result is then those T rows (B,T,NH,dh), each against every key."""
    b, s, nh, dh = k.shape
    lf = _logsigmoid(f_raw)                           # (B,S,NH)
    lfc = torch.cumsum(lf, dim=1)                      # inclusive Σ log f
    # pair weight (t, j): lfc_t - lfc_j + i_j, j <= t
    lfc_t = lfc if rows is None else lfc.index_select(1, rows)
    dmat = lfc_t[:, :, None, :] - lfc[:, None, :, :] + i_raw[:, None, :, :]
    causal = (_causal_mask(s, q.device) if rows is None
              else rows[:, None] >= torch.arange(s, device=q.device)[None, :])
    dmat = torch.where(causal[None, :, :, None], dmat,
                       torch.full((), -math.inf, device=q.device))  # (B,T,J,NH)
    m = torch.amax(dmat, dim=2)                        # (B,T,NH)
    dexp = torch.exp(dmat - m[:, :, None, :])
    scale = inv_sqrt(dh, q.device)
    # head-major products, (B,NH,T,J) and (B,NH,T,dh): the same sums as the
    # einsums "btnd,bjnd->btjn" and "btjn,bjnd->btnd", written as matmuls of
    # permuted operands so a DTensor's shards take the layouts of its
    # global tensor (einsum's own reshapes may view a shard that cannot be)
    qh = (q.to(torch.float32) * scale).permute(0, 2, 1, 3)
    sc = (qh @ k.to(torch.float32).permute(0, 2, 3, 1)) * dexp.permute(0, 3, 1, 2)
    num = (sc @ v.to(torch.float32).permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
    denom = torch.maximum(torch.abs(torch.sum(sc, dim=3).permute(0, 2, 1)),
                          torch.exp(-m))                                      # (B,T,NH)
    return (num / denom[..., None]).to(q.dtype)


def _mlstm_parallel_shards(q, k, v, i_raw, f_raw, keep_rows: bool = False) -> torch.Tensor:
    """:func:`mlstm_parallel` on each rank's share of ``DTensor``s: its shard
    of the batch, and of the heads where a mesh axis past the batch's
    divides them (``batch_shards``); else of the query rows over the
    other axes, each row block against every key (``split_shards``: the
    reference's split of the positions over "model", as its 4 heads do
    not divide the production mesh's 16). The result, rows split, is made
    whole along the positions (gathered over "model": torch 2.11 cannot
    flatten (B, S) with both dims sharded, which the head merge does), or,
    with ``keep_rows``, comes back rows split for a tail that runs on the
    row blocks. A plain tensor: ``mlstm_parallel``."""
    nh = q.shape[2]
    if split_heads_axis(q, nh) is not None:
        return batch_shards(lambda *a: (mlstm_parallel(*a),), q, k, v, i_raw, f_raw,
                            heads=(nh, (2,) * 5, (2,)))[0]
    h, = split_shards(lambda *a, rows=None: (mlstm_parallel(*a, rows=rows),),
                      (q, k, v, i_raw, f_raw), (1, None, None, None, None), (1,),
                      positions=q.shape[1])
    return h if keep_rows else whole_along(h, 1)


def mlstm_step(state: dict, q, k, v, i_raw, f_raw):
    """Recurrent step. q/k/v (B,NH,dh); state {C (B,NH,dh,dh), n, m}."""
    lf = _logsigmoid(f_raw)                           # (B,NH)
    m_new = torch.maximum(lf + state["m"], i_raw)
    fp = torch.exp(lf + state["m"] - m_new)[..., None]
    ip = torch.exp(i_raw - m_new)[..., None]
    k32, v32, q32 = (t.to(torch.float32) for t in (k, v, q))
    c_new = fp[..., None] * state["C"] + ip[..., None] * (v32[..., :, None] * k32[..., None, :])
    n_new = fp * state["n"] + ip * k32
    dh = q.shape[-1]
    q32 = q32 / torch.sqrt(torch.full((), dh, dtype=torch.float32, device=q.device))
    num = torch.einsum("bnvk,bnk->bnv", c_new, q32)
    den = torch.maximum(torch.abs(torch.einsum("bnk,bnk->bn", n_new, q32)), torch.exp(-m_new))
    h = (num / den[..., None]).to(q.dtype)
    return {"C": c_new, "n": n_new, "m": m_new}, h


def mlstm_chunkwise(q, k, v, i_raw, f_raw, chunk: int) -> tuple[torch.Tensor, dict]:
    """Chunkwise-parallel mLSTM: O(S·L) memory instead of the O(S²)
    stabilised gate matrix — intra-chunk quadratic attention plus an
    inter-chunk recurrent state carry, with the parallel form's stabiliser
    algebra. Returns (h (B,S,NH,dh), final recurrent cell state)."""
    b, s, nh, dh = q.shape
    dev = q.device
    if s % chunk:
        pad = chunk - s % chunk
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, pad), value=-1e30)
        f_raw = F.pad(f_raw, (0, 0, 0, pad), value=30.0)
    n_chunks = q.shape[1] // chunk

    def split(t):
        return t.reshape(b, n_chunks, chunk, *t.shape[2:]).transpose(0, 1)

    qc, kc, vc, ic, fc = (split(t.to(torch.float32)) for t in (q, k, v, i_raw, f_raw))
    scale = inv_sqrt(dh, dev)
    causal = _causal_mask(chunk, dev)
    neg_inf = torch.full((), -math.inf, device=dev)

    c_run = torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=dev)
    n_run = torch.zeros((b, nh, dh), dtype=torch.float32, device=dev)
    m_run = torch.full((b, nh), -1e30, dtype=torch.float32, device=dev)
    hs = []
    for ci in range(n_chunks):
        qq, kk, vv, ii, ff = qc[ci], kc[ci], vc[ci], ic[ci], fc[ci]
        lf = _logsigmoid(ff)
        lfc = torch.cumsum(lf, dim=1)                  # in-chunk Σ log f
        dmat = lfc[:, :, None, :] - lfc[:, None, :, :] + ii[:, None, :, :]
        dmat = torch.where(causal[None, :, :, None], dmat, neg_inf)
        m_intra = torch.amax(dmat, dim=2)              # (B, L, NH)
        w_inter = lfc + m_run[:, None, :]              # carry weight at t
        m_t = torch.maximum(m_intra, w_inter)
        dexp = torch.exp(dmat - m_t[:, :, None, :])
        sc = torch.einsum("btnd,bjnd->btjn", qq * scale, kk) * dexp
        num = torch.einsum("btjn,bjnd->btnd", sc, vv)
        den = torch.sum(sc, dim=2)                     # (B, L, NH)
        e_int = torch.exp(w_inter - m_t)               # (B, L, NH)
        num = num + e_int[..., None] * torch.einsum("bnvk,btnk->btnv", c_run, qq * scale)
        den = den + e_int * torch.einsum("bnk,btnk->btn", n_run, qq * scale)
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None])
        # fold the chunk into the carry
        w_end = lfc[:, -1:, :] - lfc + ii              # (B, L, NH)
        m_fold = torch.maximum(torch.amax(w_end, dim=1), lfc[:, -1, :] + m_run)
        we = torch.exp(w_end - m_fold[:, None, :])
        carry_w = torch.exp(lfc[:, -1, :] + m_run - m_fold)
        c_run = carry_w[..., None, None] * c_run + torch.einsum("btn,btnv,btnk->bnvk", we, vv, kk)
        n_run = carry_w[..., None] * n_run + torch.einsum("btn,btnk->bnk", we, kk)
        m_run = m_fold
    h = torch.stack(hs, dim=1).reshape(b, n_chunks * chunk, nh, dh)[:, :s]
    return h.to(q.dtype), {"C": c_run, "n": n_run, "m": m_run}


def mlstm_final_state(k, v, i_raw, f_raw) -> dict:
    """Fold a full sequence into the end-of-sequence recurrent state:
    C_S = Σ_j exp(lfc_S - lfc_j + i_j - m_S) v_j k_j^T (stabilised)."""
    lf = _logsigmoid(f_raw)
    lfc = torch.cumsum(lf, dim=1)                      # (B,S,NH)
    w = lfc[:, -1:, :] - lfc + i_raw                   # (B,S,NH)
    m = torch.amax(w, dim=1)                           # (B,NH)
    ww = torch.exp(w - m[:, None, :])
    k32, v32 = k.to(torch.float32), v.to(torch.float32)
    c = torch.einsum("bsn,bsnv,bsnk->bnvk", ww, v32, k32)
    n = torch.einsum("bsn,bsnk->bnk", ww, k32)
    return {"C": c, "n": n, "m": m}


def _mlstm_final_state_shards(k, v, i_raw, f_raw) -> dict:
    """:func:`mlstm_final_state` on each rank's share of ``DTensor``s: its
    batch shard and its share of the key width (``split_shards``), the
    layout of the state's spec (C's and n's key dim over "model"); the
    values and the m stabiliser whole. A plain tensor: ``mlstm_final_state``."""
    c, n, m = split_shards(lambda *a: tuple(mlstm_final_state(*a).values()),
                           (k, v, i_raw, f_raw), (3, None, None, None), (3, 2, None))
    return {"C": c, "n": n, "m": m}


def mlstm_block_forward(p: dict, x: torch.Tensor, state: dict | None = None,
                        chunk_size: int = 0, final_state: bool = True
                        ) -> tuple[torch.Tensor, dict | None]:
    """The mLSTM block on x (B,S,D): (out (B,S,D), its recurrent state).
    Without ``final_state`` the parallel form does not fold the sequence
    into the state, and the state is ``None``: a training step's forward,
    whose state nothing reads (the reference's XLA drops that fold as dead
    code; run eagerly, its tensors stayed live in the backward's recompute).

    On ``DTensor``s every tensor of the inner width stays each rank's
    share of it (:func:`_mlstm_qkvif`). Where the heads do not divide the
    model axis (4 on the production mesh's 16) the parallel form runs on
    blocks of query rows, and so does the tail: each rank's rows of h,
    of z (from its rows of x and the z half of ``w_up``) and of the
    output, the inner width whole on its rows, a share of the (B, S, di)
    tensors all the same; the group norm needs each head whole, which the
    row blocks have."""
    nh = p["wq"].shape[0]
    conv_state = None if state is None else state["conv"]
    step = x.shape[1] == 1 and state is not None
    chunked = not step and bool(chunk_size) and x.shape[1] > chunk_size
    rows = (not step and not chunked and _inner_width_split(p, x)
            and split_heads_axis(x, nh) is None)
    q, k, v, i_raw, f_raw, z, conv_new = _mlstm_qkvif(p, x, conv_state, z_weight=rows)
    if step:
        cell = {"C": state["C"], "n": state["n"], "m": state["m"]}
        cell_new, h = mlstm_step(cell, q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0], f_raw[:, 0])
        h = h[:, None]
        new_state = {"conv": conv_new, **cell_new}
    elif chunked:
        h, cell = mlstm_chunkwise(q, k, v, i_raw, f_raw, chunk_size)
        new_state = {"conv": conv_new, **cell}
    else:
        # on DTensors, on each rank's share (batch and heads, or query rows)
        h = _mlstm_parallel_shards(q, k, v, i_raw, f_raw, keep_rows=rows)
        # fold the sequence into the final recurrent state (prefill -> decode)
        new_state = None
        if final_state:
            cell = _mlstm_final_state_shards(k, v, i_raw, f_raw)
            new_state = {"conv": conv_new, **cell}
        if rows:
            out, = split_shards(lambda h, x, w_z, gn, w_down: (_mlstm_out(h, x @ w_z, gn,
                                                                          w_down),),
                                (h, x), (1, 1), (1,), weights=(z, p["gn"], p["w_down"]))
            return out, new_state
    return _mlstm_out(h, z, p["gn"], p["w_down"]), new_state


def init_mlstm_state_cell(batch: int, nh: int, dh: int, device=None) -> dict:
    """The mLSTM cell (C, n, m) on ``device`` (the GPU by default)."""
    device = resolve_device(device)
    return {
        "C": torch.zeros((batch, nh, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, nh, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh), -1e30, dtype=torch.float32, device=device),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Conv state and cell on ``device`` (the GPU by default)."""
    device = resolve_device(device)
    di, nh, dh = _heads(cfg)
    return {
        "conv": torch.zeros((batch, CONV_K - 1, di), dtype=torch.bfloat16, device=device),
        **init_mlstm_state_cell(batch, nh, dh, device),
    }


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm_block(generator: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype = torch.float32) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    w = dense_init(generator, d, 4 * d, dtype)              # z,i,f,o from x
    r = _block_diag(generator, (4, nh, dh, dh), dh, dtype)
    w_down = dense_init(generator, d, d, dtype)
    return {
        "w": w,
        "r": r,
        "b": torch.cat([torch.zeros((2 * d,), dtype=dtype), torch.full((d,), 3.0, dtype=dtype),
                        torch.zeros((d,), dtype=dtype)]),
        "gn": torch.ones((d,), dtype=dtype),
        "w_down": w_down,
    }


def spec_slstm_block(cfg: ModelConfig, plan: ParallelPlan) -> dict:
    w_in = plan.fsdp_axis if plan.fsdp else None
    tp = plan.tp_axis
    return {
        "w": P(w_in, tp),
        "r": P(None, None, None, tp),
        "b": P(tp),
        "gn": P(tp),
        "w_down": P(tp, w_in),
    }


# The sLSTM's recurrence over time as one operator, the counterpart of the
# reference's ``lax.scan``: its forward loops over the positions on the
# tensors it is given, and its backward (a second operator) runs back over
# them from the states the forward saved. Under the dry run each is one
# traced op with a fake implementation and a flop formula, where the loop
# written inline was some twenty ops a position.

def slstm_scan_ref(gx, r, c, n, m, h, save: bool = True) -> tuple:
    """The sLSTM's time loop. gx (B,S,4,NH,dh) float32 input gate terms
    (z, i, f, o), r (4,NH,dh,dh) float32 recurrent weights, the state
    c, n, m, h (B,NH,dh). Returns hs (B,S,NH,dh), the final c, n, m, h,
    and, with ``save``, the gates' pre-activations (B,S,4,NH,dh) and the
    states c, n, m after each position (B,S,NH,dh), which the backward
    reads (empty tensors without ``save``). Each position's arithmetic is
    the loop ``slstm_forward`` ran inline before it became an operator."""
    b, s = gx.shape[:2]
    seq = (b, s) + tuple(h.shape[1:])
    hs = gx.new_empty(seq)
    saved = ((gx.new_empty(gx.shape), *(gx.new_empty(seq) for _ in range(3))) if save
             else tuple(gx.new_empty((0,)) for _ in range(4)))
    for t in range(s):
        # einsum("bnd,gnde->gbne") as a broadcast matmul over (gate, head)
        rec = (h.transpose(0, 1)[None] @ r).transpose(1, 2)
        g_t = gx[:, t] + rec.transpose(0, 1)
        z_r, i_r, f_r, o_r = g_t.unbind(1)
        z = torch.tanh(z_r)
        o = torch.sigmoid(o_r)
        lf = F.logsigmoid(f_r)
        m_new = torch.maximum(lf + m, i_r)
        ip = torch.exp(i_r - m_new)
        fp = torch.exp(lf + m - m_new)
        c = fp * c + ip * z
        n = fp * n + ip
        h = o * c / torch.clamp_min(n, 1e-6)
        m = m_new
        hs[:, t] = h
        if save:
            for buf, x in zip(saved, (g_t, c, n, m)):
                buf[:, t] = x
    return (hs, *(x.contiguous() for x in (c, n, m, h)), *saved)


def slstm_scan_backward_ref(dhs, dc, dn, dm, dh, r, pre, cs, ns, ms, hs, c0, n0, m0, h0
                            ) -> tuple:
    """Backpropagation through :func:`slstm_scan_ref`'s loop from the
    states it saved, back over the positions: the gradients of gx, r and
    the initial c, n, m, h, given those of hs and the final c, n, m, h.
    Each position's derivative follows the forward's arithmetic as
    autograd differentiates it: ``torch.maximum`` gives each side half
    the gradient at a tie, as ``jnp.maximum`` does; ``clamp_min(n, 1e-6)``
    gives all of it to n where n >= 1e-6 and none below."""
    s = pre.shape[1]
    rt = r.transpose(-1, -2)
    dgx = pre.new_empty(pre.shape)
    for t in range(s - 1, -1, -1):
        c_prev, n_prev, m_prev = ((x[:, t - 1] if t else x0) for x, x0 in
                                  ((cs, c0), (ns, n0), (ms, m0)))
        c, n, m_new = cs[:, t], ns[:, t], ms[:, t]
        z_r, i_r, f_r, o_r = pre[:, t].unbind(1)
        z = torch.tanh(z_r)
        o = torch.sigmoid(o_r)
        lf = F.logsigmoid(f_r)
        a = lf + m_prev
        ip = torch.exp(i_r - m_new)
        fp = torch.exp(a - m_new)
        den = torch.clamp_min(n, 1e-6)
        # h = (o * c) / den
        dh_t = dhs[:, t] + dh
        doc = dh_t / den
        dden = -dh_t * ((o * c / den) / den)
        dc = dc + doc * o
        dn = dn + torch.where(n >= 1e-6, dden, 0.0)
        # c = fp * c_prev + ip * z; n = fp * n_prev + ip
        dfp = dc * c_prev + dn * n_prev
        dip = dc * z + dn
        dz = dc * ip
        dc, dn = dc * fp, dn * fp
        # ip = exp(i - m_new), fp = exp(a - m_new), m_new = max(a, i)
        di = dip * ip
        da = dfp * fp
        dmx = dm - di - da
        half = torch.where(a == i_r, 0.5, 1.0) * dmx
        da = da + torch.where(a >= i_r, half, 0.0)
        di = di + torch.where(i_r >= a, half, 0.0)
        # a = lf + m_prev, lf = logsigmoid(f)
        dm = da
        dg = torch.stack((dz * (1 - z * z), di, da * torch.sigmoid(-f_r),
                          doc * c * o * (1 - o)), dim=1)
        dgx[:, t] = dg
        # rec = h_prev @ r per (gate, head): dh_prev = sum_g dg_g @ r_g^T
        dh = (dg.transpose(0, 1).transpose(1, 2) @ rt).sum(0).transpose(0, 1)
    # dr[g,n] = sum over (b, t) of h_prev^T dg, one product over all positions
    b, _, nh, dh_ = hs.shape
    h_prev = torch.cat((h0[:, None], hs[:, :-1]), dim=1)
    hp = h_prev.permute(2, 3, 0, 1).reshape(1, nh, dh_, b * s)
    dgp = dgx.permute(2, 3, 0, 1, 4).reshape(4, nh, b * s, dh_)
    dr = hp @ dgp
    return tuple(x.contiguous() for x in (dgx, dr, dc, dn, dm, dh))


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def _slstm_scan_op(gx: torch.Tensor, r: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                   m: torch.Tensor, h: torch.Tensor, save: bool
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    return slstm_scan_ref(gx, r, c, n, m, h, save)


@_slstm_scan_op.register_fake
def _(gx, r, c, n, m, h, save):
    seq = tuple(gx.shape[:2]) + tuple(h.shape[1:])
    saved = ((gx.new_empty(gx.shape), *(gx.new_empty(seq) for _ in range(3))) if save
             else tuple(gx.new_empty((0,)) for _ in range(4)))
    return (gx.new_empty(seq), *(x.new_empty(x.shape) for x in (c, n, m, h)), *saved)


@torch.library.custom_op("repro_torch::slstm_scan_backward", mutates_args=())
def _slstm_scan_backward_op(dhs: torch.Tensor, dc: torch.Tensor, dn: torch.Tensor,
                            dm: torch.Tensor, dh: torch.Tensor, r: torch.Tensor,
                            pre: torch.Tensor, cs: torch.Tensor, ns: torch.Tensor,
                            ms: torch.Tensor, hs: torch.Tensor, c0: torch.Tensor,
                            n0: torch.Tensor, m0: torch.Tensor, h0: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    return slstm_scan_backward_ref(dhs, dc, dn, dm, dh, r, pre, cs, ns, ms, hs, c0, n0, m0, h0)


@_slstm_scan_backward_op.register_fake
def _(dhs, dc, dn, dm, dh, r, pre, cs, ns, ms, hs, c0, n0, m0, h0):
    return tuple(x.new_empty(x.shape) for x in (pre, r, c0, n0, m0, h0))


def _scan_setup(ctx, inputs, output):
    _, r, c, n, m, h, _ = inputs
    hs, *_, pre, cs, ns, ms = output
    ctx.mark_non_differentiable(pre, cs, ns, ms)
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(r, pre, cs, ns, ms, hs, c, n, m, h)


def _scan_backward(ctx, dhs, dc, dn, dm, dh, *_):
    r, pre, cs, ns, ms, hs, c0, n0, m0, h0 = ctx.saved_tensors
    if not pre.numel():
        raise RuntimeError("slstm_scan ran without save=True, so it kept nothing to "
                           "differentiate")
    dhs, dc, dn, dm, dh = (torch.zeros_like(like) if g is None else g for g, like in
                           zip((dhs, dc, dn, dm, dh), (hs, c0, n0, m0, h0)))
    dgx, dr, dc0, dn0, dm0, dh0 = torch.ops.repro_torch.slstm_scan_backward(
        dhs, dc, dn, dm, dh, r, pre, cs, ns, ms, hs, c0, n0, m0, h0)
    return dgx, dr, dc0, dn0, dm0, dh0, None


_slstm_scan_op.register_autograd(_scan_backward, setup_context=_scan_setup)


def _register_flop_formulas():
    """The recurrent product's flops, as the trace and ``FlopCounterMode``
    count a matmul's: 2·B·S·4·NH·dh² forward (a position's (B,dh) x
    (dh,dh) product per gate and head), twice that backward (the carried
    gradient's product per position and r's over all positions)."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    def fwd(gx_shape, r_shape, *_, out_shape=None, **__):
        g, nh, dh, _ = r_shape
        return 2 * gx_shape[0] * gx_shape[1] * g * nh * dh * dh

    def bwd(dhs_shape, dc_shape, dn_shape, dm_shape, dh_shape, r_shape, *_, out_shape=None,
            **__):
        g, nh, dh, _ = r_shape
        return 4 * dhs_shape[0] * dhs_shape[1] * g * nh * dh * dh

    for op, formula in ((torch.ops.repro_torch.slstm_scan, fwd),
                        (torch.ops.repro_torch.slstm_scan_backward, bwd)):
        if op not in flop_registry:
            register_flop_formula(op)(formula)


_register_flop_formulas()


def _scan_local(gx, c, n, m, h, r):
    """The op on one rank's tensors (all of them, off a mesh), from a zero
    state where none is given; keeps what the backward reads only where a
    gradient can be asked for. Returns hs, c, n, m, h."""
    if c is None:
        b, _, _, nh, dh = gx.shape
        st = _zero_slstm_state(b, nh, dh, gx.device)
        c, n, m, h = st["c"], st["n"], st["m"], st["h"].reshape(b, nh, dh)
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (gx, r, c, n, m, h))
    return torch.ops.repro_torch.slstm_scan(gx, r, c, n, m, h, save)[:5]


def slstm_forward(p: dict, x: torch.Tensor, state: dict | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """x (B,S,D). The recurrence over time (sLSTM is not parallelisable)
    is one op, ``torch.ops.repro_torch.slstm_scan``, and one backward op:
    the reference's ``lax.scan``. On ``DTensor``s each rank runs it on its
    shard of the batch, with r and each head's width whole, and of the
    heads where the model axis divides them (``batch_shards``); the dry
    run traces it as one op a direction and counts its flops by the
    op's formula."""
    nh = p["r"].shape[1]
    gx = split_last(split_last((x @ p["w"] + p["b"]).to(torch.float32), 4), nh)
    r32 = p["r"].to(torch.float32)
    st = (None,) * 4 if state is None else (
        state["c"], state["n"], state["m"], split_last(state["h"], nh))
    hs, c, n, m, h = batch_shards(_scan_local, gx, *st, weights=(r32,),
                                  heads=(nh, (3, 1, 1, 1, 1, 1), (2, 1, 1, 1, 1)))
    out = _group_norm(merge_last(hs).to(x.dtype), p["gn"], nh) @ p["w_down"]
    return out, {"c": c, "n": n, "m": m, "h": merge_last(h)}


def _zero_slstm_state(batch: int, nh: int, dh: int, device=None) -> dict:
    return {
        "c": torch.zeros((batch, nh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, nh, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh, dh), -1e30, dtype=torch.float32, device=device),
        "h": torch.zeros((batch, nh * dh), dtype=torch.float32, device=device),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Zero sLSTM state on ``device`` (the GPU by default)."""
    device = resolve_device(device)
    d = cfg.d_model
    nh = cfg.n_heads
    return _zero_slstm_state(batch, nh, d // nh, device)
