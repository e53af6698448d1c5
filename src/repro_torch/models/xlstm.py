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
from repro_torch.models.sharding_ctx import (P, batch_shards, merge_last, replicated,
                                             split_last)
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


def _mlstm_qkvif(p: dict, x: torch.Tensor, conv_state=None):
    """x (B,S,D) -> q,k,v (B,S,NH,dh), i,f raw gates (B,S,NH), z, conv_state."""
    nh = p["wq"].shape[0]
    up = x @ p["w_up"]
    xi, z = torch.chunk(up, 2, dim=-1)
    xc, conv_new = _causal_conv1d(xi, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)
    # heads that do not divide the model axis: the inner width is made whole
    # first (split_last), the products below shard the head width as wq does
    xch = split_last(xc, nh)
    xih = split_last(xi, nh)
    q = torch.einsum("bsnd,nde->bsne", xch, p["wq"])
    k = torch.einsum("bsnd,nde->bsne", xch, p["wk"])
    v = torch.einsum("bsnd,nde->bsne", xih, p["wv"])
    i_raw = (xi @ p["w_i"] + p["b_i"]).to(torch.float32)
    f_raw = (xi @ p["w_f"] + p["b_f"]).to(torch.float32)
    return q, k, v, i_raw, f_raw, z, conv_new


def mlstm_parallel(q, k, v, i_raw, f_raw) -> torch.Tensor:
    """Stabilised parallel (quadratic) form. q/k/v (B,S,NH,dh) -> (B,S,NH,dh)."""
    b, s, nh, dh = q.shape
    lf = _logsigmoid(f_raw)                           # (B,S,NH)
    lfc = torch.cumsum(lf, dim=1)                      # inclusive Σ log f
    # pair weight (t, j): lfc_t - lfc_j + i_j, j <= t
    dmat = lfc[:, :, None, :] - lfc[:, None, :, :] + i_raw[:, None, :, :]
    causal = _causal_mask(s, q.device)
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


def mlstm_block_forward(p: dict, x: torch.Tensor, state: dict | None = None,
                        chunk_size: int = 0) -> tuple[torch.Tensor, dict]:
    nh = p["wq"].shape[0]
    conv_state = None if state is None else state["conv"]
    q, k, v, i_raw, f_raw, z, conv_new = _mlstm_qkvif(p, x, conv_state)
    if x.shape[1] == 1 and state is not None:
        cell = {"C": state["C"], "n": state["n"], "m": state["m"]}
        cell_new, h = mlstm_step(cell, q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0], f_raw[:, 0])
        h = h[:, None]
        new_state = {"conv": conv_new, **cell_new}
    elif chunk_size and x.shape[1] > chunk_size:
        h, cell = mlstm_chunkwise(q, k, v, i_raw, f_raw, chunk_size)
        new_state = {"conv": conv_new, **cell}
    else:
        # on DTensors, on each rank's batch shard (see sharding_ctx.batch_shards)
        h = batch_shards(mlstm_parallel, q, k, v, i_raw, f_raw)
        # fold the sequence into the final recurrent state (prefill -> decode)
        cell = mlstm_final_state(k, v, i_raw, f_raw)
        new_state = {"conv": conv_new, **cell}
    hflat = merge_last(h)
    out = (_group_norm(hflat, p["gn"], nh) * F.silu(z)) @ p["w_down"]
    return out, new_state


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


def slstm_forward(p: dict, x: torch.Tensor, state: dict | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """x (B,S,D). A sequential loop over time (sLSTM is not parallelisable)."""
    b, s, d = x.shape
    nh = p["r"].shape[1]
    dh = d // nh
    if state is None:
        state = _zero_slstm_state(b, nh, dh, x.device)
    gx = split_last(split_last((x @ p["w"] + p["b"]).to(torch.float32), 4), nh)
    r32 = p["r"].to(torch.float32)
    c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    hs = []
    for t in range(s):
        g_t = gx[:, t]
        # einsum("bnd,gnde->gbne") as a broadcast matmul over (gate, head):
        # torch 2.11's DTensor cannot flatten einsum's (gate, head width) with
        # the head width sharded
        rec = (split_last(h, nh).transpose(0, 1)[None] @ r32).transpose(1, 2)
        z_r, i_r, f_r, o_r = (g_t[:, gi] + rec[gi] for gi in range(4))
        z = torch.tanh(z_r)
        o = torch.sigmoid(o_r)
        lf = _logsigmoid(f_r)
        m_new = torch.maximum(lf + m, i_r)
        ip = torch.exp(i_r - m_new)
        fp = torch.exp(lf + m - m_new)
        c = fp * c + ip * z
        n = fp * n + ip
        h = merge_last(o * c / torch.clamp_min(n, 1e-6))
        m = m_new
        hs.append(h)
    hs = torch.stack(hs, dim=1)                                   # (B,S,D)
    out = _group_norm(hs.to(x.dtype), p["gn"], nh) @ p["w_down"]
    return out, {"c": c, "n": n, "m": m, "h": h}


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
