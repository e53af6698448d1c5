"""GQA attention: chunked online-softmax prefill, KV-cached decode, local
windows, RoPE, the parallel plan's head geometry, and the int8 KV cache.

Parameters keep the reference's layouts: wq (d, hq, dh), wk / wv
(d, hkv, dh), wo (hq, dh, d), biases (h, dh). Prefill never forms the
(S, T) score matrix for more than one key chunk at a time; decode
attends one query against the cache. The arithmetic follows the
reference op for op in plain torch ops (no fused attention call), so the
numbers track the reference's.
"""

from __future__ import annotations

import torch

from repro_torch._arith import div
from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import DEFAULT_PLAN, ParallelPlan, apply_rope, dense_init, inv_sqrt
from repro_torch.models.sharding_ctx import P, local_shards

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def head_geometry(cfg: ModelConfig, plan: ParallelPlan) -> tuple[int, int]:
    """(padded q heads, stored kv heads) for this arch under this plan."""
    return plan.pad_heads(cfg.n_heads), plan.stored_kv_heads(cfg.n_kv_heads, cfg.n_heads)


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   plan: ParallelPlan = DEFAULT_PLAN,
                   dtype: torch.dtype = torch.float32) -> dict:
    """wq, wk, wv, wo drawn in that order from ``generator`` (on the CPU);
    zero biases when ``cfg.qkv_bias``."""
    hq, hkv = head_geometry(cfg, plan)
    d, dh = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(generator, d, hq * dh, dtype).reshape(d, hq, dh),
        "wk": dense_init(generator, d, hkv * dh, dtype).reshape(d, hkv, dh),
        "wv": dense_init(generator, d, hkv * dh, dtype).reshape(d, hkv, dh),
        "wo": dense_init(generator, hq * dh, d, dtype).reshape(hq, dh, d),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, dh), dtype=dtype)
        p["bk"] = torch.zeros((hkv, dh), dtype=dtype)
        p["bv"] = torch.zeros((hkv, dh), dtype=dtype)
    return p


def spec_attention(cfg: ModelConfig, plan: ParallelPlan) -> dict:
    w_in = plan.fsdp_axis if plan.fsdp else None
    s = {
        "wq": P(w_in, plan.tp_axis, None),
        "wk": P(w_in, plan.tp_axis, None),
        "wv": P(w_in, plan.tp_axis, None),
        "wo": P(plan.tp_axis, None, w_in),
    }
    if cfg.qkv_bias:
        s["bq"] = P(plan.tp_axis, None)
        s["bk"] = P(plan.tp_axis, None)
        s["bv"] = P(plan.tp_axis, None)
    return s


# ---------------------------------------------------------------------------
# Chunked attention (prefill)
# ---------------------------------------------------------------------------

def _flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                  window: int | None, q_offset: int = 0, chunk: int = 1024
                  ) -> torch.Tensor:
    """q (B, S, H, dh) post-RoPE; k, v (B, T, H, dh), already expanded to H.
    Keys run in chunks with an online-softmax accumulator; T padding, the
    causal and the window masks set scores to -1e30."""
    b, s, h, dh = q.shape
    t = k.shape[1]
    chunk = min(chunk, t)
    n_chunks = -(-t // chunk)
    tpad = n_chunks * chunk
    if tpad != t:
        pad = (0, 0, 0, 0, 0, tpad - t)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    dev = q.device
    q32 = q.to(torch.float32) * inv_sqrt(dh, dev)
    qpos = q_offset + torch.arange(s, device=dev)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, s, dh), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    for idx in range(n_chunks):
        kb = k[:, idx * chunk:(idx + 1) * chunk].to(torch.float32)
        vb = v[:, idx * chunk:(idx + 1) * chunk].to(torch.float32)
        kpos = idx * chunk + torch.arange(chunk, device=dev)
        sc = torch.einsum("bshd,bchd->bhsc", q32, kb)
        mask = (kpos[None, :] <= (t - 1)).expand(s, chunk)     # strip T padding
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        sc = torch.where(mask[None, None], sc, neg)
        m_new = torch.maximum(m, torch.amax(sc, dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhsc,bchd->bshd", p, vb).permute(0, 2, 1, 3)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)                # (B, S, H, dh)


def _expand_kv(kv: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """(B, T, Hkv, dh) -> (B, T, Hq, dh): q head i uses kv head i // g."""
    b, t, hkv, dh = kv.shape
    if hkv == n_q_heads:
        return kv
    assert n_q_heads % hkv == 0, (n_q_heads, hkv)
    g = n_q_heads // hkv
    return kv[:, :, :, None, :].expand(b, t, hkv, g, dh).reshape(b, t, n_q_heads, dh)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one ``aten.mm`` (``einsum`` makes
    it a ``bmm`` of batch 1): a weight product without batch dims, which
    ``remat_policy="dots"`` keeps as the reference's policy keeps it."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _unproject(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", o, w) as one ``aten.mm`` (see :func:`_project`)."""
    return o.flatten(-2) @ w.reshape(-1, w.shape[-1])


def _qkv(p: dict, x: torch.Tensor, src: torch.Tensor):
    q = _project(x, p["wq"])
    k = _project(src, p["wk"])
    v = _project(src, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def attention_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                      causal: bool = True, window: int | None = None,
                      kv_override: torch.Tensor | None = None, use_rope: bool = True
                      ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention: x (B, S, D), positions (S,) or (B, S);
    ``kv_override`` (B, T, D) for cross-attention. Returns (out (B, S, D),
    (k, v) for the cache)."""
    chunk = 10**9 if cfg.unroll_layers else 1024
    src = x if kv_override is None else kv_override
    q, k, v = _qkv(p, x, src)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        if kv_override is None:
            k = apply_rope(k, positions, cfg.rope_theta)
    hq = q.shape[2]
    # per (batch, head): DTensors sharded on those dims attend on their shards
    out = local_shards(lambda q_, k_, v_: _flash_attend(q_, k_, v_, causal=causal,
                                                        window=window, chunk=chunk),
                       (0, 2), q, _expand_kv(k, hq), _expand_kv(v, hq))
    out = _unproject(out, p["wo"])
    return out, (k, v)


# ---------------------------------------------------------------------------
# int8 KV cache: per-(position, head) symmetric quantisation
# ---------------------------------------------------------------------------

def quantize_kv(kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, H, dh) -> (int8 codes, (B, T, H) float32 scales)."""
    kv32 = kv.to(torch.float32)
    amax = torch.amax(torch.abs(kv32), dim=-1)
    scale = div(torch.clamp_min(amax, 1e-8), 127.0)
    codes = torch.clamp(torch.round(kv32 / scale[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def _dequant_operand(cache: torch.Tensor, scales: dict | None, which: str):
    """Matrix to contract against + per-(B, T, H) scale to fold in (or None).
    An int8 cache stays int8 here: :func:`_contract_cache` widens it."""
    if cache.dtype == torch.int8:
        return cache, scales[which]
    return cache, None


# positions per float32 block of the CPU contraction of a bf16 / int8 cache
CPU_CACHE_BLOCK = 512


def _contract_cache(spec: str, a: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
    """einsum(spec, a, cache) over a cache (B, T, Hkv, dh) in its storage
    dtype with float32 results, the reference's ``preferred_element_type``
    contraction. ``spec`` is ``"bngd,btnd->bngt"`` (scores, ``a`` the
    grouped queries) or ``"bngt,btnd->bngd"`` (``a`` the weights).

    A float32 cache contracts as it is. A bf16 cache, or an int8 one
    (whose codes bf16 holds exactly; the reference widens it to bf16 too),
    meets ``a`` rounded to bf16, with float32 sums; no float32 copy of the
    cache is made. The mechanism is chosen by device:

    * CUDA: one ``torch.bmm(..., out_dtype=torch.float32)`` per stored kv
      head on a strided view of the cache (cuBLAS reads the bf16 cache in
      place and accumulates in float32); an int8 cache is first widened to
      one bf16 copy, the operand the reference makes.
    * CPU (``bmm`` has no ``out_dtype`` there): the positions in blocks of
      ``CPU_CACHE_BLOCK``, each widened to float32 (bf16 products are exact
      in float32), so the float32 transient is one block.
    """
    from torch.distributed.tensor import DTensor

    if isinstance(cache, DTensor):
        return _contract_cache_shards(spec, a, cache)
    if cache.dtype == torch.float32:
        return torch.einsum(spec, a.to(torch.float32), cache)
    scores = spec == "bngd,btnd->bngt"
    a = a.to(torch.bfloat16)
    if cache.is_cuda:
        mat = cache.to(torch.bfloat16)
        outs = []
        for n in range(mat.shape[2]):
            m = mat[:, :, n, :]                                # (B, T, dh) strided
            outs.append(torch.bmm(a[:, n], m.transpose(1, 2) if scores else m,
                                  out_dtype=torch.float32))
        return torch.stack(outs, dim=1)
    a32 = a.to(torch.float32)
    parts = []
    for lo in range(0, cache.shape[1], CPU_CACHE_BLOCK):
        blk = cache[:, lo:lo + CPU_CACHE_BLOCK].to(torch.float32)
        parts.append(torch.einsum(spec, a32 if scores else a32[..., lo:lo + blk.shape[1]],
                                  blk))
    return torch.cat(parts, dim=-1) if scores else torch.stack(parts).sum(0)


def _contract_cache_shards(spec: str, a, cache):
    """:func:`_contract_cache` on a ``DTensor`` cache, on each rank's
    (batch, kv head) shard: the cache's ``Shard(0)`` / ``Shard(2)`` are
    ``a``'s and the result's ``Shard(0)`` / ``Shard(1)`` (the positions
    and head width are never sharded). torch 2.11's ``DTensor`` has no
    rule for ``bmm(..., out_dtype=)``."""
    from torch.distributed.tensor import DTensor, Shard

    mesh = cache.device_mesh
    assert all(not isinstance(p, Shard) or p.dim in (0, 2) for p in cache.placements), \
        cache.placements
    pl = tuple(Shard(1) if isinstance(p, Shard) and p.dim == 2 else p for p in cache.placements)
    b, t, n, dh = cache.shape
    shape = torch.Size((b, n, a.shape[2], t if spec == "bngd,btnd->bngt" else dh))
    a = a.redistribute(mesh, pl).to_local() if isinstance(a, DTensor) else a
    out = _contract_cache(spec, a, cache.to_local())
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
                in_place: bool = False) -> torch.Tensor:
    """The reference's ``dynamic_update_slice_in_dim(cache, new, slot, 1)``
    for one position: a device-side write (no host read of ``slot``), the
    start clamped into range as XLA clamps it. Out of place (a copy of the
    cache), or with ``in_place`` into ``cache`` itself: the same values."""
    from torch.distributed.tensor import DTensor

    t = cache.shape[1]
    idx = torch.clamp(slot, 0, t - 1).reshape(1).long()
    if isinstance(cache, DTensor):
        return _write_slot_shards(cache, new, idx, in_place)
    if in_place:
        return cache.index_copy_(1, idx, new.to(cache.dtype))
    return cache.index_copy(1, idx, new.to(cache.dtype))


def _write_slot_shards(cache, new, idx, in_place: bool):
    """:func:`_write_slot` on a ``DTensor`` cache: each rank writes its own
    shard (the position dim is never sharded), ``new`` laid out as the
    cache. torch 2.11's ``DTensor`` has no rule for ``index_copy``."""
    from torch.distributed.tensor import DTensor, Shard

    mesh, pl = cache.device_mesh, tuple(cache.placements)
    assert not any(isinstance(p, Shard) and p.dim == 1 for p in pl), pl
    if isinstance(new, DTensor):
        new = new.redistribute(mesh, pl).to_local()
    if isinstance(idx, DTensor):
        idx = idx.to_local()
    local = cache.to_local() if in_place else cache.to_local().clone()
    local.index_copy_(1, idx, new.to(local.dtype))
    if in_place:
        return cache
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=cache.shape,
                              stride=cache.stride())


def attention_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: torch.Tensor, cfg: ModelConfig, window: int | None = None,
                     use_rope: bool = True, cache_scales: dict | None = None):
    """One decode step: x (B, 1, D), caches (B, T, Hkv, dh), ``pos`` a 0-dim
    integer tensor (absolute position). Writes (k, v) at ``pos`` (mod T for
    a local window) into new caches, attends over the valid cache. Returns
    (out (B, 1, D), new_k, new_v, scales); the caches passed in are left
    as they were."""
    return _decode_into(p, x, cache_k, cache_v, pos, cfg, window, use_rope, cache_scales,
                       in_place=False)


def _decode_into(p: dict, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig, window: int | None = None,
                use_rope: bool = True, cache_scales: dict | None = None,
                in_place: bool = True):
    """:func:`attention_decode`, writing the new slot into ``cache_k``,
    ``cache_v`` (and the int8 scales) themselves when ``in_place``: the
    decode step's route, whose caches are its own copy (``lm._run_stacks``),
    so a step copies each cache once. The same numbers either way."""
    b = x.shape[0]
    t = cache_k.shape[1]
    q, k, v = _qkv(p, x, x)
    pos_b = pos[None].expand(b) if pos.dim() == 0 else pos
    if use_rope:
        q = apply_rope(q, pos_b[:, None], cfg.rope_theta)
        k = apply_rope(k, pos_b[:, None], cfg.rope_theta)

    slot = pos % t if window is not None else pos
    if cache_k.dtype == torch.int8:
        k8, ks = quantize_kv(k)
        v8, vs = quantize_kv(v)
        cache_scales = {"k": _write_slot(cache_scales["k"], ks, slot, in_place),
                        "v": _write_slot(cache_scales["v"], vs, slot, in_place)}
        k, v = k8, v8
    new_k = _write_slot(cache_k, k, slot, in_place)
    new_v = _write_slot(cache_v, v, slot, in_place)

    # grouped-query attention without expanding the cache: q heads as
    # (stored kv, group)
    hq = q.shape[2]
    hkv = new_k.shape[2]
    g = hq // hkv
    dh = q.shape[-1]
    qg = (q[:, 0] * inv_sqrt(dh, x.device).to(q.dtype)).reshape(b, hkv, g, dh)
    k_mat, k_scale = _dequant_operand(new_k, cache_scales, "k")
    sc = _contract_cache("bngd,btnd->bngt", qg, k_mat)
    if k_scale is not None:                      # int8 cache: fold scale in
        sc = sc * k_scale.permute(0, 2, 1)[:, :, None, :]

    tpos = torch.arange(t, device=x.device)
    if window is not None:
        # rolling buffer: valid = within the last `window` writes
        age = (slot - tpos) % t
        valid = age < torch.clamp_max(pos + 1, window)
    else:
        valid = tpos <= pos
    sc = torch.where(valid[None, None, None, :], sc,
                     torch.full((), NEG_INF, dtype=sc.dtype, device=sc.device))
    w = torch.softmax(sc, dim=-1)
    v_mat, v_scale = _dequant_operand(new_v, cache_scales, "v")
    if v_scale is not None:                      # fold v scale into weights
        w = w * v_scale.permute(0, 2, 1)[:, :, None, :]
    out = _contract_cache("bngt,btnd->bngd", w, v_mat)
    out = out.reshape(b, 1, hq, dh).to(x.dtype)
    out = _unproject(out, p["wo"])
    return out, new_k, new_v, cache_scales


def _cache_len(max_len: int, window: int | None) -> int:
    return min(window, max_len) if window is not None else max_len


def make_cache(cfg: ModelConfig, plan: ParallelPlan, batch: int, max_len: int,
               window: int | None = None, dtype: torch.dtype = torch.bfloat16,
               device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero (k, v) caches on ``device`` (the GPU by default)."""
    device = resolve_device(device)
    _, hkv = head_geometry(cfg, plan)
    shape = (batch, _cache_len(max_len, window), hkv, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def make_cache_scales(cfg: ModelConfig, plan: ParallelPlan, batch: int, max_len: int,
                      window: int | None = None, device=None) -> dict:
    """Unit int8-cache scales on ``device`` (the GPU by default)."""
    device = resolve_device(device)
    _, hkv = head_geometry(cfg, plan)
    z = torch.ones((batch, _cache_len(max_len, window), hkv), dtype=torch.float32,
                   device=device)
    return {"k": z, "v": z}
