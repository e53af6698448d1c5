"""Plain PyTorch versions of the CUDA kernels (same function, same
arithmetic order as the kernels, unpadded shapes).

The ops wrappers take these for CPU tensors; on the card they are what
``chip_smoke.py`` holds each kernel against.
"""

from __future__ import annotations

import torch

from repro_torch._arith import div
from repro_torch.core import adc as adc_mod


def ip2_project_ref(patches: torch.Tensor, w_q: torch.Tensor,
                    bias: torch.Tensor, params) -> torch.Tensor:
    """ip2_project: (R, K) pixels, (K, M) DAC-grid weights, (M,) bias ->
    (R, M) int8 codes / int8 sign bits / float32 readout, per ``params``
    (an ``ops.IP2KernelParams``). PWM multiplies by 1/n and the epilogue is
    ``acc·(droop/n2) + V_R``: the kernel's order, not the frontend's."""
    n = params.pwm_levels - 1
    xq = torch.round(torch.clamp(patches, 0.0, 1.0) * n) * (1.0 / n)
    acc = xq.to(torch.float32) @ w_q.to(torch.float32)
    out = acc * (params.droop / params.n2) + params.v_ref
    if params.nl_kind == "relu":
        out = torch.clamp(out, 0.0, params.v_sat)
    if params.readout == "sign":
        return adc_mod.sign_encode(out, params.v_ref).to(torch.int8)
    if not params.adc_enable:
        return out - (params.v_ref - bias[None, :])
    spec = params.adc_spec()
    if params.adc_out_codes:
        return adc_mod.encode(out, spec)
    return adc_mod.digital_readout(out, params.v_ref, bias[None, :], spec)


def ip2_conv_ref(frame: torch.Tensor, w_q: torch.Tensor, bias: torch.Tensor,
                 conv, params) -> torch.Tensor:
    """ops.ip2_conv's oracle: explicit Python-loop slicing of the strided
    K×K windows (independent of ``projection.extract_windows``), then
    :func:`ip2_project_ref`; (..., gh·gw, C) in row-major window order.
    ``conv`` is a ``ConvSpec`` (geometry only), ``w_q`` (K², C) on the DAC
    grid."""
    k, s = conv.kernel, conv.stride
    frames = frame if frame.ndim == 3 else frame[None]
    b, h, w = frames.shape
    gh = (h - k) // s + 1
    gw = (w - k) // s + 1
    wins = [frames[:, i * s:i * s + k, j * s:j * s + k].reshape(b, k * k)
            for i in range(gh) for j in range(gw)]
    windows = torch.stack(wins, dim=1)                    # (b, gh*gw, K²)
    out = ip2_project_ref(windows.reshape(-1, k * k), w_q, bias, params)
    out = out.reshape(b, gh * gw, -1)
    return out if frame.ndim == 3 else out[0]


def _zero_past_counts(out: torch.Tensor, counts: torch.Tensor, k: int) -> torch.Tensor:
    """(S·k, ...) rows at positions >= their slot's count set to 0."""
    live = (torch.arange(k, device=out.device)[None, :] < counts[:, None]).reshape(-1)
    live = live.reshape(live.shape + (1,) * (out.dim() - 1))
    return torch.where(live, out, torch.zeros((), dtype=out.dtype, device=out.device))


def ip2_project_sparse_ref(table: torch.Tensor, counts, patches: torch.Tensor,
                           w_q: torch.Tensor, bias: torch.Tensor, params,
                           k: int) -> torch.Tensor:
    """ip2_project_sparse / ip2_ragged: ``ip2_project_ref`` of the ``table``
    rows of the dense (rows, K) patch grid, (R, M); with ``counts`` (S,)
    over slots of ``k`` rows, rows at or past their slot's count are 0."""
    out = ip2_project_ref(patches[table.long()], w_q, bias, params)
    return out if counts is None else _zero_past_counts(out, counts, k)


def delta_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: torch.Tensor, q_counts: torch.Tensor) -> torch.Tensor:
    """delta_attention: (B, S, H, dh) q, k, v -> (B, S, H, dh) attention
    output of the query rows below ``q_counts``, zeros past them; the dense
    arithmetic of the encoder (scores / sqrt(dh), -1e30 on invalid keys,
    softmax, · V)."""
    dh = q.shape[-1]
    sc = torch.einsum("bqhk,bshk->bhqs", q, k) / torch.sqrt(
        torch.full((), dh, dtype=q.dtype, device=q.device))
    sc = torch.where(key_mask[:, None, None, :], sc,
                     torch.full((), -1e30, dtype=sc.dtype, device=sc.device))
    o = torch.einsum("bhqs,bshk->bqhk", torch.softmax(sc, dim=-1), v)
    rows = torch.arange(q.shape[1], device=q.device)[None, :, None, None]
    return torch.where(rows < q_counts[:, None, None, None], o,
                       torch.zeros((), dtype=o.dtype, device=o.device))


def quant_matmul_ref(a8: torch.Tensor, s_a: torch.Tensor, w8: torch.Tensor,
                     s_w: torch.Tensor) -> torch.Tensor:
    """(R, K) int codes @ (K, N) int8 -> (float(acc) * s_a[r]) * s_w[c],
    float32, where ``acc`` is the reference's int32 sum, which wraps modulo
    2^32 (int8 codes, or the int16 / int32 codes of a wider ADC).

    The sum is taken exactly and then wrapped: CUDA has no int32 matmul, so
    the codes are split into byte planes (the top one signed, the others
    unsigned), each plane's products are summed in float64 (every partial
    sum, at most K·255·128, is an exact float64 integer), and the planes are
    shifted and added in int64 modulo 2^32 before the wrap to int32."""
    a = a8.to(torch.int64)
    wf = w8.to(torch.float64)
    n_planes = a8.element_size()
    acc = torch.zeros((a8.shape[0], w8.shape[1]), dtype=torch.int64, device=a8.device)
    for p in range(n_planes):
        plane = a >> (8 * p)
        if p < n_planes - 1:
            plane = plane & 0xFF
        part = (plane.to(torch.float64) @ wf).to(torch.int64)
        acc = (acc + part * (1 << (8 * p))) & 0xFFFFFFFF
    acc = acc - ((acc >> 31) << 32)            # two's complement int32 value
    return acc.to(torch.float32) * s_a[:, None] * s_w[None, :]


def quantize_activations_ref(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 activation quantisation: (..., K) float ->
    ((..., K) int8 codes, (...,) float32 scales ``max|a| / 127``)."""
    amax = torch.amax(torch.abs(a), dim=-1)
    scale = div(torch.clamp_min(amax, 1e-12), 127.0)
    a8 = torch.clamp(torch.round(a / scale[..., None]), -127, 127).to(torch.int8)
    return a8, scale.to(torch.float32)


def ip2_fused_embed_ref(table: torch.Tensor, counts: torch.Tensor,
                        patches: torch.Tensor, w_q: torch.Tensor,
                        w8: torch.Tensor, s_w: torch.Tensor, params,
                        k: int) -> torch.Tensor:
    """ip2_fused_embed as the staged composition: gather the ``table`` rows
    of the dense (rows, K) patch grid, project to ADC codes (bias 0), then
    the w8a8 embed with the ADC LSB as activation scale; (S·k, D) with rows
    at or past their slot's count set to 0."""
    bias = torch.zeros(w_q.shape[1], dtype=torch.float32, device=w_q.device)
    codes = ip2_project_ref(patches[table.long()], w_q, bias, params)
    lsb = torch.full((codes.shape[0],), params.adc_spec().lsb,
                     dtype=torch.float32, device=codes.device)
    return _zero_past_counts(quant_matmul_ref(codes, lsb, w8, s_w.to(torch.float32)),
                             counts, k)
