"""RecurrentGemma recurrent block: conv1d + RG-LRU (arXiv:2402.19427).

Block: x -> { branch A: linear -> causal conv1d(4) -> RG-LRU,
              branch B: linear -> gelu } -> A*B -> out linear.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            # input gate
    a_t = exp(c * softplus(Λ) * (-r_t))     # a = σ(Λ)^(c·r); c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Prefill runs the linear recurrence as a log-depth associative scan with the
reference's combine tree; decode carries h as O(1) state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParallelPlan, dense_init, gelu
from repro_torch.models.sharding_ctx import P, split_shards, whole_along

_C = 8.0
CONV_K = 4


def init_rglru_block(generator: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype = torch.float32) -> dict:
    d = cfg.d_model
    w_x = dense_init(generator, d, d, dtype)
    w_gate = dense_init(generator, d, d, dtype)
    w_out = dense_init(generator, d, d, dtype)
    conv_w = (torch.randn((CONV_K, d), generator=generator) * 0.1).to(dtype)
    wa = dense_init(generator, d, d, dtype)
    wxg = dense_init(generator, d, d, dtype)
    # Λ init so a ∈ (0.9, 0.999) at r=1 (the paper's init range)
    lam = (2.0 + 4.0 * torch.rand((d,), generator=generator)).to(dtype)
    return {
        "w_x": w_x, "w_gate": w_gate, "w_out": w_out,
        "conv_w": conv_w, "conv_b": torch.zeros((d,), dtype=dtype),
        "wa": wa, "ba": torch.zeros((d,), dtype=dtype),
        "wxg": wxg, "bxg": torch.zeros((d,), dtype=dtype),
        "lam": lam,
    }


def spec_rglru_block(cfg: ModelConfig, plan: ParallelPlan) -> dict:
    w_in = plan.fsdp_axis if plan.fsdp else None
    tp = plan.tp_axis
    return {
        "w_x": P(w_in, tp), "w_gate": P(w_in, tp), "w_out": P(tp, w_in),
        "conv_w": P(None, tp), "conv_b": P(tp),
        "wa": P(w_in, tp), "ba": P(tp),
        "wxg": P(w_in, tp), "bxg": P(tp),
        "lam": P(tp),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, kernel CONV_K. x (B,S,D); state (B,K-1,D).
    ``torch.cat`` promotes a bf16 state to x's dtype, as the reference's
    concatenate does. The returned state is a copy of the last K-1
    positions: a view would keep the whole (B,S+K-1,D) concatenation alive
    in the layer's state."""
    if state is None:
        state = torch.zeros((x.shape[0], CONV_K - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, CONV_K):
        out = out + xp[:, i:i + s, :] * w[i]
    return out + b, xp[:, -(CONV_K - 1):, :].clone()


def _gates(p: dict, xc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """log(a_t) and the input branch sqrt(1 - a_t²) ⊙ i_t ⊙ x_t, both fp32.

    A ``DTensor`` ``xc`` comes sharded on its width over the model axis, as
    ``wa`` / ``wxg`` shard their output width: it is made whole along it
    first, so each gate product is column-sharded like its bias. Else
    ``DTensor`` may contract over the sharded width into a pending sum,
    and torch 2.11 then asks the bias, ``Shard(0)``, to become that
    ``Partial`` ("redistribute from S(0) to P(sum) not supported yet"; at
    recurrentgemma-2b's production widths, not at smoke size)."""
    x32 = whole_along(xc, -1).to(torch.float32)
    f32 = lambda n: p[n].to(torch.float32)  # noqa: E731
    r = torch.sigmoid(x32 @ f32("wa") + f32("ba"))
    i = torch.sigmoid(x32 @ f32("wxg") + f32("bxg"))
    log_a = -_C * F.softplus(f32("lam")) * r
    a2 = torch.exp(2.0 * log_a)
    gated_in = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-9)) * (i * x32)
    return log_a, gated_in


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 + a2, b1 * torch.exp(a2) + b2


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a at even and b at odd positions of dim 1 (len(a) - len(b) in {0, 1})."""
    shape = list(a.shape)
    shape[1] = a.shape[1] + b.shape[1]
    out = a.new_empty(shape)
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def associative_scan(elems):
    """Inclusive scan of ``_combine`` over dim 1 of the pair ``elems``, by
    the same odd / even recursion as ``jax.lax.associative_scan``, so each
    prefix is combined in the reference's order (2·log2 S levels)."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems], [e[:, 1::2] for e in elems])
    odd = associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, 0:1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _scan(log_a: torch.Tensor, gi: torch.Tensor, h0: torch.Tensor | None, dtype
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan of (log a, gated input) (B,S,D) from h0 (B,1,D) or zero:
    (h (B,S,D) in ``dtype``, a copy of h's last position (B,1,D) fp32)."""
    if h0 is not None:
        gi = gi.clone()
        gi[:, 0, :] = gi[:, 0, :] + h0[:, 0, :].to(torch.float32) * torch.exp(log_a[:, 0, :])
    _, h = associative_scan([log_a, gi])
    return h.to(dtype), h[:, -1:, :].clone()


def rglru_scan(p: dict, xc: torch.Tensor, h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Parallel linear-recurrence scan. xc (B,S,D) -> (h (B,S,D), h_last).

    The scan is elementwise along B and D, so on ``DTensor``s each rank
    scans its own (B/dp, S, D/tp) shard (``split_shards`` along D; the
    reference's layout), with no collective and no global-size tensor.
    ``h_last`` is a copy (B,D), not a view that would keep the whole scan
    alive in the layer's state."""
    log_a, gi = _gates(p, xc)                      # (B,S,D) fp32
    h, h_last = split_shards(lambda a, g, h_0: _scan(a, g, h_0, xc.dtype),
                             (log_a, gi, None if h0 is None else h0[:, None, :]),
                             (2, 2, 2), (2, 2))
    return h, h_last[:, 0, :]


def rglru_step(p: dict, xc: torch.Tensor, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step. xc (B,1,D), h (B,D) -> (out (B,1,D), h_new)."""
    log_a, gi = _gates(p, xc)
    h_new = torch.exp(log_a[:, 0, :]) * h.to(torch.float32) + gi[:, 0, :]
    return h_new[:, None, :].to(xc.dtype), h_new


def recurrent_block_forward(p: dict, x: torch.Tensor, state: dict | None = None
                            ) -> tuple[torch.Tensor, dict]:
    """Full block. state = {"h": (B,D) fp32, "conv": (B,K-1,D)} or None."""
    gate = gelu(x @ p["w_gate"])
    xb = x @ p["w_x"]
    conv_state = None if state is None else state["conv"]
    xc, conv_new = _causal_conv1d(xb, p["conv_w"], p["conv_b"], conv_state)
    if x.shape[1] == 1 and state is not None:
        h_seq, h_last = rglru_step(p, xc, state["h"])
    else:
        h0 = None if state is None else state["h"]
        h_seq, h_last = rglru_scan(p, xc, h0)
    out = (h_seq * gate) @ p["w_out"]
    return out, {"h": h_last, "conv": conv_new}


def init_rglru_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    """Zero recurrent and conv state on ``device`` (the GPU by default)."""
    device = resolve_device(device)
    d = cfg.d_model
    return {
        "h": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_K - 1, d), dtype=torch.bfloat16, device=device),
    }
