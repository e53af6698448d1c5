"""Fig. 4: analog self-attention with power-of-2 quantised coefficients.

The paper's extension maps each attention coefficient through a
quantiser-thresholder (QTH) onto a power of two, so the value multiply is a
capacitor-ratio shift in a binary-weighted cap bank. Digital twin: softmax
probabilities -> ``2^round(log2 p)``, dropped below ``2^min_exp``,
optionally renormalised so rows sum to 1. The straight-through estimator is
written as the reference writes it, ``p + (q - p).detach()``, whose forward
value can differ from ``q`` by an ulp.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._arith import clip

NEG_INF = -1e30   # finite: an all-masked row softmaxes to uniform, not NaN


@dataclasses.dataclass(frozen=True)
class QTHSpec:
    min_exp: int = -8        # coefficients below 2^min_exp are dropped (threshold)
    renormalize: bool = True
    ste: bool = True


def pow2_quantize(p: torch.Tensor, spec: QTHSpec = QTHSpec()) -> torch.Tensor:
    """Probabilities in [0, 1] -> the nearest power of two (rounding the
    exponent half to even), 0 below ``2^min_exp``, at most 1."""
    eps = 2.0 ** spec.min_exp
    safe = torch.clamp_min(p, eps * 0.5)
    expo = torch.round(torch.log2(safe))
    q = torch.where(p < eps, torch.zeros((), dtype=p.dtype, device=p.device),
                    torch.exp2(expo))
    q = torch.clamp_max(q, 1.0)
    if spec.ste:
        q = p + (q - p).detach()
    return q


def qth_attention_weights(scores: torch.Tensor, spec: QTHSpec = QTHSpec(),
                          key_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax -> pow-2 quantisation -> optional renormalisation.
    ``scores`` (..., q, k) are pre-softmax logits; ``key_valid`` (..., k)
    excludes keys, whose coefficient is then exactly 0."""
    if key_valid is not None:
        scores = torch.where(key_valid[..., None, :], scores,
                             torch.full((), NEG_INF, dtype=scores.dtype,
                                        device=scores.device))
    p = torch.softmax(scores, dim=-1)
    q = pow2_quantize(p, spec)
    if spec.renormalize:
        denom = torch.sum(q, dim=-1, keepdim=True)
        q = q / clip(denom, 2.0 ** spec.min_exp)
    return q


def qth_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  spec: QTHSpec = QTHSpec(),
                  key_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled dot-product attention over (..., s, d) tensors with QTH
    coefficients."""
    d = q.shape[-1]
    scores = torch.einsum("...qd,...kd->...qk", q, k) / torch.sqrt(
        torch.full((), d, dtype=q.dtype, device=q.device))
    w = qth_attention_weights(scores, spec, key_valid=key_valid).to(v.dtype)
    return torch.einsum("...qk,...kd->...qd", w, v)
