"""Roofline cost model on one NVIDIA H100 (SXM, dense peaks at 700 W).

Three terms per piece of work, in seconds:

    compute    = operations / the peak of their type
    memory     = bytes / HBM bandwidth
    collective = collective bytes / NVLink bandwidth (one direction)

The analytic costs (``megakernel_cost``, ``delta_attention_cost``,
``delta_backend_cost``, ``model_flops``) keep the reference's arithmetic,
defaults and ``detail`` keys: they price the block arguments they are
given (``block_r`` / ``block_m`` / ``block_k`` / ``block_q``), as the
reference prices its Pallas blocks. What changes is the card: each time is
taken at the peak of the unit the port runs the work on. Kernels 6, 2 and 1
and the fp32 matmuls of the backend and of training run on CUDA cores
(``_device.py`` pins TF32 off), kernels 5 and 4's embed on int8 tensor
cores.

``collective_bytes`` and ``cost_point`` read the dry run's record of one
step (``roofline.trace.Trace``: rank 0's local flops, bytes and collectives
from the step run on fake tensors) where the reference's read XLA's
partitioned HLO and cost analysis; they return the reference's dicts and
kind names. The reference's ``_line_result_bytes`` parses an HLO line and
has no counterpart: a trace holds each collective's result bytes.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense rates without sparsity, per card
HBM_BW = 3.35e12                 # bytes/s
PEAK_FLOPS_FP32 = 67e12          # FLOP/s, CUDA cores (no TF32)
PEAK_OPS_INT8 = 1979e12          # OP/s, tensor cores
PEAK_FLOPS_BF16 = 989e12         # FLOP/s, tensor cores
NVLINK_BW = 450e9                # bytes/s to the host's other cards, each way
HBM_BYTES = 80 * 1024**3         # capacity


@dataclasses.dataclass
class RooflineTerms:
    """Per-card costs and their roofline times. ``peak`` is the operation
    rate of the unit that does the work (fp32 CUDA cores by default)."""

    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    peak: float = PEAK_FLOPS_FP32

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.peak

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mxu_occupancy(self) -> float:
        """Share of the bound time the compute units do useful math
        (the reference's name): t_compute / t_bound, 1.0 when compute-bound."""
        t = self.t_bound
        return self.t_compute / t if t > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "mxu_occupancy": self.mxu_occupancy,
        }


def kernel_bound(n_bytes: float, fp32_flops: float = 0.0,
                 int8_ops: float = 0.0) -> tuple[float, str]:
    """The least time one kernel call could take, in seconds, and what
    bounds it (``"bytes"`` or ``"operations"``): the larger of its bytes
    (each input read once, each output written once) over HBM and its
    operations at their units' peaks (fp32 on CUDA cores plus int8 on
    tensor cores, one after the other)."""
    t_bytes = n_bytes / HBM_BW
    t_ops = fp32_flops / PEAK_FLOPS_FP32 + int8_ops / PEAK_OPS_INT8
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def extrapolate(point1: dict, point2: dict, n_rep1: int, n_rep2: int,
                n_rep_full: int) -> RooflineTerms:
    """Two-point linear extrapolation of per-card costs to full depth."""
    def extr(key):
        v1, v2 = point1[key], point2[key]
        slope = (v2 - v1) / max(n_rep2 - n_rep1, 1)
        return v1 + slope * (n_rep_full - n_rep1)

    return RooflineTerms(
        flops_per_chip=extr("flops"),
        bytes_per_chip=extr("bytes"),
        coll_bytes_per_chip=extr("coll_bytes"),
    )


def collective_bytes(trace) -> dict:
    """Per-device bytes moved by each collective kind (result-sized), the
    reference's dict: ``{kind: bytes, ..., "total": bytes, "counts":
    {kind: n}}``."""
    out: dict[str, int] = {}
    count: dict[str, int] = {}
    for kind, b in trace.collectives:
        out[kind] = out.get(kind, 0) + b
        count[kind] = count.get(kind, 0) + 1
    out["total"] = sum(out.values())
    out["counts"] = count
    return out


def cost_point(trace) -> dict:
    """One roofline point of a traced step: rank 0's flops, bytes and
    collective bytes, with the collectives by kind."""
    coll = collective_bytes(trace)
    return {
        "flops": float(trace.flops),
        "bytes": float(trace.bytes),
        "coll_bytes": float(coll["total"]),
        "coll_detail": {k: v for k, v in coll.items() if k != "total"},
    }


def megakernel_cost(
    row_counts,
    k: int,
    n2: int,
    m: int,
    d: int | None = None,
    block_r: int = 8,
    block_m: int = 128,
    block_k: int = 256,
    out_bytes: int = 1,
) -> dict:
    """Analytic (flops, bytes) of the ragged frontend projection at the
    per-slot ``row_counts``: a bank of ``block_r`` rows computes and
    streams only when its first row lies below its slot's count, so the
    cost scales with ``sum(ceil(count / block_r))`` active banks; every
    bank writes its output (zeros past the count). ``d`` adds the fused
    embed stage (codes @ W8); ``d=None`` is the projection alone with
    ``out_bytes`` per emitted element (1 for the int8 code wire)."""
    k_pad = -(-n2 // block_k) * block_k
    m_pad = -(-m // block_m) * block_m
    n_banks = -(-k // block_r)
    counts = [max(0, min(int(c), k)) for c in row_counts]
    active_banks = sum(-(-c // block_r) for c in counts)
    total_banks = len(counts) * n_banks

    flops = active_banks * 2.0 * block_r * k_pad * m_pad
    bytes_ = active_banks * block_r * k_pad * 4.0       # gathered patch rows
    bytes_ += active_banks * k_pad * m_pad * 4.0        # weight stream/bank
    if d is None:
        bytes_ += total_banks * block_r * m_pad * float(out_bytes)
    else:
        d_pad = -(-d // 128) * 128
        flops += active_banks * 2.0 * block_r * m_pad * d_pad
        bytes_ += m_pad * d_pad * 1.0 + d_pad * 4.0     # embed w8 + scales
        bytes_ += total_banks * block_r * d_pad * 4.0   # f32 embed output
    return {
        "flops": flops,
        "bytes": bytes_,
        "coll_bytes": 0.0,
        "detail": {"active_banks": active_banks, "total_banks": total_banks},
    }


def delta_attention_cost(
    j: int,
    k: int,
    d_model: int,
    n_heads: int,
    block_q: int = 8,
    lane: int = 128,
) -> dict:
    """Analytic (flops, bytes) of the ragged stale-query attention for one
    (slot, layer): ``j`` stale query rows against ``k`` cached keys. Only
    ``ceil(j / block_q)`` query banks compute and stream, each paying the
    full key and value block; the head dim is padded to ``lane``.
    ``time_s`` is the roofline bound at the fp32 peak (kernel 3 runs fp32
    on CUDA cores)."""
    dh = max(d_model // n_heads, 1)
    dh_p = -(-dh // lane) * lane
    k_pad = -(-k // block_q) * block_q
    active = -(-max(min(j, k), 0) // block_q)
    total = -(-k // block_q)

    # per active bank, per head: scores (bq x k_pad x dh_p) + mix back
    flops = active * n_heads * 2.0 * (2.0 * block_q * k_pad * dh_p)
    bytes_ = active * n_heads * block_q * dh_p * 4.0          # Q banks
    bytes_ += (n_heads * 2.0 * k_pad * dh_p * 4.0             # K + V
               * (1.0 if active > 0 else 0.0))
    bytes_ += k_pad * 4.0 * (1.0 if active > 0 else 0.0)      # key mask
    bytes_ += total * n_heads * block_q * dh_p * 4.0          # output banks
    t = RooflineTerms(flops, bytes_, 0.0)
    return {
        "flops": flops,
        "bytes": bytes_,
        "coll_bytes": 0.0,
        "time_s": t.t_bound,
        "detail": {"active_banks": active, "total_banks": total,
                   "bottleneck": t.bottleneck},
    }


def delta_backend_cost(
    j_embed: float,
    j_qkv,
    q_attn,
    k: int,
    m: int,
    d_model: int,
    n_heads: int,
    d_ff: int,
    n_classes: int,
    block_q: int = 8,
) -> dict:
    """Analytic per-frame cost of the delta-gated backend: embed, per layer
    QKV / attention / MLP, and head, at the stale populations the gate
    touched (``j_qkv`` / ``q_attn`` are per-layer sequences). FLOPs are
    2·MACs on the row terms; attention defers to
    :func:`delta_attention_cost` per layer. ``time_s`` prices every FLOP
    at the fp32 peak (the int8 embed term included, an over-estimate of
    its time)."""
    d = d_model
    flops = 2.0 * j_embed * m * d + 2.0 * float(n_classes * d)
    bytes_ = j_embed * (m * 1.0 + d * 4.0) + m * d * 1.0
    detail = {"layers": []}
    for j_l, q_l in zip(j_qkv, q_attn):
        attn = delta_attention_cost(
            int(q_l), k, d_model, n_heads, block_q=block_q)
        lf = 2.0 * (j_l * 3.0 * d * d + q_l * (d * d + 2.0 * d * d_ff))
        lb = (j_l + q_l) * d * 4.0 * 2.0 + (3.0 * d * d + 2.0 * d * d_ff) * 4.0
        flops += lf + attn["flops"]
        bytes_ += lb + attn["bytes"]
        detail["layers"].append({"row_flops": lf, "attn": attn["detail"]})
    t = RooflineTerms(flops, bytes_, 0.0)
    return {
        "flops": flops,
        "bytes": bytes_,
        "coll_bytes": 0.0,
        "time_s": t.t_bound,
        "detail": detail,
    }


def model_flops(n_active_params: int, tokens: int, is_train: bool) -> float:
    """MODEL_FLOPS = 6·N·D (train: forward and backward) or 2·N·D
    (inference forward)."""
    return (6.0 if is_train else 2.0) * n_active_params * tokens
