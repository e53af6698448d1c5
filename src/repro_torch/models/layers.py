"""Shared layers: the parallel plan (head bookkeeping and partition
specs), dense and embed init, RMS and layer norms, rotary embeddings, the
MLPs. Parameters are plain dicts of tensors in the reference's layouts;
each ``spec_*`` builds the matching tree of partition specs, which the
launcher (``repro_torch.launch``) turns into ``DTensor`` placements."""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch._arith import div
from repro_torch.models.sharding_ctx import P


# ---------------------------------------------------------------------------
# Parallelism plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """How one arch maps onto a mesh; tp = size of the tensor axis."""

    tp: int = 1
    fsdp: bool = False                   # ZeRO-3 param shard over the data axis
    tp_axis: str = "model"
    fsdp_axis: str | tuple = "data"
    dp_axes: tuple[str, ...] = ("data",)

    def pad_heads(self, n_heads: int) -> int:
        """Q heads padded up to a multiple of the tensor axis."""
        return int(math.ceil(n_heads / self.tp) * self.tp)

    def stored_kv_heads(self, n_kv: int, n_heads: int) -> int:
        """KV heads physically stored: lcm(n_kv, tp) when it divides the
        padded Q heads, else one copy per padded Q head."""
        padded_q = self.pad_heads(n_heads)
        stored = math.lcm(n_kv, self.tp)
        if padded_q % stored != 0:
            stored = padded_q
        return stored

    # -- common specs --------------------------------------------------------

    @property
    def _w_in(self) -> str | tuple | None:
        return self.fsdp_axis if self.fsdp else None

    def spec_embed(self) -> P:          # (V, D)
        return P(self.tp_axis, self._w_in)

    def spec_proj_out_tp(self) -> P:    # (D, inner): inner sharded on tp
        return P(self._w_in, self.tp_axis)

    def spec_proj_in_tp(self) -> P:     # (inner, D): inner sharded on tp
        return P(self.tp_axis, self._w_in)

    def spec_bias_tp(self) -> P:
        return P(self.tp_axis)

    def spec_replicated(self) -> P:
        return P()

    def spec_activations(self) -> P:    # (B, S, D)
        return P(self.dp_axes, None, None)

    def spec_tokens(self) -> P:         # (B, S)
        return P(self.dp_axes, None)


DEFAULT_PLAN = ParallelPlan()


# ---------------------------------------------------------------------------
# Initializers (drawn on the CPU from a torch.Generator)
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(d_in, d_out) normal / sqrt(d_in)."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32) * scale
    return w.to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=generator, dtype=torch.float32) * 0.02).to(dtype)


def inv_sqrt(n: int, device=None) -> torch.Tensor:
    """float32 1 / sqrt(n) as the reference rounds it, a 0-dim tensor."""
    return 1.0 / torch.sqrt(torch.full((), n, dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * gamma.to(torch.float32)).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * gamma + beta).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split layout)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    expo = div(torch.arange(0, half, dtype=torch.float32, device=device), float(half))
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=device), expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, dh), positions: (B, S) or (S,) integers."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (dh/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs    # (B, S, dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, d: int, d_ff: int, kind: str,
             dtype: torch.dtype = torch.float32) -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(generator, d, d_ff, dtype),
            "w_up": dense_init(generator, d, d_ff, dtype),
            "w_down": dense_init(generator, d_ff, d, dtype),
        }
    if kind == "gelu":
        return {
            "w_up": dense_init(generator, d, d_ff, dtype),
            "b_up": torch.zeros((d_ff,), dtype=dtype),
            "w_down": dense_init(generator, d_ff, d, dtype),
            "b_down": torch.zeros((d,), dtype=dtype),
        }
    raise ValueError(kind)


def spec_mlp(kind: str, plan: ParallelPlan) -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": plan.spec_proj_out_tp(),
            "w_up": plan.spec_proj_out_tp(),
            "w_down": plan.spec_proj_in_tp(),
        }
    return {
        "w_up": plan.spec_proj_out_tp(),
        "b_up": plan.spec_bias_tp(),
        "w_down": plan.spec_proj_in_tp(),
        "b_down": plan.spec_replicated(),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if kind == "geglu":
        return (gelu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if kind == "gelu":
        return gelu(x @ p["w_up"] + p["b_up"]) @ p["w_down"] + p["b_down"]
    raise ValueError(kind)
