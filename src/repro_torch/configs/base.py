"""Config system: model architecture, input shapes, parallelism plan.

Every assigned architecture is a ``ModelConfig`` built in its own
``configs/<id>.py`` module and registered in ``configs.registry``. The
shape set (train_4k / prefill_32k / decode_32k / long_500k) is global to
the LM family; per-arch applicability (decode/long skips) is computed from
the architecture's attention class.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

# ---------------------------------------------------------------------------
# Block kinds
# ---------------------------------------------------------------------------

ATTN = "attn"            # global causal self-attention (dense transformer)
LOCAL_ATTN = "local"     # sliding-window attention
RECURRENT = "rglru"      # RecurrentGemma RG-LRU recurrent block
MLSTM = "mlstm"          # xLSTM matrix-LSTM block
SLSTM = "slstm"          # xLSTM scalar-LSTM block
MOE = "moe"              # attention + MoE FFN
ENCDEC = "encdec"        # whisper-style encoder-decoder (handled by model kind)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    n_shared_experts: int = 0     # dense experts always active (kimi-style)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None   # default d_model // n_heads
    block_pattern: Sequence[str] = (ATTN,)   # tiled over n_layers
    mlp_kind: str = "swiglu"      # swiglu | geglu | gelu | none
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    local_window: int = 2048      # for LOCAL_ATTN blocks
    logit_softcap: float | None = None
    # enc-dec (audio): encoder frames are precomputed stubs per assignment
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_encoder_frames: int = 1500
    # vlm: image tokens prepended to text (stub or IP2 frontend)
    is_vlm: bool = False
    n_image_tokens: int = 0
    vision_frontend: str = "stub"   # stub | ip2
    ip2_patch: int = 32             # Bayer patch edge for the IP2 frontend
    ip2_vectors: int = 400          # M vectors/patch off the analog array
    # xlstm
    xlstm_proj_factor: float = 2.0
    xlstm_chunk: int = 0          # >0: chunkwise-parallel mLSTM (§Perf X1)
    # training
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots  (saveable residuals)
    # roofline instrumentation: run the layer stack as a python loop instead
    # of lax.scan so XLA cost_analysis counts every layer (see launch/dryrun)
    unroll_layers: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # -- derived -----------------------------------------------------------

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        pat = tuple(self.block_pattern)
        reps = math.ceil(self.n_layers / len(pat))
        return (pat * reps)[: self.n_layers]

    @property
    def is_subquadratic(self) -> bool:
        """True if no layer uses global attention (long_500k eligible)."""
        return all(k != ATTN and k != MOE for k in self.layer_kinds) or self.family in (
            "hybrid",
            "ssm",
        )

    @property
    def d_inner_xlstm(self) -> int:
        return int(self.d_model * self.xlstm_proj_factor)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d                      # embed
        if not self.tie_embeddings:
            total += self.vocab * d                 # lm_head
        for kind in self.layer_kinds:
            total += 2 * d                          # norms
            if kind in (ATTN, LOCAL_ATTN, MOE):
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
            elif kind == RECURRENT:
                dr = d  # recurrent width = d_model
                total += 2 * d * dr + dr * d        # in (x,gate) + out proj
                total += 4 * dr + dr * 4            # conv1d(4) + RG-LRU gates
                total += 2 * dr * dr // 8           # block-diag gate proj (8 blocks)
            elif kind == MLSTM:
                di = self.d_inner_xlstm
                total += 2 * d * di + di * d        # up (x2) + down
                total += 3 * di * di // 4           # qkv block-diag (4 blocks)
                total += 3 * di                     # i,f,o gate projections
            elif kind == SLSTM:
                di = self.d_model
                total += 4 * d * di + 4 * di * di // 4 + di * d
            if kind == MOE:
                m = self.moe
                total += d * m.n_experts            # router
                total += m.n_experts * 3 * d * m.d_expert
                total += m.n_shared_experts * 3 * d * m.d_expert
            elif kind in (ATTN, LOCAL_ATTN):
                if self.mlp_kind == "swiglu" or self.mlp_kind == "geglu":
                    total += 3 * d * self.d_ff
                elif self.mlp_kind == "gelu":
                    total += 2 * d * self.d_ff
        if self.is_encoder_decoder:
            # encoder layers: attn + gelu mlp; decoder cross-attn already not
            # counted above -> add cross attn per decoder layer
            for _ in range(self.n_encoder_layers):
                total += 4 * (self.d_model * self.n_heads * self.head_dim)
                total += 2 * self.d_model * self.d_ff + 2 * self.d_model
            total += self.n_layers * 4 * (self.d_model * self.n_heads * self.head_dim)
        if self.is_vlm:
            total += self.ip2_vectors * self.d_model  # vision adapter
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only);
        MODEL_FLOPS = 6 · N_active · D."""
        total = self.param_count()
        if self.moe is None:
            return total
        m = self.moe
        expert_p = 3 * self.d_model * m.d_expert
        n_moe_layers = sum(1 for k in self.layer_kinds if k == "moe")
        total -= n_moe_layers * m.n_experts * expert_p
        total += n_moe_layers * m.top_k * expert_p
        return int(total)

    moe: MoEConfig | None = None


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Shape cells for this arch. long_500k only for sub-quadratic archs
    (skips recorded in DESIGN.md §Arch-applicability)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic:
        names.append("long_500k")
    return names
