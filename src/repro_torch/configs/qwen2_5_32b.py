"""qwen2.5-32b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-*]."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab=152064, head_dim=128,
    block_pattern=(ATTN,), mlp_kind="swiglu", qkv_bias=True,
    rope_theta=1_000_000.0,
)
