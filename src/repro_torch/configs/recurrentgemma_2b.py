"""recurrentgemma-2b — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427]. Sub-quadratic -> runs long_500k."""
from repro_torch.configs.base import LOCAL_ATTN, RECURRENT, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000, head_dim=256,
    block_pattern=(RECURRENT, RECURRENT, LOCAL_ATTN),
    mlp_kind="geglu", local_window=2048, logit_softcap=30.0,
)
