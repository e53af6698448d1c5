"""xlstm-1.3b — mLSTM + sLSTM blocks (7:1), no FFN (d_ff=0)
[arXiv:2405.04517]. Sub-quadratic -> runs long_500k."""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=None,
    block_pattern=(MLSTM,) * 7 + (SLSTM,),
    mlp_kind="none", xlstm_proj_factor=2.0,
)
