"""whisper-tiny — enc-dec; conv/audio frontend is a STUB per assignment
(input_specs provide precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, head_dim=64,
    block_pattern=(ATTN,), mlp_kind="gelu", qkv_bias=True,
    is_encoder_decoder=True, n_encoder_layers=4, n_encoder_frames=1500,
)
