"""ip2-vit — the paper's own backend: a patch-token transformer classifier
fed by the IP2 analog frontend (paper §1 "transformer-based backend model
for object classification and detection"). Used by the examples and the
accuracy benches; not part of the assigned 40-cell LM grid."""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="ip2-vit", family="vision",
    n_layers=6, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=1024, vocab=0, head_dim=64,
    block_pattern=(ATTN,), mlp_kind="gelu", qkv_bias=True,
    is_vlm=True, n_image_tokens=64, vision_frontend="ip2",
    ip2_patch=32, ip2_vectors=192,
)
