"""pixtral-12b — pixtral-ViT frontend (stub per assignment) + mistral-nemo
backbone [hf:mistralai/Pixtral-12B-2409].

This is the paper-representative architecture: with
``vision_frontend="ip2"`` the patch embeddings are produced by the IP2
analog in-pixel projection (PWM 6-bit, charge-share, 25% salient patches)
instead of the precomputed ViT stub.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128,
    block_pattern=(ATTN,), mlp_kind="swiglu", rope_theta=1_000_000.0,
    is_vlm=True, n_image_tokens=1024, vision_frontend="stub",
    ip2_patch=32, ip2_vectors=400,
)
