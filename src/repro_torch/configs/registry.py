"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig, applicable_shapes

_ARCH_MODULES = {
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    # the paper's own backend: patch-token transformer fed by the IP2 frontend
    "ip2-vit": "repro_torch.configs.ip2_vit",
}

ARCH_IDS = tuple(k for k in _ARCH_MODULES if k != "ip2-vit")


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in _ARCH_MODULES}


def arch_shape_cells(include_paper_arch: bool = False) -> list[tuple[str, str]]:
    """The assigned (arch x shape) grid — 40 baseline cells (+skips noted)."""
    cells = []
    ids = _ARCH_MODULES if include_paper_arch else ARCH_IDS
    for arch in ids:
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            cells.append((arch, shape))
    return cells


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: small widths/layers/experts/vocab so one
    forward/train step runs on CPU. Full configs are only dry-run lowered."""
    cfg = get_config(arch)
    pat = tuple(cfg.block_pattern)
    n_layers = min(cfg.n_layers, max(2, len(pat)))
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv, min(cfg.n_heads, 4))
    heads = (heads // kv) * kv  # keep GQA divisibility
    moe = None
    if cfg.moe is not None:
        # capacity_factor = n_experts makes the smoke dispatch dropless:
        # with an untrained (biased) router the real factor drops tokens,
        # and which tokens get dropped depends on batch composition — so
        # decode == forward only holds when capacity never binds.
        moe = MoEConfig(
            n_experts=4, top_k=2, d_expert=64,
            capacity_factor=4.0,
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
        )
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=128,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        moe=moe,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        n_encoder_frames=min(cfg.n_encoder_frames, 16),
        n_image_tokens=min(cfg.n_image_tokens, 8) if cfg.is_vlm else 0,
        ip2_patch=8,
        ip2_vectors=16,
        local_window=64,
        remat=False,
    )
