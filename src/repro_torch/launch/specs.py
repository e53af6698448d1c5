"""Shape-and-dtype stand-ins for every model input: ``device="meta"``
tensors (no allocation), the reference's ``ShapeDtypeStruct``s.

For VLM / audio archs the modality frontend is a stub: ``input_specs``
provides precomputed patch / frame embeddings. VLM train / prefill shapes
split seq_len into n_image_tokens of image prefix + text remainder;
enc-dec shapes use seq_len decoder tokens against n_encoder_frames stub
frames.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.sharding_ctx import P

VISION_STUB_DIM = 1024


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Training / prefill batch (full sequences)."""
    b, s = shape.global_batch, shape.seq_len
    out: dict = {}
    if cfg.is_vlm:
        n_img = min(cfg.n_image_tokens, s // 2)
        out["tokens"] = _meta((b, s - n_img), torch.int32)
        if cfg.vision_frontend == "ip2":
            edge = cfg.ip2_patch * int(n_img ** 0.5)
            out["images_rgb"] = _meta((b, edge, edge, 3), torch.float32)
        else:
            out["image_embeds"] = _meta((b, n_img, VISION_STUB_DIM), torch.bfloat16)
    elif cfg.is_encoder_decoder:
        out["tokens"] = _meta((b, s), torch.int32)
        out["frames"] = _meta((b, cfg.n_encoder_frames, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = _meta((b, s), torch.int32)
    return out


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Decode step inputs: one new token, absolute position scalar."""
    return {"tokens": _meta((shape.global_batch,), torch.int32),
            "pos": _meta((), torch.int32)}


def input_specs(arch: str, shape_name: str) -> dict:
    """The stand-ins for every model input of one (arch, shape) cell."""
    from repro_torch.configs import SHAPES, get_config

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape)
    return batch_specs(cfg, shape)


def batch_spec_shardings(cfg: ModelConfig, shape: ShapeConfig, plan) -> dict:
    """Partition-spec tree matching ``batch_specs`` (batch over dp axes)."""
    dp = plan.dp_axes
    out = {"tokens": P(dp, None)}
    if cfg.is_vlm:
        if cfg.vision_frontend == "ip2":
            out["images_rgb"] = P(dp, None, None, None)
        else:
            out["image_embeds"] = P(dp, None, None)
    elif cfg.is_encoder_decoder:
        out["frames"] = P(dp, None, None)
    return out
