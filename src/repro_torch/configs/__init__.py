from repro_torch.configs.base import (
    ATTN,
    LOCAL_ATTN,
    MLSTM,
    MOE,
    RECURRENT,
    SHAPES,
    SLSTM,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    applicable_shapes,
)
from repro_torch.configs.registry import (
    ARCH_IDS,
    all_configs,
    arch_shape_cells,
    get_config,
    smoke_config,
)

__all__ = [
    "ATTN", "LOCAL_ATTN", "MLSTM", "MOE", "RECURRENT", "SLSTM", "SHAPES",
    "ModelConfig", "MoEConfig", "ShapeConfig", "applicable_shapes",
    "ARCH_IDS", "all_configs", "arch_shape_cells", "get_config", "smoke_config",
]
