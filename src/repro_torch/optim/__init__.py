"""AdamW, its learning-rate schedule and int8 error-feedback compression
(PyTorch port of ``repro.optim``)."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm, init_opt_state,
                                    opt_state_specs)
from repro_torch.optim.schedule import cosine_with_warmup

__all__ = [
    "AdamWConfig", "adamw_update", "global_norm", "init_opt_state", "opt_state_specs",
    "cosine_with_warmup",
]
