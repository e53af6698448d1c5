"""The port's models: the LM stack (``lm``, ``blocks``, ``attention``,
``moe``, ``rglru``, ``xlstm``) and the ViT backend of the saccade loop."""

from repro_torch.models.layers import DEFAULT_PLAN, ParallelPlan
from repro_torch.models.lm import (
    decode_state_specs,
    decode_step,
    forward,
    init_decode_state,
    init_params,
    loss_fn,
    param_specs,
    prefill,
)

__all__ = [
    "DEFAULT_PLAN", "ParallelPlan",
    "decode_state_specs", "decode_step", "forward", "init_decode_state", "init_params",
    "loss_fn", "param_specs", "prefill",
]
