"""Int8 error-feedback gradient compression: each replica quantises its
gradient to int8 with a shared per-tensor scale and keeps the residual in
a local buffer that is added back next step (error-feedback SGD).

The all-reduce that sums the codes across replicas (the reference's
``compressed_psum_tree`` / ``make_compressed_allreduce``, a ``shard_map``)
waits for the port's ``torch.distributed`` layer."""

from __future__ import annotations

import torch

from repro_torch._arith import clip, div
from repro_torch.convert import tree_map


def quantize_ef(g: torch.Tensor, err: torch.Tensor,
                scale: torch.Tensor | float) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, new error buffer) for a given (shared) scale."""
    corrected = g.to(torch.float32) + err
    q = corrected / scale if isinstance(scale, torch.Tensor) else div(corrected, scale)
    codes = clip(torch.round(q), -127.0, 127.0).to(torch.int8)
    new_err = corrected - codes.to(torch.float32) * scale
    return codes, new_err


def init_error_buffers(params):
    """A float32 zero buffer per parameter, on its device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
