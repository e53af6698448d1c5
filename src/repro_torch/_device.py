"""Device resolution and the float32 policy shared by the whole port."""

from __future__ import annotations

import torch

# The reference computes every float32 matmul in full float32. PyTorch's
# cuBLAS path already defaults to that, but cuDNN defaults to TF32, which
# keeps ~10 mantissa bits and would move ADC codes: pin both explicitly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: the port runs on the card unless the caller
    asks for the CPU explicitly. Raises when CUDA is requested but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions")
    return dev
