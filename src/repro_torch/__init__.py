"""PyTorch + CUDA port of the IP2 reproduction (the closed saccade loop).

Mirrors the layout of the JAX package (``core/``, ``kernels/``,
``models/``, ``serve/``, ``data/``) so each module has an obvious
counterpart. The kernels on the serving path are hand-written CUDA C++ for
Hopper (``kernels/csrc``); every wrapper runs its plain PyTorch version on
CPU tensors and launches its kernel on CUDA tensors.

Entry points (``SaccadeEngine``, ``init_vit``, ``convert.params_from_numpy``)
default to the GPU and raise when there is none; pass ``device="cpu"`` to
run the plain versions.
"""

from repro_torch import _device  # noqa: F401  (sets the fp32 matmul policy)
