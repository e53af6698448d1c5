"""Meshes (functions: importing this module touches no device state).

Two kinds, kept apart:

* a ``torch.distributed.device_mesh.DeviceMesh`` — one process (rank) per
  device, the ``torchrun`` idiom — for everything the reference computes
  with collectives (the sharded train step, the pipeline, the all-to-all
  MoE, the compressed all-reduce, elastic restore). Single pod: mesh
  (16, 16) = ("data", "model"); multi-pod: (2, 16, 16) = ("pod", "data",
  "model"), "pod" the slow axis. An H100 node's NVLink domain is 8 cards,
  so the 16-way "model" axis of the production mesh spans two nodes.
* a :class:`LocalMesh` — one process driving a list of its own devices
  along named axes, with no collective — for the engine's slot sharding and
  the fleet's per-host meshes (the reference's per-slot ``shard_map`` with
  replicated params, and its one-process-per-host stand-in).

Both answer ``axis_names`` and :func:`axis_size`, so ``fit_spec`` and
``plan_for`` take either. The card's rates for the roofline are the H100's
of ``roofline.analysis``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.sharding_ctx import axis_names, axis_size
from repro_torch.roofline.analysis import HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS_BF16

__all__ = ["HBM_BW", "HBM_BYTES", "NVLINK_BW", "PEAK_FLOPS_BF16", "PRODUCTION_MESHES",
           "LocalMesh", "axis_names", "axis_size", "make_host_mesh", "make_production_mesh",
           "production_ranks"]


class LocalMesh:
    """``devices`` of this process, every one on the first of
    ``axis_names`` (the others of size 1). ``[torch.device("cpu")] * 4``
    gives four CPU shards; ``[cuda:0] * 4`` four shards on one card."""

    def __init__(self, devices, axis_names=("data",)):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = (len(self.devices),) + (1,) * (len(self.axis_names) - 1)

    def __repr__(self):
        return (f"LocalMesh({dict(zip(self.axis_names, self.shape))}, "
                f"devices={[str(d) for d in self.devices]})")


def _device_mesh(shape, axes, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device_type='cpu' "
                           "for a mesh of CPU (gloo) ranks")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


# multi_pod -> (shape, axis names) of the production mesh
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def production_ranks(*, multi_pod: bool = False) -> int:
    """Ranks (one a device) of the production mesh."""
    return math.prod(PRODUCTION_MESHES[multi_pod][0])


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) with "pod" in front: one
    rank per device, so the process group must hold 256 / 512 ranks."""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    return _device_mesh(shape, axes, device_type)


def make_host_mesh(data: int = 2, model: int = 2, *, device_type: str = "cuda"):
    """A (data, model) ``DeviceMesh`` over this job's ranks (world size
    ``data * model``); ``device_type="cpu"`` for gloo ranks on the CPU."""
    return _device_mesh((data, model), ("data", "model"), device_type)
