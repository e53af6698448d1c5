"""Sharding utilities: plan construction, spec fitting, placements, the
activation constrainer.

``fit_spec`` is the universal safety net: any spec axis whose size does
not divide its array dimension is dropped (that dim is replicated
instead), so small archs (9-head smollm, 6-head whisper) run on a 16-way
tensor axis with partial replication rather than failing; the head
padding of ``attention.head_geometry`` already handles the hot dims.

A fitted spec becomes ``DTensor`` placements on a ``DeviceMesh``: mesh
dim i gets ``Shard(d)`` when its axis name appears in entry d of the spec,
else ``Replicate()``. An entry naming several axes must list them in mesh
order (major first, as the reference's ``PartitionSpec`` splits them), the
order in which ``DTensor`` nests shards of one dim. A mesh dim of size 1
gets ``Replicate()``: a dim split over one device is that device's whole
dim, the same layout, and ``DTensor`` refuses to flatten a dim that is
``Shard()``ed even over one device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import tree_map
from repro_torch.models.layers import ParallelPlan
from repro_torch.models.sharding_ctx import (P, axis_names, axis_size, fit_spec,  # noqa: F401
                                             placements_for, relayout, set_constrainer,
                                             set_moe_ctx, spec_map)


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """Numeric policy per arch."""

    param_dtype: str = "float32"   # master weights
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    cache_dtype: str = "bfloat16"


def plan_for(cfg: ModelConfig, mesh) -> ParallelPlan:
    """The arch's plan on ``mesh`` (a ``DeviceMesh`` or a ``LocalMesh``):
    tp is the "model" axis; models of 10B+ parameters shard their params
    and optimiser state over the data axes (FSDP), over ("pod", "data") on
    a multi-pod mesh."""
    names = axis_names(mesh)
    tp = axis_size(mesh, "model") if "model" in names else 1
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    big = cfg.param_count() >= 10e9
    fsdp_axis = ("pod", "data") if "pod" in names else "data"
    return ParallelPlan(tp=tp, fsdp=big, dp_axes=dp_axes, fsdp_axis=fsdp_axis)


def train_plan_for(cfg: ModelConfig) -> TrainPlan:
    """100B+ MoE trains in bf16 params and bf16 moments."""
    if cfg.param_count() >= 100e9:
        return TrainPlan(param_dtype="bfloat16", moment_dtype="bfloat16")
    return TrainPlan()


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's layout: the mesh and the fitted spec; ``placements`` are
    its ``DTensor`` placements on that mesh."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def shardings_for(spec_tree, shape_tree, mesh):
    """Tree of :class:`Sharding` records, ``fit_spec`` applied leaf-wise
    (``shape_tree``'s leaves are anything with a ``shape``)."""
    return spec_map(lambda spec, shp: Sharding(mesh, fit_spec(spec, tuple(shp.shape), mesh)),
                    spec_tree, shape_tree)


def shard(x, sharding: Sharding):
    """``x`` laid out as ``sharding`` says: a plain tensor (the same on every
    rank) is distributed, a ``DTensor`` redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x, sharding.mesh, sharding.placements)


def shard_tree(tree, shardings):
    """:func:`shard` over a tree and its matching tree of shardings."""
    return tree_map(shard, tree, shardings)


# ---------------------------------------------------------------------------
# Activation constrainer (installed around a step by the launcher)
# ---------------------------------------------------------------------------

def dtensor_flattens_two_sharded_dims(mesh) -> bool:
    """Whether this torch's ``DTensor`` can view (B, S, ...) as (B·S, ...)
    with B and S sharded over two mesh axes, as every (B, S, D) @ (D, F)
    product does: torch 2.13 can (a strided shard); torch 2.11 raises
    ("Attempted to flatten multiple dimensions").

    Not on a ``mesh`` of more than two axes either: there B lies over ("pod",
    "data"), so B·S is sharded over three mesh dims, one of them strided,
    and torch 2.13 plans every candidate layout of each op on it through
    its graph-based redistribution planner (a search over the layouts of
    all three dims; a smoke step on (2, 2, 2) ran past 420 s)."""
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    return (major, minor) >= (2, 13) and len(axis_names(mesh)) <= 2


def make_constrainer(mesh, plan: ParallelPlan, seq_shard: bool = True):
    """Logical name -> ``DTensor.redistribute`` on this mesh.

    act:    (B, S, D)  B over dp, S over tp (sequence parallelism)
    act_saved: (B, S, D)  B over dp, S over tp, on every torch: a training
            step's activation between pattern repeats, which remat keeps
            for the backward (a layout nothing computes on)
    logits: (B, S, V)  V over tp
    moe_buf:(E, C, D)  E over tp, C over dp
    A plain tensor passes through unchanged. Where ``DTensor`` cannot
    flatten two sharded dims (torch before 2.13, or a multi-pod mesh:
    :func:`dtensor_flattens_two_sharded_dims`), S stays whole (no
    sequence parallelism) and so does C (the MoE flattens (E, C))."""
    from torch.distributed.tensor import DTensor

    two_sharded = dtensor_flattens_two_sharded_dims(mesh)
    seq_shard = seq_shard and two_sharded
    dp = plan.dp_axes
    tp = plan.tp_axis
    table = {
        "act": P(dp, tp if seq_shard else None, None),
        "act_saved": P(dp, tp, None),
        "logits": P(dp, None, tp),
        "tokens": P(dp, None),
        "moe_buf": P(tp, dp if two_sharded else None, None),
        "moe_tokens": P((*dp, tp) if seq_shard else dp, None),
        "kv": P(dp, None, tp, None),
    }

    def constrain(x, name):
        spec = table.get(name)
        if spec is None or not isinstance(x, DTensor):
            return x
        return x.redistribute(mesh, placements_for(fit_spec(spec, tuple(x.shape), mesh), mesh))

    return constrain


class constrainer_ctx:
    """Context manager installing the activation constrainer (and, with
    ``moe_a2a``, the all-to-all MoE dispatch) for the code it encloses."""

    def __init__(self, mesh, plan: ParallelPlan, seq_shard=True, moe_a2a: bool = False):
        self.fn = make_constrainer(mesh, plan, seq_shard) if mesh is not None else None
        self.moe = ({"mesh": mesh, "dp": plan.dp_axes, "tp": plan.tp_axis}
                    if (moe_a2a and mesh is not None) else None)

    def __enter__(self):
        set_constrainer(self.fn)
        if self.moe is not None:
            set_moe_ctx(self.moe)
        return self

    def __exit__(self, *a):
        set_constrainer(None)
        set_moe_ctx(None)
        return False
