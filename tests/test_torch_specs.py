"""The port's partition specs, spec fitting, plans and input stand-ins
against the reference's, with no process group.

Every spec tree (``param_specs``, ``decode_state_specs`` for float32 /
bf16 / int8 caches, ``opt_state_specs``, each block's ``spec_*`` and
``state_specs``, the plan's own ``spec_*``) is compared as a tree of
tuples: ``tuple(P(...))`` of the port equals ``tuple(PartitionSpec(...))``
of the reference. ``fit_spec`` and ``plan_for`` take the reference a
stand-in with the mesh's axis names and device-grid shape (all they read)
and the port a ``LocalMesh`` of CPU entries of that shape.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as jcfgs
import repro.launch.shardings as jsh
import repro.launch.specs as jspecs
import repro.models.blocks as jblk
import repro.models.layers as jlayers
import repro.models.lm as jlm
import repro.optim.adamw as jadamw
import repro_torch.configs as tcfgs
import repro_torch.launch.shardings as tsh
import repro_torch.launch.specs as tspecs
import repro_torch.models.blocks as tblk
import repro_torch.models.layers as tlayers
import repro_torch.models.lm as tlm
import repro_torch.optim.adamw as tadamw
from repro_torch.launch.mesh import LocalMesh
from repro_torch.models.sharding_ctx import P

ARCHS = list(jcfgs.ARCH_IDS) + ["pixtral-12b-ip2"]
PLANS = {
    "tp1": dict(tp=1),
    "tp2": dict(tp=2),
    "tp16": dict(tp=16),
    "fsdp": dict(tp=16, fsdp=True),
    "fsdp_pod": dict(tp=16, fsdp=True, fsdp_axis=("pod", "data"), dp_axes=("pod", "data")),
}
CACHES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _cfgs(arch):
    if arch == "pixtral-12b-ip2":
        return (dataclasses.replace(jcfgs.get_config("pixtral-12b"), vision_frontend="ip2"),
                dataclasses.replace(tcfgs.get_config("pixtral-12b"), vision_frontend="ip2"))
    return jcfgs.get_config(arch), tcfgs.get_config(arch)


def _plans(name):
    return jlayers.ParallelPlan(**PLANS[name]), tlayers.ParallelPlan(**PLANS[name])


def _tuples(tree):
    """A spec tree (either package's) with every spec as a plain tuple."""
    if isinstance(tree, (JP, P)):
        return ("SPEC", tuple(tree))
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tuples(v) for v in tree]
    raise TypeError(type(tree))


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch, plan):
    jc, tc = _cfgs(arch)
    jp, tp = _plans(plan)
    jspec, tspec = jlm.param_specs(jc, jp), tlm.param_specs(tc, tp)
    assert _tuples(tspec) == _tuples(jspec)
    assert _tuples(tadamw.opt_state_specs(tspec)) == _tuples(jadamw.opt_state_specs(jspec))


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("plan", ["tp1", "tp16", "fsdp_pod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_match_reference(arch, plan, cache):
    jc, tc = _cfgs(arch)
    jp, tp = _plans(plan)
    jd, td = CACHES[cache]
    want = jlm.decode_state_specs(jc, jp, cache_dtype=jd)
    got = tlm.decode_state_specs(tc, tp, cache_dtype=td)
    assert _tuples(got) == _tuples(want)
    kinds = [s for s in got["stacks"] + got["tail"] if "k" in s]
    assert all(("k_scale" in s) == (cache == "int8") for s in kinds)


@pytest.mark.parametrize("plan", list(PLANS))
def test_plan_spec_methods_match_reference(plan):
    jp, tp = _plans(plan)
    for name in ("spec_embed", "spec_proj_out_tp", "spec_proj_in_tp", "spec_bias_tp",
                 "spec_replicated", "spec_activations", "spec_tokens"):
        assert tuple(getattr(tp, name)()) == tuple(getattr(jp, name)()), name
    for kind in ("swiglu", "geglu", "gelu"):
        assert _tuples(tlayers.spec_mlp(kind, tp)) == _tuples(jlayers.spec_mlp(kind, jp))


@pytest.mark.parametrize("kind", ["attn", "local", "moe", "rglru", "mlstm", "slstm"])
@pytest.mark.parametrize("plan", ["tp2", "fsdp"])
def test_block_specs_match_reference(kind, plan):
    """``spec_block`` and ``state_specs`` of each block kind, on the arch
    that has it (so ``spec_attention``, ``spec_moe`` with its shared
    experts, ``spec_rglru_block``, ``spec_mlstm_block`` and
    ``spec_slstm_block`` are each compared)."""
    arch = {"attn": "qwen2.5-32b", "local": "recurrentgemma-2b",
            "moe": "kimi-k2-1t-a32b", "rglru": "recurrentgemma-2b",
            "mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b"}[kind]
    jc, tc = _cfgs(arch)
    assert kind in tc.layer_kinds
    jp, tp = _plans(plan)
    assert _tuples(tblk.spec_block(kind, tc, tp)) == _tuples(jblk.spec_block(kind, jc, jp))
    for jd, td in CACHES.values():
        assert (_tuples(tblk.state_specs(kind, tc, tp, td))
                == _tuples(jblk.state_specs(kind, jc, jp, jd)))


class _RefMesh:
    """What the reference's ``fit_spec`` / ``plan_for`` read of a mesh."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape, dtype=object)
        self.axis_names = tuple(names)


class _PortMesh:
    """What the port's ``fit_spec`` / ``plan_for`` read of a ``DeviceMesh``
    (a real one needs a process group of that many ranks)."""

    def __init__(self, shape, names):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(names)


def _meshes(shape, names):
    """The reference's mesh stand-in and the port's: a ``LocalMesh`` where
    every device lies on the first axis, else a ``DeviceMesh`` stand-in."""
    n = int(np.prod(shape))
    if n == shape[0]:
        port = LocalMesh([torch.device("cpu")] * n, names)
    else:
        port = _PortMesh(shape, names)
    return _RefMesh(shape, names), port


FIT_CASES = [
    # test_distributed.py:108-121 on (2, 2)
    (("data", "model"), (4, 6), (2, 2)),
    (("data", "model"), (4, 7), (2, 2)),
    ((("data", "model"), None), (1, 8), (2, 2)),
    # the compound prefix rule: (data, model) over 2 keeps data only
    ((("data", "model"), None), (2, 8), (2, 2)),
    ((("data", "model"), "model"), (6, 3), (2, 2)),
    ((None,), (5, 5), (2, 2)),
    ((), (4, 4), (2, 2)),
    # three axes: the pod prefix, a skipped middle axis, a short spec
    ((("pod", "data"), "model"), (4, 32), (2, 4, 16)),
    ((("pod", "data"), "model"), (2, 16), (2, 4, 16)),
    ((("pod", "data", "model"),), (32, 8), (2, 4, 16)),
    ((("pod", "data"),), (6,), (2, 4, 16)),
]


@pytest.mark.parametrize("parts,shape,mesh", FIT_CASES, ids=lambda v: str(v))
def test_fit_spec_matches_reference(parts, shape, mesh):
    names = ("data", "model") if len(mesh) == 2 else ("pod", "data", "model")
    jm, tm = _meshes(mesh, names)
    want = jsh.fit_spec(JP(*parts), shape, jm)
    got = tsh.fit_spec(P(*parts), shape, tm)
    assert tuple(got) == tuple(want)


def test_fit_spec_distributed_cases():
    """The three assertions of the reference's ``test_fit_spec_drops_indivisible``."""
    _, tm = _meshes((2, 2), ("data", "model"))
    assert "model" in tsh.fit_spec(P("data", "model"), (4, 6), tm)
    assert "model" not in tsh.fit_spec(P("data", "model"), (4, 7), tm)
    assert tsh.fit_spec(P(("data", "model"), None), (1, 8), tm)[0] is None


@pytest.mark.parametrize("mesh", [(16, 16), (2, 16, 16), (2, 2), (4, 1)], ids=str)
@pytest.mark.parametrize("arch", sorted(jcfgs.all_configs()))
def test_plan_for_matches_reference(arch, mesh):
    names = ("data", "model") if len(mesh) == 2 else ("pod", "data", "model")
    jm, tm = _meshes(mesh, names)
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    j, t = jsh.plan_for(jc, jm), tsh.plan_for(tc, tm)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(tsh.train_plan_for(tc)) == dataclasses.asdict(
        jsh.train_plan_for(jc))


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    _, tm = _meshes((2, 4, 16), ("pod", "data", "model"))
    assert tsh.placements_for(P(("pod", "data"), "model"), tm) == (Shard(0), Shard(0), Shard(1))
    assert tsh.placements_for(P(None, "data"), tm) == (Replicate(), Shard(1), Replicate())
    assert tsh.placements_for(P(), tm) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements_for(P(("model", "data")), tm)
    with pytest.raises(ValueError, match="shards two dims"):
        tsh.placements_for(P("data", "data"), tm)


def _cells():
    return [(a, s) for a in jcfgs.ARCH_IDS for s in jcfgs.SHAPES]


@pytest.mark.parametrize("arch,shape", _cells(), ids=lambda v: str(v))
def test_input_specs_match_reference(arch, shape):
    want = jspecs.input_specs(arch, shape)
    got = tspecs.input_specs(arch, shape)
    assert list(got) == list(want)
    for k, sds in want.items():
        assert tuple(got[k].shape) == tuple(sds.shape), k
        assert got[k].device.type == "meta"
        assert str(got[k].dtype).removeprefix("torch.") == np.dtype(sds.dtype).name, k


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_and_shardings_match_reference(arch):
    jc, tc = _cfgs(arch)
    jshape, tshape = jcfgs.SHAPES["train_4k"], tcfgs.SHAPES["train_4k"]
    want, got = jspecs.batch_specs(jc, jshape), tspecs.batch_specs(tc, tshape)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    jp, tp = _plans("fsdp_pod")
    assert _tuples(tspecs.batch_spec_shardings(tc, tshape, tp)) == _tuples(
        jspecs.batch_spec_shardings(jc, jshape, jp))
