"""The port's dry run (``repro_torch.launch.dryrun``), its record of one
rank (``roofline.trace``), ``collective_bytes`` / ``cost_point`` and the
report tables, on ``fake`` process groups in this one process.

Held against hand counts (collectives at 4 and 256 ranks, a sharded
product on 256 ranks: rank 0's flops, not the global product's) and
against the reference: one subprocess (8 forced CPU devices, ``Auto``
``jax.sharding.Mesh``es, compiled with ``--xla_cpu_max_isa=AVX`` as
``tests/test_torch_distributed.py``'s jobs are) lowers and compiles the
reference's ``lower_cell`` on four smoke cells at a small ``ShapeConfig``
on (2, 2) and on the three ``FAULT_CELLS`` on their own meshes, while the
port traces the same cells on fake meshes of those shapes. Held: the
plan, the argument bytes and the output bytes exactly (XLA:CPU's output
size also counts the result tuple's table of 8-byte pointers, one per
output leaf), and each roofline point's flops between a floor and the
reference's HLO flops (XLA counts elementwise work too; the port counts
matmul-class ops).

The fake tensors lie on the CPU here: this CPU-only torch cannot run
autograd on fake CUDA tensors (``lower_cell`` says so). ``chip_smoke.py``
phase (l) runs the dry run on fake CUDA tensors.
"""

import dataclasses
import functools
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.shardings import plan_for
from repro_torch.roofline import analysis, report
from repro_torch.roofline.trace import fake_world, trace_step

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

SMALL = {"train": ShapeConfig("train_small", 16, 8, "train"),
         "decode": ShapeConfig("decode_small", 16, 8, "decode"),
         "prefill": ShapeConfig("prefill_small", 16, 8, "prefill"),
         "decode_b1": ShapeConfig("decode_b1", 16, 1, "decode"),
         "prefill_long": ShapeConfig("prefill_long", 2560, 4, "prefill"),
         "train_long": ShapeConfig("train_long", 2560, 4, "train")}
CELLS = (("llama3-8b", "train"), ("qwen3-moe-235b-a22b", "train"), ("llama3-8b", "decode"),
         ("xlstm-1.3b", "prefill"))
# the port's flops at each point as a share of the reference's HLO flops
# (plus slstm_flops_correction), at least. Measured (this file's cells, 1x /
# 2x point): llama3-8b train 0.844 / 0.825, qwen3-moe train 0.906 / 0.898,
# llama3-8b decode 0.796 / 0.631, xlstm prefill 0.827 / 0.800
FLOPS_FLOOR = {("llama3-8b", "train"): 0.80, ("qwen3-moe-235b-a22b", "train"): 0.87,
               ("llama3-8b", "decode"): 0.60, ("xlstm-1.3b", "prefill"): 0.77}
TUPLE_ENTRY_BYTES = 8
# cells the port's dry run once raised on, each on its own (data, model) mesh
# (plan and bytes held; no roofline points): xlstm's 4 heads on a model axis
# of 8 (the production mesh's 16 shards the head width, as the reference's
# spec does), decode and train; a decode of global batch 1 on 2 data ranks
# (long_500k's batch of one on 16)
# (long_500k's batch of one on 16); recurrentgemma-2b's prefill_32k and
# train_4k geometry (fault 14): query heads that do not divide the model
# axis (6 on 4, as 10 on 16) over one kv head, and sequences long enough
# that DTensor contracts the RG-LRU's gate products over the width the
# model axis shards into a pending sum, as at production size (torch 2.11
# then asked the gate bias to become that sum)
FAULT_CELLS = (("xlstm-1.3b", "decode", (1, 8)), ("xlstm-1.3b", "train", (1, 8)),
               ("recurrentgemma-2b", "decode_b1", (2, 2)),
               ("recurrentgemma-2b", "prefill_long", (2, 4)),
               ("recurrentgemma-2b", "train_long", (2, 4)))
# the smoke config's changes for a fault cell: (arch, mesh) -> fields
FAULT_CONFIG = {("recurrentgemma-2b", (2, 4)): {"n_heads": 6}}
# multi-pod cells on (2, 2, 2) ("pod", "data", "model"), one with FSDP set
# by hand over ("pod", "data") in both packages (smoke configs fall under
# plan_for's 10B mark), and a decode, whose batch of tokens lies over
# ("pod", "data") (fault 15): (arch, kind, fsdp)
MULTI_POD_CELLS = (("llama3-8b", "train", False), ("recurrentgemma-2b", "prefill", False),
                   ("llama3-8b", "train", True), ("llama3-8b", "decode", False))
MULTI_POD_MESH = (2, 2, 2)
# each multi-pod trace's own limit, and the fixture's for all of them (a
# stall fails the cases instead of the suite's clock); measured here
# 7-24 s a cell (before the multi-pod mesh kept S whole, over 420 s)
MULTI_POD_SECONDS = 90
MULTI_POD_DEADLINE = 240


def _key(arch, kind, mesh, fsdp=False):
    return f"{arch}/{kind}/{'x'.join(map(str, mesh))}" + ("/fsdp" if fsdp else "")


def _fault_cfg(arch, mesh):
    return dataclasses.replace(smoke_config(arch), **FAULT_CONFIG.get((arch, tuple(mesh)), {}))


class _Deadline:
    """Raises ``TimeoutError`` in the main thread after ``seconds``."""

    def __init__(self, seconds):
        self.seconds = seconds

    def _fire(self, *_):
        raise TimeoutError(f"the multi-pod traces ran past {self.seconds} s")

    def __enter__(self):
        self.old = signal.signal(signal.SIGALRM, self._fire)
        signal.alarm(self.seconds)

    def __exit__(self, *exc):
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self.old)
        return False


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8 --xla_cpu_max_isa=AVX"
    env["JAX_PLATFORMS"] = "cpu"
    return env


_REF = r"""
import dataclasses, json, sys
import numpy as np
import jax
from jax.sharding import Mesh
devices = jax.devices()          # the backend starts with the 8 forced devices
import repro.launch.dryrun as D  # its XLA_FLAGS come too late to matter
from repro.configs import smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.shardings import plan_for
from repro.roofline.analysis import cost_point

small = {k: ShapeConfig(*v) for k, v in json.loads(sys.argv[2]).items()}
res = {}
for key, arch, kind, shp, repl, fsdp in json.loads(sys.argv[3]):
    names = ("pod", "data", "model")[-len(shp):]
    n = int(np.prod(shp))
    mesh = Mesh(np.array(devices[:n]).reshape(shp), names)
    cfg, shape = dataclasses.replace(smoke_config(arch), **repl), small[kind]
    plan = plan_for(cfg, mesh)
    if fsdp:
        plan = dataclasses.replace(plan, fsdp=True)
    ma = D.lower_cell(cfg, shape, mesh, plan).compile().memory_analysis()
    pts = []
    for mult in ((1, 2) if shp == [2, 2] else ()):
        rcfg = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern) * mult,
                                   unroll_layers=True)
        cp = cost_point(D.lower_cell(rcfg, shape, mesh, plan).compile())
        pts.append({"flops": cp["flops"],
                    "slstm": D.slstm_flops_correction(rcfg, shape, rcfg.n_layers, 4)})
    res[key] = {"plan": {"tp": plan.tp, "fsdp": plan.fsdp},
                "argument_bytes": int(ma.argument_size_in_bytes),
                "output_bytes": int(ma.output_size_in_bytes), "points": pts}
json.dump(res, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def against_reference(tmp_path_factory):
    """The reference's results (one subprocess, started first) and the
    port's traces of the same cells on fake meshes of the same shapes."""
    out = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    small = {k: [s.name, s.seq_len, s.global_batch, s.kind] for k, s in SMALL.items()}
    cells = ([(_key(a, k, (2, 2)), a, k, (2, 2), {}, False) for a, k in CELLS]
             + [(_key(a, k, m), a, k, m, FAULT_CONFIG.get((a, m), {}), False)
                for a, k, m in FAULT_CELLS]
             + [(_key(a, k, MULTI_POD_MESH, f), a, k, MULTI_POD_MESH, {}, f)
                for a, k, f in MULTI_POD_CELLS])
    proc = subprocess.Popen([sys.executable, "-c", _REF, str(out), json.dumps(small),
                             json.dumps(cells)], env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    port = {}
    try:
        with fake_world(4):
            mesh = mesh_mod.make_host_mesh(2, 2, device_type="cpu")
            for arch, kind in CELLS:
                cfg, shape = smoke_config(arch), SMALL[kind]
                plan = plan_for(cfg, mesh)
                pat = len(cfg.block_pattern)
                pts = [dryrun.lower_cell(dataclasses.replace(
                    cfg, n_layers=pat * mult, unroll_layers=True), shape, mesh, plan)
                    for mult in (1, 2)]
                # each smoke stack is 1x or 2x its pattern, and the port's layer
                # loop is the same program unrolled or not: that point is the
                # full-depth trace
                port[_key(arch, kind, (2, 2))] = {
                    "plan": {"tp": plan.tp, "fsdp": plan.fsdp},
                    "full": pts[cfg.n_layers // pat - 1], "points": pts}
        for arch, kind, shp in FAULT_CELLS:
            with fake_world(shp[0] * shp[1]):
                mesh = mesh_mod.make_host_mesh(*shp, device_type="cpu")
                cfg = _fault_cfg(arch, shp)
                plan = plan_for(cfg, mesh)
                port[_key(arch, kind, shp)] = {
                    "plan": {"tp": plan.tp, "fsdp": plan.fsdp},
                    "full": dryrun.lower_cell(cfg, SMALL[kind], mesh, plan)}
        with _Deadline(MULTI_POD_DEADLINE), fake_world(8):
            mesh = mesh_mod._device_mesh(MULTI_POD_MESH, ("pod", "data", "model"), "cpu")
            for arch, kind, fsdp in MULTI_POD_CELLS:
                cfg = smoke_config(arch)
                plan = plan_for(cfg, mesh)
                if fsdp:
                    plan = dataclasses.replace(plan, fsdp=True)
                t0 = time.time()
                full = dryrun.lower_cell(cfg, SMALL[kind], mesh, plan)
                port[_key(arch, kind, MULTI_POD_MESH, fsdp)] = {
                    "plan": {"tp": plan.tp, "fsdp": plan.fsdp},
                    "fsdp_axis": plan.fsdp_axis, "full": full, "s": time.time() - t0}
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-3000:]
    return json.loads(out.read_text()), port


@pytest.mark.parametrize("arch,kind", CELLS)
def test_bytes_and_plan_match_reference(against_reference, arch, kind):
    """The plan and the argument and output bytes per device equal the
    reference's compiled program's (the output's tuple table aside)."""
    ref, port = against_reference
    r, p = ref[_key(arch, kind, (2, 2))], port[_key(arch, kind, (2, 2))]
    assert p["plan"] == r["plan"]
    assert p["full"].argument_bytes == r["argument_bytes"]
    assert (p["full"].output_bytes + TUPLE_ENTRY_BYTES * p["full"].n_outputs
            == r["output_bytes"])


@pytest.mark.parametrize("arch,kind,mesh", FAULT_CELLS)
def test_fault_cells_match_reference(against_reference, arch, kind, mesh):
    """The cells the port's dry run raised on now run, and their plan and
    argument and output bytes per device equal the reference's compiled
    program's on the same (data, model) mesh (the output's tuple table
    aside)."""
    ref, port = against_reference
    r, p = ref[_key(arch, kind, mesh)], port[_key(arch, kind, mesh)]
    assert p["plan"] == r["plan"] == {"tp": mesh[1], "fsdp": False}
    assert p["full"].argument_bytes == r["argument_bytes"]
    assert (p["full"].output_bytes + TUPLE_ENTRY_BYTES * p["full"].n_outputs
            == r["output_bytes"])


@pytest.mark.parametrize("arch,kind", CELLS)
def test_point_flops_bracketed_by_reference(against_reference, arch, kind):
    """Each roofline point's flops: at most the reference's HLO flops plus
    its sLSTM correction, at least the measured floor of that."""
    ref, port = against_reference
    cfg = smoke_config(arch)
    for mult, r, p in zip((1, 2), ref[_key(arch, kind, (2, 2))]["points"],
                          port[_key(arch, kind, (2, 2))]["points"]):
        n = len(cfg.block_pattern) * mult
        assert dryrun.slstm_flops_correction(
            dataclasses.replace(cfg, n_layers=n), SMALL[kind], n, 4) == r["slstm"]
        want = r["flops"] + r["slstm"]
        assert FLOPS_FLOOR[(arch, kind)] * want <= p.flops <= want, (p.flops, want)


def test_replicate_detours_are_counted(against_reference):
    """The MoE dispatch (qwen3-moe) runs through ``sharding_ctx.replicated``,
    whose all-gathers GSPMD would not make. They are counted in the trace
    as the port runs them (printed with -s: their share of the collective
    bytes); llama3-8b has none, nor has xlstm's prefill, whose mLSTM and
    sLSTM run on batch shards (the sLSTM's scan is one op there), nor its
    decode on (1, 8): the logsigmoid of the mLSTM's decode step still runs
    through ``replicated``, but its gates come out of the head products
    whole on every model rank (``xlstm._HeadProducts``), so the detour
    moves nothing."""
    _, port = against_reference
    for key, detours in (("qwen3-moe-235b-a22b/train/2x2", True),
                         ("xlstm-1.3b/decode/1x8", False), ("xlstm-1.3b/prefill/2x2", False),
                         ("llama3-8b/train/2x2", False)):
        tr = port[key]["full"]
        det = analysis.collective_bytes(dataclasses.replace(tr, collectives=tr.detour_collectives))
        total = analysis.collective_bytes(tr)
        print(key, "detours:", det["counts"], det["total"], "of", total["total"], "bytes")
        assert all(c in tr.collectives for c in tr.detour_collectives)
        assert (det["total"] > 0) == detours


@pytest.mark.parametrize("arch,kind,fsdp", MULTI_POD_CELLS)
def test_multi_pod_cells_match_reference(against_reference, arch, kind, fsdp):
    """Smoke cells on a (2, 2, 2) ("pod", "data", "model") mesh of fake
    ranks, each traced within ``MULTI_POD_SECONDS`` (the fixture's traces
    stop at ``MULTI_POD_DEADLINE``), against the reference's compiled
    cells on 8 forced devices: the plan, with FSDP (set by hand) over
    ("pod", "data"), and the argument and output bytes per device (the
    output's tuple table aside)."""
    ref, port = against_reference
    key = _key(arch, kind, MULTI_POD_MESH, fsdp)
    r, p = ref[key], port[key]
    print(key, f"{p['s']:.1f} s")
    assert p["s"] < MULTI_POD_SECONDS
    assert p["plan"] == r["plan"] == {"tp": 2, "fsdp": fsdp}
    assert p["fsdp_axis"] == ("pod", "data")
    assert p["full"].argument_bytes == r["argument_bytes"]
    assert (p["full"].output_bytes + TUPLE_ENTRY_BYTES * p["full"].n_outputs
            == r["output_bytes"])


def test_multi_pod_collectives_by_axis(against_reference):
    """The multi-pod trace attributes each collective to the mesh axes of
    its group: the training step's traffic over "pod" (the slow axis
    between pods) is reported apart from that over "data", by kind, and
    the axes' bytes add up to the trace's total; with FSDP the weights are
    all-gathered over "pod" too."""
    _, port = against_reference
    for fsdp in (False, True):
        tr = port[_key("llama3-8b", "train", MULTI_POD_MESH, fsdp)]["full"]
        by = analysis.collectives_by_axis(tr)
        print(fsdp, json.dumps(by))
        assert len(tr.collective_axes) == len(tr.collectives)
        assert {"pod", "data", "model"} <= set(by)
        assert all(axes.split("+") == [a for a in ("pod", "data", "model") if a in axes]
                   for axes in by)
        assert sum(v for d in by.values() for k, v in d.items() if k != "counts") \
            == analysis.collective_bytes(tr)["total"]
        assert by["pod"]["counts"].get("all-reduce", 0) > 0
    assert by["pod"]["counts"]["all-gather"] > 0


def test_rglru_gates_never_contract_into_a_pending_sum(monkeypatch):
    """Fault 14, the op alone: at recurrentgemma-2b's production widths on
    the (16, 16) mesh of fake ranks, ``x @ wa`` with ``x`` sharded on its
    width contracts into a ``Partial`` sum (this torch then reduce-scatters
    it to add the ``Shard(0)`` bias, the check's control; torch 2.11 asked
    the bias to become a ``Partial``, a redistribution it does not have).
    The repaired
    ``rglru._gates`` makes ``x`` whole along its width first: none of its
    redistributions comes from or goes to a ``Partial``, and both gates
    come out column-sharded as the biases are."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Partial, Replicate, Shard
    import torch.distributed.tensor._api as api
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute
    from repro_torch.configs import get_config
    from repro_torch.models import rglru

    seen = []
    real = redistribute.redistribute_local_tensor

    def spy(local, current, target, *args, **kwargs):
        seen.append((tuple(current.placements), tuple(target.placements)))
        return real(local, current, target, *args, **kwargs)

    # the name as DTensor's dispatcher, its API and its redistribution hold it
    for mod in (redistribute, dispatch, api):
        monkeypatch.setattr(mod, "redistribute_local_tensor", spy)
    cfg = get_config("recurrentgemma-2b")
    d, fake = cfg.d_model, FakeTensorMode()
    col, bias = [Replicate(), Shard(1)], [Replicate(), Shard(0)]
    with fake_world(256):
        mesh = mesh_mod.make_host_mesh(16, 16, device_type="cpu")
        x = _dt((32, 32768, d), mesh, [Shard(0), Shard(2)], fake).to(torch.bfloat16)
        p = {k: _dt((d, d), mesh, col, fake) for k in ("wa", "wxg")}
        p.update({k: _dt((d,), mesh, bias, fake) for k in ("ba", "bxg", "lam")})
        unrepaired = x.to(torch.float32) @ p["wa"]
        seen.clear()
        unrepaired + p["ba"]             # the control: the pending sum is redistributed
        control = list(seen)
        seen.clear()
        log_a, gated = rglru._gates(p, x)
    print("unrepaired", control, "repaired", seen)
    assert any(isinstance(pl, Partial) for pl in unrepaired.placements)
    assert any(isinstance(pl, Partial) for pair in control for side in pair for pl in side)
    assert seen and not any(isinstance(pl, Partial) for pair in seen for side in pair
                            for pl in side), seen
    assert tuple(log_a.placements) == tuple(gated.placements) == (Shard(0), Shard(2))


class _DTensorOps(TorchDispatchMode):
    """Records the ops dispatched with a ``DTensor`` operand (those whose
    layout ``DTensor``'s sharding propagation decides), then lets
    ``DTensor`` run them."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            self.ops.append(str(func))
            return NotImplemented
        return func(*args, **(kwargs or {}))


def test_decode_embeds_tokens_over_two_axes_on_local_shards():
    """Fault 15, the op alone: a multi-pod decode's tokens lie over two
    mesh axes ("pod", "data"), and torch 2.11's ``DTensor`` has no rule for
    indexing the embedding by them ("does not support things like hybrid
    sharding strategies yet"; this torch plans it for minutes). The
    decode embeds as the forward does (``lm._embed``: each rank indexes the
    whole table with its own tokens), so no ``aten.index`` on a ``DTensor``
    reaches ``DTensor``'s sharding propagation (plain indexing does, the
    check's control, on (2, 2)); the rows are the table's."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import lm

    table = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    tokens = torch.tensor([5, 0, 63, 7, 7, 1, 2, 40])
    with fake_world(4):
        mesh = mesh_mod.make_host_mesh(2, 2, device_type="cpu")
        with _DTensorOps() as control:
            distribute_tensor(table, mesh, [Replicate(), Shard(0)])[
                distribute_tensor(tokens, mesh, [Shard(0), Replicate()])]
    assert any("index" in op for op in control.ops), control.ops
    with fake_world(8):
        mesh = mesh_mod._device_mesh(MULTI_POD_MESH, ("pod", "data", "model"), "cpu")
        t_dt = distribute_tensor(table, mesh, [Replicate(), Replicate(), Shard(0)])
        k_dt = distribute_tensor(tokens, mesh, [Shard(0), Shard(0), Replicate()])
        with _DTensorOps() as seen:
            out = lm._embed(t_dt, k_dt)
    assert not any("index" in op for op in seen.ops), seen.ops
    assert tuple(out.placements) == (Shard(0), Shard(0), Replicate())
    # rank 0 holds the batch's first two tokens (8 over pod x data = 4 ranks)
    assert torch.equal(out.to_local(), table[tokens[:2]])


def test_mlstm_final_state_on_batch_shards():
    """Fault 16, the op alone: a multi-pod training step's batch lies over
    ("pod", "data"), and torch 2.11's ``DTensor`` einsum of the mLSTM's
    final state ("bsn,bsnv,bsnk->bnvk") views that batch's local shard at
    the wrong size (xlstm-1.3b train_4k on the (2, 16, 16) mesh; at cut
    depth on the card, a batch of 256 raised and one of 32 did not). The
    block folds the state on each rank's batch shard
    (``sharding_ctx.batch_shards``, its dict result laid out as the batch
    is): no op on a ``DTensor`` runs inside, and rank 0's state is the
    plain function's on its shard of the batch."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import xlstm
    from repro_torch.models.sharding_ctx import batch_shards

    g = torch.Generator().manual_seed(0)
    b, s, nh, dh = 8, 5, 2, 4
    k, v = (torch.randn(b, s, nh, dh, generator=g) for _ in range(2))
    i_raw, f_raw = (torch.randn(b, s, nh, generator=g) for _ in range(2))
    batch = [Shard(0), Shard(0), Replicate()]
    with fake_world(8):
        mesh = mesh_mod._device_mesh(MULTI_POD_MESH, ("pod", "data", "model"), "cpu")
        args = [distribute_tensor(t, mesh, batch) for t in (k, v, i_raw, f_raw)]
        with _DTensorOps() as seen:
            got = batch_shards(xlstm.mlstm_final_state, *args)
    want = xlstm.mlstm_final_state(k[:2], v[:2], i_raw[:2], f_raw[:2])
    assert not seen.ops, seen.ops
    assert set(got) == {"C", "n", "m"}
    for name, t in got.items():
        assert tuple(t.placements) == tuple(batch), name
        assert torch.equal(t.to_local(), want[name]), name


# ---------------------------------------------------------------------------
# hand counts on fake ranks
# ---------------------------------------------------------------------------

def _dt(shape, mesh, placements, fake):
    from torch.distributed.tensor import distribute_tensor

    with fake:
        return distribute_tensor(torch.empty(shape), mesh, placements, src_data_rank=None)


@pytest.mark.parametrize("n", [4, 256])
def test_collective_bytes_of_redistributions(n):
    """Each redistribution's collective by the reference's kind name, once,
    with the bytes of its result on rank 0 (a 1024 x 512 float32 tensor
    over the "data" axis of a (2, 2) or (16, 16) mesh). On the CPU,
    DTensor turns Shard(0) -> Shard(1) into a gather and a local chunk; its
    CUDA all-to-all (``_dtensor.shard_dim_alltoall``) is counted from the
    op itself, and the pipeline's ring shift as a collective-permute."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.distributed.pipeline import _ring

    fake = FakeTensorMode()
    side = int(n ** 0.5)
    full = 1024 * 512 * 4
    with fake_world(n):
        mesh = mesh_mod.make_host_mesh(side, side, device_type="cpu")
        rep = [Replicate(), Replicate()]
        cases = {
            "all-gather": ([Shard(0), Replicate()], rep, full),
            "all-reduce": ([Partial(), Replicate()], rep, full),
            "reduce-scatter": ([Partial(), Replicate()], [Shard(0), Replicate()],
                               full // side),
        }
        for kind, (src, dst, nbytes) in cases.items():
            x = _dt((1024, 512), mesh, src, fake)
            coll = analysis.collective_bytes(
                trace_step(lambda t, dst=dst: t.redistribute(mesh, dst), x))
            assert coll == {kind: nbytes, "total": nbytes, "counts": {kind: 1}}, (kind, coll)
        x = _dt((1024, 512), mesh, [Shard(0), Replicate()], fake)
        coll = analysis.collective_bytes(
            trace_step(lambda t: t.redistribute(mesh, [Shard(1), Replicate()]), x))
        assert coll["counts"] == {"all-gather": 1} and coll["all-gather"] == full
        group = mesh.get_group("data").group_name
        local = x.to_local()
        coll = analysis.collective_bytes(trace_step(
            lambda t: torch.ops._dtensor.shard_dim_alltoall(t, 0, 1, group), local))
        assert coll == {"all-to-all": full // side, "total": full // side,
                        "counts": {"all-to-all": 1}}
        # the pipeline's ring shift (a c10d send and receive): the bytes sent
        coll = analysis.collective_bytes(trace_step(
            lambda t: _ring(t, dist.group.WORLD, 1), local))
        assert coll == {"collective-permute": full // side, "total": full // side,
                        "counts": {"collective-permute": 1}}


def test_bmm_with_out_dtype_is_counted():
    """``torch.bmm(..., out_dtype=)`` (the bf16 cache contraction on the
    card) carries its output dtype as a third positional argument: its
    flops are counted by the bmm formula all the same."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode()
    with fake:
        a = torch.empty(4, 8, 16, dtype=torch.bfloat16)
        b = torch.empty(4, 16, 32, dtype=torch.bfloat16)
    tr = trace_step(lambda x, y: torch.bmm(x, y, out_dtype=torch.float32), a, b,
                    fake_mode=fake)
    assert tr.flops == 2 * 4 * 8 * 16 * 32


def test_cost_point_counts_rank0_share():
    """A 4096^2 @ 4096^2 product sharded [Shard(0), Replicate()] @
    [Replicate(), Shard(1)] on 256 ranks. ``FlopCounterMode`` counts the
    global product; ``cost_point`` rank 0's share, 2 * 4096^3 / 256."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    fake = FakeTensorMode()
    with fake_world(256):
        mesh = mesh_mod.make_host_mesh(16, 16, device_type="cpu")
        a = _dt((4096, 4096), mesh, [Shard(0), Replicate()], fake)
        b = _dt((4096, 4096), mesh, [Replicate(), Shard(1)], fake)
        pt = analysis.cost_point(trace_step(lambda x, y: x @ y, a, b))
        with FlopCounterMode(display=False) as fc:
            a @ b
    assert pt["flops"] == 2 * 4096**3 / 256
    assert fc.get_total_flops() == 2 * 4096**3
    assert pt["coll_bytes"] == 0.0 and pt["coll_detail"] == {"counts": {}}
    # the local product's operands and result: 256 x 4096, 4096 x 256, 256 x 256
    assert pt["bytes"] == 4 * (2 * 256 * 4096 + 256 * 256)


@pytest.mark.parametrize("version,seq_sharded", [("2.11.0+cu128", False), ("2.13.0", True)])
def test_sequence_sharding_needs_strided_flatten(monkeypatch, version, seq_sharded):
    """The "act" constraint shards S over the model axis only where DTensor
    can flatten (B, S) sharded over two axes (torch 2.13; 2.11 raises in
    every (B, S, D) @ (D, F) product); likewise the MoE buffer's C over
    the data axis (the MoE flattens (E, C), E over the model axis)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.shardings import make_constrainer

    monkeypatch.setattr(torch, "__version__", version)
    fake = FakeTensorMode()
    with fake_world(4):
        mesh = mesh_mod.make_host_mesh(2, 2, device_type="cpu")
        x = _dt((4, 8, 16), mesh, [Replicate(), Replicate()], fake)
        constrain = make_constrainer(mesh, plan_for(smoke_config("llama3-8b"), mesh))
        act = constrain(x, "act")
        buf = constrain(_dt((4, 8, 16), mesh, [Replicate(), Replicate()], fake), "moe_buf")
    want = (Shard(0), Shard(1)) if seq_sharded else (Shard(0), Replicate())
    assert tuple(act.placements) == want
    assert tuple(buf.placements) == ((Shard(1), Shard(0)) if seq_sharded
                                     else (Replicate(), Shard(0)))


@pytest.mark.skipif(torch.backends.cuda.is_built(), reason="a CUDA build runs fake CUDA steps")
def test_fake_cuda_step_needs_a_cuda_build():
    """A CPU-only torch aborts in autograd on fake CUDA tensors: lower_cell
    refuses a CUDA mesh there, saying what to do."""
    import types

    cfg = smoke_config("llama3-8b")
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        dryrun.lower_cell(cfg, SMALL["train"], types.SimpleNamespace(device_type="cuda"),
                          None)


def test_fake_init_draws_nothing():
    """The parameters' shapes come from ``init_params`` under a
    ``FakeTensorMode`` on the generator's device (nothing drawn: the
    generator's state is unchanged); each rank's shard is a fake tensor
    on the mesh's device."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from repro_torch.convert import tree_flatten_with_paths
    from repro_torch.models import lm

    cfg = smoke_config("llama3-8b")
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    with fake_world(4):
        mesh = mesh_mod.make_host_mesh(2, 2, device_type="cpu")
        plan = plan_for(cfg, mesh)
        with FakeTensorMode():
            params = lm.init_params(gen, cfg, plan, device="cpu")
            placed = dryrun._placed(params, dryrun.shardings_for(
                lm.param_specs(cfg, plan), params, mesh), torch.device("cpu"))
    assert torch.equal(gen.get_state(), state)
    leaves = [x for _, x in tree_flatten_with_paths(placed)]
    assert leaves and all(type(x).__name__ == "DTensor" for x in leaves)
    assert all(isinstance(x.to_local(), FakeTensor) for x in leaves)
    assert placed["embed"].to_local().shape[0] == params["embed"].shape[0] // 2


def test_extrapolation_is_exact_for_a_homogeneous_stack():
    """The 1x / 2x points extrapolated to 4 repeats equal the 4-layer
    trace's flops exactly. Its bytes and collective bytes are not linear in
    the depth: DTensor picks the layouts of the optimiser's ops on the
    stacked (L, ...) leaves by their shape (at L 3 it pads), so they are
    held within 10 % (measured: bytes 0.47 %, collective bytes 5.7 % under
    the 4-layer trace's)."""
    cfg = smoke_config("llama3-8b")
    with fake_world(4):
        mesh = mesh_mod.make_host_mesh(2, 2, device_type="cpu")
        plan = plan_for(cfg, mesh)
        pts = [analysis.cost_point(dryrun.lower_cell(
            dataclasses.replace(cfg, n_layers=n), SMALL["train"], mesh, plan))
            for n in (1, 2, 4)]
    terms = analysis.extrapolate(pts[0], pts[1], 1, 2, 4)
    assert terms.flops_per_chip == pts[2]["flops"]
    assert terms.bytes_per_chip == pytest.approx(pts[2]["bytes"], rel=0.10)
    assert terms.coll_bytes_per_chip == pytest.approx(pts[2]["coll_bytes"], rel=0.10)


# ---------------------------------------------------------------------------
# run_cell and main, at smoke configs on (2, 2) / (2, 2, 2) fake meshes
# ---------------------------------------------------------------------------

TINY = {"train_small": ShapeConfig("train_small", 16, 8, "train"),
        "decode_small": ShapeConfig("decode_small", 32, 8, "decode")}


@pytest.fixture
def small_cells(monkeypatch):
    """run_cell on smoke configs, the small shapes and the production
    meshes cut to (2, 2) and (1, 1, 1), with fake CPU tensors (the
    multi-pod layouts are held on (2, 2, 2) by
    ``test_multi_pod_cells_match_reference``; here the CLI)."""
    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    monkeypatch.setattr(dryrun, "SHAPES", TINY)
    monkeypatch.setattr(mesh_mod, "PRODUCTION_MESHES",
                        {False: ((2, 2), ("data", "model")),
                         True: ((1, 1, 1), ("pod", "data", "model"))})
    monkeypatch.setattr(dryrun, "run_cell", functools.partial(dryrun.run_cell,
                                                              device_type="cpu"))


@pytest.fixture(scope="module")
def escalated_record():
    """A training cell whose step does not fit a capacity of 1 KiB: the
    microbatches rise to the largest option, then the roofline points."""
    mp = pytest.MonkeyPatch()
    mp.setattr(dryrun, "get_config", smoke_config)
    mp.setattr(dryrun, "SHAPES", TINY)
    mp.setattr(mesh_mod, "PRODUCTION_MESHES", {False: ((2, 2), ("data", "model"))})
    try:
        yield dryrun.run_cell("llama3-8b", "train_small", "single", hbm_bytes=1024,
                              device_type="cpu")
    finally:
        mp.undo()


def test_run_cell_escalates_microbatches(escalated_record):
    rec = escalated_record
    # dp 2 of 4 ranks, batch 8: microbatch options 1 and 4
    assert [t["microbatches"] for t in rec["microbatch_trail"]] == [1, 4]
    assert rec["microbatches"] == 4 and rec["memory"]["fits_hbm"] is False
    m = rec["memory"]
    assert m["approx_peak_per_device"] == rec["microbatch_trail"][-1]["peak_per_device"]
    assert m["temp_bytes_per_device"] == m["approx_peak_per_device"] \
        - m["argument_bytes_per_device"]
    assert rec["chips"] == 4 and rec["plan"] == {"tp": 2, "fsdp": False}
    assert rec["t_memory_floor_s"] == 3.0 * m["argument_bytes_per_device"] / mesh_mod.HBM_BW
    rl = rec["roofline"]
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert rl["t_compute_s"] == rl["flops_per_chip"] / mesh_mod.PEAK_FLOPS_BF16
    assert [p["flops"] > 0 for p in rl["points"]] == [True, True]
    # the smoke stack is its own 2x point: extrapolated to its depth, exact
    assert rl["flops_per_chip"] == rl["points"][1]["flops"]


def test_main_flags_resume_and_errors(small_cells, monkeypatch, tmp_path, capsys):
    """Every flag of the reference's CLI: --arch/--shape/--mesh both/
    --no-roofline/--out, then --all with --cache-dtype int8, --moe-dispatch
    a2a (forced off in decode) and --xlstm-chunk; a rerun skips the cells
    that are done and retries the one that failed, and the one whose
    record holds only its full-depth step (written before its roofline
    points ran)."""
    out = tmp_path / "r.json"
    dryrun.main(["--arch", "llama3-8b", "--shape", "decode_small", "--mesh", "both",
                 "--no-roofline", "--out", str(out)])
    res = json.loads(out.read_text())
    assert set(res) == {"llama3-8b/decode_small/single", "llama3-8b/decode_small/multi"}
    assert res["llama3-8b/decode_small/multi"]["chips"] == 1
    assert res["llama3-8b/decode_small/single"]["chips"] == 4
    assert all("roofline" not in v for v in res.values())

    seen = []
    real = dryrun.run_cell

    def spy(arch, shape, mesh, **kw):
        seen.append((arch, kw))
        if arch == "whisper-tiny":
            raise ValueError("no such cell")
        return real(arch, shape, mesh, **kw)

    monkeypatch.setattr(dryrun, "run_cell", spy)
    monkeypatch.setattr(dryrun, "arch_shape_cells", lambda: [
        ("qwen3-moe-235b-a22b", "decode_small"), ("qwen3-moe-235b-a22b", "train_small"),
        ("whisper-tiny", "decode_small")])
    for _ in range(2):
        dryrun.main(["--all", "--cache-dtype", "int8", "--moe-dispatch", "a2a",
                     "--xlstm-chunk", "16", "--out", str(out)])
    res = json.loads(out.read_text())
    # the second pass skipped the done cells and ran the failed one again
    assert [a for a, _ in seen] == ["qwen3-moe-235b-a22b"] * 2 + ["whisper-tiny"] * 2
    kw = dict(seen[0][1])
    assert callable(kw.pop("on_gate"))
    assert kw == {"do_roofline": True, "cache_dtype_name": "int8", "moe_a2a": True,
                  "xlstm_chunk": 16}
    assert all("stage" not in v for v in res.values())
    assert res["whisper-tiny/decode_small/single"]["error"] == "ValueError: no such cell"
    moe = res["qwen3-moe-235b-a22b/decode_small/single"]
    assert "all-to-all" not in moe["full_collectives"]  # a2a is forced off in decode
    assert moe["roofline"]["points"][0]["flops"] > 0
    # in training the MoE dispatch is the all-to-all: c10d's in-place
    # all_to_all_single, 2 a layer forward and 2 backward, 2 layers
    assert res["qwen3-moe-235b-a22b/train_small/single"]["full_collectives"]["all-to-all"] == 8
    printed = capsys.readouterr().out
    assert "[skip] qwen3-moe-235b-a22b/decode_small/single" in printed
    assert "done: 4/5 cells ok" in printed
    # a cell stopped in its roofline points left its gate record: run again
    res["qwen3-moe-235b-a22b/decode_small/single"]["stage"] = "gate"
    out.write_text(json.dumps(res))
    seen.clear()
    dryrun.main(["--all", "--cache-dtype", "int8", "--out", str(out)])
    assert [a for a, _ in seen] == ["qwen3-moe-235b-a22b", "whisper-tiny"]
    assert "stage" not in json.loads(out.read_text())["qwen3-moe-235b-a22b/decode_small/single"]


def test_default_out_is_the_ports_own(monkeypatch, tmp_path):
    """With no --out the port writes results/dryrun_torch.json,
    never the reference's results/dryrun.json."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: {
        "compile_s": 0.0, "memory": {"approx_peak_per_device": 0}})
    dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k"])
    assert (tmp_path / "results" / "dryrun_torch.json").exists()
    assert not (tmp_path / "results" / "dryrun.json").exists()


# ---------------------------------------------------------------------------
# the report tables
# ---------------------------------------------------------------------------

def test_report_tables_match_reference(escalated_record, tmp_path, capsys):
    """The port's tables of a run_cell record equal the reference's on the
    same record (its ``fits_hbm_16g`` key set from ``fits_hbm``) line for
    line, but for the header that names the capacity; the roofline
    fraction is the reference's times its peak over the H100's."""
    from repro.roofline import report as ref_report

    rec = escalated_record
    results = {"llama3-8b/train_small/single": rec,
               "llama3-8b/decode_small/multi": {"error": "ValueError: x"}}
    ref_rec = json.loads(json.dumps(rec))
    ref_rec["memory"]["fits_hbm_16g"] = ref_rec["memory"].pop("fits_hbm")
    ref_results = dict(results, **{"llama3-8b/train_small/single": ref_rec})
    assert report.fmt_table(results).splitlines() == \
        ref_report.fmt_table(ref_results).splitlines()
    port_lines = report.fmt_dryrun_table(results).splitlines()
    ref_lines = ref_report.fmt_dryrun_table(ref_results).splitlines()
    assert port_lines[0] == ref_lines[0].replace("fits 16GiB", "fits 80GiB")
    assert port_lines[1:] == ref_lines[1:]
    for floor in (False, True):
        got = report.roofline_fraction(rec, use_floor=floor)
        want = ref_report.roofline_fraction(ref_rec, use_floor=floor) * 197e12 / 989e12
        assert got == pytest.approx(want, rel=1e-12)
    assert report.roofline_fraction({}) is None
    frac = report.fmt_fraction_table(results, results).splitlines()
    assert len(frac) == 3 and frac[2].startswith("| llama3-8b/train_small |")
    path = tmp_path / "r.json"
    path.write_text(json.dumps(results))
    report.main([str(path), str(path)])
    printed = capsys.readouterr().out
    assert "| llama3-8b/train_small | 4 |" in printed and "Roofline fractions" in printed
