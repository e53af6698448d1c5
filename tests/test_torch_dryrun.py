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
import subprocess
import sys

import pytest
import torch

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
         "decode_b1": ShapeConfig("decode_b1", 16, 1, "decode")}
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
FAULT_CELLS = (("xlstm-1.3b", "decode", (1, 8)), ("xlstm-1.3b", "train", (1, 8)),
               ("recurrentgemma-2b", "decode_b1", (2, 2)))


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
for arch, kind, shp in json.loads(sys.argv[3]):
    mesh = Mesh(np.array(devices[:shp[0] * shp[1]]).reshape(shp), ("data", "model"))
    cfg, shape = smoke_config(arch), small[kind]
    plan = plan_for(cfg, mesh)
    ma = D.lower_cell(cfg, shape, mesh, plan).compile().memory_analysis()
    pts = []
    for mult in ((1, 2) if shp == [2, 2] else ()):
        rcfg = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern) * mult,
                                   unroll_layers=True)
        cp = cost_point(D.lower_cell(rcfg, shape, mesh, plan).compile())
        pts.append({"flops": cp["flops"],
                    "slstm": D.slstm_flops_correction(rcfg, shape, rcfg.n_layers, 4)})
    res[f"{arch}/{kind}"] = {"plan": {"tp": plan.tp, "fsdp": plan.fsdp},
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
    cells = [(a, k, (2, 2)) for a, k in CELLS] + list(FAULT_CELLS)
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
                port[f"{arch}/{kind}"] = {"plan": {"tp": plan.tp, "fsdp": plan.fsdp},
                                          "full": pts[cfg.n_layers // pat - 1], "points": pts}
        for arch, kind, shp in FAULT_CELLS:
            with fake_world(shp[0] * shp[1]):
                mesh = mesh_mod.make_host_mesh(*shp, device_type="cpu")
                cfg = smoke_config(arch)
                plan = plan_for(cfg, mesh)
                port[f"{arch}/{kind}"] = {"plan": {"tp": plan.tp, "fsdp": plan.fsdp},
                                          "full": dryrun.lower_cell(cfg, SMALL[kind], mesh, plan)}
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-3000:]
    return json.loads(out.read_text()), port


@pytest.mark.parametrize("arch,kind", CELLS)
def test_bytes_and_plan_match_reference(against_reference, arch, kind):
    """The plan and the argument and output bytes per device equal the
    reference's compiled program's (the output's tuple table aside)."""
    ref, port = against_reference
    r, p = ref[f"{arch}/{kind}"], port[f"{arch}/{kind}"]
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
    r, p = ref[f"{arch}/{kind}"], port[f"{arch}/{kind}"]
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
    for mult, r, p in zip((1, 2), ref[f"{arch}/{kind}"]["points"],
                          port[f"{arch}/{kind}"]["points"]):
        n = len(cfg.block_pattern) * mult
        assert dryrun.slstm_flops_correction(
            dataclasses.replace(cfg, n_layers=n), SMALL[kind], n, 4) == r["slstm"]
        want = r["flops"] + r["slstm"]
        assert FLOPS_FLOOR[(arch, kind)] * want <= p.flops <= want, (p.flops, want)


def test_replicate_detours_are_counted(against_reference):
    """The MoE dispatch (qwen3-moe) and xLSTM's logsigmoid run through
    ``sharding_ctx.replicated``, whose all-gathers GSPMD would not make.
    They are counted in the trace as the port runs them (printed
    with -s: their share of the collective bytes); llama3-8b has none."""
    _, port = against_reference
    for key in ("qwen3-moe-235b-a22b/train", "xlstm-1.3b/prefill", "llama3-8b/train"):
        tr = port[key]["full"]
        det = analysis.collective_bytes(dataclasses.replace(tr, collectives=tr.detour_collectives))
        total = analysis.collective_bytes(tr)
        print(key, "detours:", det["counts"], det["total"], "of", total["total"], "bytes")
        assert all(c in tr.collectives for c in tr.detour_collectives)
        assert (det["total"] > 0) == (not key.startswith("llama3-8b"))


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
    meshes cut to (2, 2) and (1, 1, 1), with fake CPU tensors. (On a 3-D
    mesh of more than one rank DTensor's redistribution planner takes
    minutes a step here.)"""
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
    that are done and retries the one that failed."""
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
    assert seen[0][1] == {"do_roofline": True, "cache_dtype_name": "int8", "moe_a2a": True,
                          "xlstm_chunk": 16}
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
