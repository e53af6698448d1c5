"""Each rank keeps its own share (faults 21-23): the embedding table's rows,
the mLSTM's inner width and the FSDP cells' logits, on meshes where the
faults showed, and the recorder's names for the storages the backward makes.

Traced on fake CPU ranks (``launch.dryrun.lower_cell`` with
``StepRecorder(holders=True)``), every storage the step made, forward and
backward (``Trace.made``), is held:
- fault 22: recurrentgemma-2b's smoke decode and smollm-135m's smoke
  training step on (2, 4) make no storage larger than the table's shard
  (V/4, D), and the decode moves fewer collective bytes than that shard.
  Before, every rank gathered the whole (V, D) table (and made its whole
  gradient in the backward);
- fault 21: xlstm-1.3b's smoke training step on (2, 8), its 4 heads on a
  model axis of 8: no storage of the mLSTM block (the up projection, the
  conv, the head products, the group norm, the gate and the down
  projection) holds a rank's batch at the whole inner width, but for the
  head products' transient gather of xc and xi (``_gathered_heads``) and
  the parallel form's keys (fault 18). Before, the up projection's
  ``torch.chunk`` gathered (B/2, S, 2·di) and the group norm ran on
  (B/2, S, NH, dh);
- fault 23: mistral-nemo-12b's smoke training step with FSDP on (2, 4),
  B 8, S 64 (the smallest geometry that showed it): no storage of the
  logits' product is larger than a rank's (B/2, S, V/4) share. Before,
  ``DTensor``'s planner, given S over "model" and the head's D over
  "data", made the product at the global batch on every rank (at the
  cell's widths the global (B·S, V), 256 GiB a rank: too slow a trace for
  tier 1);
- the recorder names each storage the backward makes by the forward
  frames of the node that made it, not by the training step's call to
  ``torch.autograd.grad`` (which hid faults 19 and 23).

Held by value on one job of 4 gloo ranks on (2, 2), each rank a ``python
-c`` process that imports this module (no JAX), as ``DTensor``s: the
vocabulary-parallel lookup (``lm._embed``) of a decode's tokens and of a
training batch, the table's V over "model" (and its D over "data" as FSDP
lays it out), forward and the table's gradient; the mLSTM block
(``xlstm.mlstm_block_forward``) at 3 heads, which the model axis of 2 does
not divide, so its parallel form and tail run on row blocks, forward and
every gradient; smollm-135m's training loss under remat with S whole in
the activation's layout, each repeat's input kept split along S. Each
against the same computation on one process and against the reference's
(``jax.grad``) on the same inputs: outputs within 1e-5 of their largest
|value| (the loss within 2e-4) and each gradient leaf within 1e-4 of its
largest |g| (``tests/test_torch_dryrun_share.py``'s bounds).
"""

import dataclasses
import functools
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.shardings import plan_for
from repro_torch.roofline.trace import fake_world
from test_torch_dryrun_share import (GRAD_REL, LOSS_TOL, OUT_REL, WAIT_S, _env, _full,
                                     _objective_grads, _out_share, _worst_share)

# the gloo job's mesh: data 2 over model 2
VALUE_MESH = (2, 2)
# the lookup: V rows of width D, B sequences of S tokens
V, D, B, S = 64, 16, 4, 8
# the mLSTM block: 3 heads of 32 channels (di 96), which 2 model ranks do
# not divide
MLSTM = {"d_model": 48, "n_heads": 3}
MB, MS = 4, 32


def _mlstm_cfg():
    return dataclasses.replace(smoke_config("xlstm-1.3b"), **MLSTM)


# a training step under remat: smollm-135m's smoke config, whose repeats'
# inputs the checkpoint keeps split along S (B sequences of RS tokens)
RS = 16


def _remat_cfg():
    return dataclasses.replace(smoke_config("smollm-135m"), remat=True)


def _inputs():
    """The numpy inputs of the value cases: the table, a training batch's
    and a decode's tokens; the mLSTM block's weights (the port's seed-0
    init, by name) and x; each case's objective weights."""
    from repro_torch.models import xlstm

    rng = np.random.default_rng(0)

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    embed = {"table": f32(V, D), "tok_train": rng.integers(0, V, (B, S)).astype(np.int64),
             "tok_decode": rng.integers(0, V, (B,)).astype(np.int64),
             "w_train": f32(B, S, D), "w_decode": f32(B, D)}
    cfg = _mlstm_cfg()
    di, nh = cfg.d_inner_xlstm, cfg.n_heads
    p = xlstm.init_mlstm_block(torch.Generator().manual_seed(0), cfg)
    mlstm = {"params": {k: v.numpy() for k, v in p.items()}, "x": f32(MB, MS, cfg.d_model),
             "w_out": f32(MB, MS, cfg.d_model), "w_conv": f32(MB, 3, di),
             "w_c": f32(MB, nh, di // nh, di // nh), "w_n": f32(MB, nh, di // nh)}
    from repro_torch.convert import tree_flatten_with_paths
    from repro_torch.models import lm
    from repro_torch.models.layers import DEFAULT_PLAN

    rcfg = _remat_cfg()
    params = lm.init_params(torch.Generator().manual_seed(0), rcfg, DEFAULT_PLAN, device="cpu")
    remat = {"params": {p: x.numpy() for p, x in tree_flatten_with_paths(params)},
             "tokens": rng.integers(0, rcfg.vocab, size=(B, RS)).astype(np.int32)}
    return {"embed": embed, "mlstm": mlstm, "remat": remat}


_REF = r"""
import os, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.models import xlstm

work = sys.argv[1]
with open(os.path.join(work, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
res = {}
e = {k: jnp.asarray(v) for k, v in inp["embed"].items()}
for case, tok, w in (("embed_train", e["tok_train"], e["w_train"]),
                     ("embed_decode", e["tok_decode"], e["w_decode"])):
    def look(table):
        rows = table[tok]
        return jnp.sum(rows * w), (rows,)
    (val, outs), g = jax.value_and_grad(look, has_aux=True)(e["table"])
    res[case] = {"outs": [np.asarray(o) for o in outs], "grads": [("table", np.asarray(g))]}
res["embed_fsdp"] = res["embed_train"]

m = inp["mlstm"]
names = list(m["params"])
def block(params, x):
    out, st = xlstm.mlstm_block_forward(params, x)
    val = (jnp.sum(out * m["w_out"]) + jnp.sum(st["conv"] * m["w_conv"])
           + jnp.sum(st["C"] * m["w_c"]) + jnp.sum(st["n"] * m["w_n"]))
    return val, (out, st["conv"], st["C"], st["n"], st["m"])
(val, outs), (gp, gx) = jax.value_and_grad(block, argnums=(0, 1), has_aux=True)(
    {k: jnp.asarray(v) for k, v in m["params"].items()}, jnp.asarray(m["x"]))
res["mlstm"] = {"outs": [np.asarray(o) for o in outs],
                "grads": [(n, np.asarray(gp[n])) for n in names] + [("x", np.asarray(gx))]}
import dataclasses
from repro import models as M
from repro.checkpoint.manager import _flatten_with_paths
from repro.configs import smoke_config
cfg = dataclasses.replace(smoke_config("smollm-135m"), remat=True)
paths, _, treedef = _flatten_with_paths(M.init_params(jax.random.PRNGKey(0), cfg))
params = jax.tree_util.tree_unflatten(
    treedef, [jnp.asarray(inp["remat"]["params"][p]) for p in paths])
loss, g = jax.jit(jax.value_and_grad(lambda p, b: M.loss_fn(p, b, cfg)[0]))(
    params, {"tokens": jnp.asarray(inp["remat"]["tokens"])})
gp, gl, _ = _flatten_with_paths(g)
res["remat"] = {"outs": [np.asarray(loss)], "grads": list(zip(gp, (np.asarray(x) for x in gl)))}
with open(os.path.join(work, "ref.pkl"), "wb") as f:
    pickle.dump(res, f)
"""


# ---------------------------------------------------------------------------
# the gloo ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, init: str, work: str) -> None:
    import datetime

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.convert import tree_flatten_with_paths, tree_unflatten
    from repro_torch.launch.shardings import constrainer_ctx, shard_tree, shardings_for
    from repro_torch.models import lm, xlstm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=WAIT_S))
    try:
        with open(os.path.join(work, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = mesh_mod.make_host_mesh(*VALUE_MESH, device_type="cpu")
        batch, rep = [Shard(0), Replicate()], [Replicate()] * 2
        out = {}

        # the lookup: the table's V over "model" (spec_embed), its D over
        # "data" too under FSDP; the tokens and the objective's weights as
        # the batch lies (over "data")
        e = {k: torch.from_numpy(v) for k, v in inp["embed"].items()}
        for case, tok, w, table_pl in (
                ("embed_train", e["tok_train"], e["w_train"], [Replicate(), Shard(0)]),
                ("embed_decode", e["tok_decode"], e["w_decode"], [Replicate(), Shard(0)]),
                ("embed_fsdp", e["tok_train"], e["w_train"], [Shard(1), Shard(0)])):
            dist_tok, dist_w = (distribute_tensor(x, mesh, batch) for x in (tok, w))

            def look(table, tok=tok, w=w, dist_tok=dist_tok, dist_w=dist_w):
                sharded = hasattr(table, "placements")
                rows = lm._embed(table, dist_tok if sharded else tok)
                return torch.sum(rows * (dist_w if sharded else w)), (rows,)

            out[case] = _objective_grads(look, ["table"], [e["table"]],
                                         [distribute_tensor(e["table"], mesh, table_pl)])

        # the mLSTM block: its weights as its spec lays them out, x as an
        # activation (batch over "data"); the objective over its output and
        # its recurrent state
        m = inp["mlstm"]
        cfg = _mlstm_cfg()
        names = list(m["params"])
        params = {k: torch.from_numpy(v) for k, v in m["params"].items()}
        specs = xlstm.spec_mlstm_block(cfg, plan_for(cfg, mesh))
        p_sh = shard_tree(params, shardings_for(specs, params, mesh))
        x = torch.from_numpy(m["x"])
        ws = {k: torch.from_numpy(m[k]) for k in ("w_out", "w_conv", "w_c", "w_n")}
        dist_ws = {k: distribute_tensor(v, mesh, rep) for k, v in ws.items()}

        def block(*a):
            sharded = hasattr(a[-1], "placements")
            w = dist_ws if sharded else ws
            with implicit_replication():    # the conv's zero state, as the dry run runs it
                o, st = xlstm.mlstm_block_forward(dict(zip(names, a[:-1])), a[-1])
            val = (torch.sum(o * w["w_out"]) + torch.sum(st["conv"] * w["w_conv"])
                   + torch.sum(st["C"] * w["w_c"]) + torch.sum(st["n"] * w["w_n"]))
            return val, (o, st["conv"], st["C"], st["n"], st["m"])

        out["mlstm"] = _objective_grads(
            block, names + ["x"], [params[n] for n in names] + [x],
            [p_sh[n] for n in names] + [distribute_tensor(x, mesh, batch)])
        # smollm-135m's training loss under remat, S whole in the activation's
        # layout (as on torch 2.11 and a multi-pod mesh): each repeat's input
        # kept split along S
        rcfg = _remat_cfg()
        plan = plan_for(rcfg, mesh)
        like = lm.init_params(torch.Generator().manual_seed(0), rcfg, plan, device="cpu")
        paths = [p for p, _ in tree_flatten_with_paths(like)]
        params = tree_unflatten(like, [torch.from_numpy(inp["remat"]["params"][p])
                                       for p in paths])
        tb = {"tokens": torch.from_numpy(inp["remat"]["tokens"])}
        p_sh = shard_tree(params, shardings_for(lm.param_specs(rcfg, plan), params, mesh))
        b_sh = {"tokens": distribute_tensor(tb["tokens"], mesh, batch)}
        res = []
        for p_, b_, sharded in ((params, tb, False), (p_sh, b_sh, True)):
            live = [x.detach().requires_grad_(True) for _, x in tree_flatten_with_paths(p_)]
            with constrainer_ctx(mesh if sharded else None, plan, seq_shard=False), \
                    implicit_replication():
                loss, _ = lm.loss_fn(tree_unflatten(p_, live), b_, rcfg, plan)
                gs = torch.autograd.grad(loss, live, allow_unused=True)
            res.append(([_full(loss).detach().numpy()],
                        [(p, None if g is None else _full(g).numpy())
                         for p, g in zip(paths, gs)]))
        out["remat"] = res
        if rank == 0:
            with open(os.path.join(work, "port.tmp"), "wb") as f:
                pickle.dump(out, f)
            os.replace(os.path.join(work, "port.tmp"), os.path.join(work, "port.pkl"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def jobs(tmp_path_factory):
    """The reference subprocess and the gloo ranks on the same inputs,
    started before this module's first test; the traces run while they
    work."""
    work = str(tmp_path_factory.mktemp("share2"))
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(_inputs(), f)
    procs = [subprocess.Popen([sys.executable, "-c", _REF, work], env=_env(1),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    world = VALUE_MESH[0] * VALUE_MESH[1]
    code = ("import sys, test_torch_dryrun_share2 as t; t._rank_main(int(sys.argv[1]), "
            "int(sys.argv[2]), sys.argv[3], sys.argv[4])")
    procs += [subprocess.Popen([sys.executable, "-c", code, str(r), str(world),
                                os.path.join(work, "init"), work], env=_env(),
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for r in range(world)]
    state = {"work": work, "procs": procs, "results": None}
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture
def results(jobs):
    """The reference's and the port's results (waited for)."""
    if jobs["results"] is None:
        logs = []
        for p in jobs["procs"]:
            try:
                log, _ = p.communicate(timeout=2 * WAIT_S)
            except subprocess.TimeoutExpired:
                for q in jobs["procs"]:
                    q.kill()
                raise
            logs.append(log)
        for i, p in enumerate(jobs["procs"]):
            assert p.returncode == 0, f"process {i}: {logs[i][-3000:]}"
        loaded = []
        for name in ("ref.pkl", "port.pkl"):
            with open(os.path.join(jobs["work"], name), "rb") as f:
                loaded.append(pickle.load(f))
        jobs["results"] = tuple(loaded)
    return jobs["results"]


# ---------------------------------------------------------------------------
# the traces on fake ranks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _trace(arch, kind, seq, batch, mesh, fsdp=False):
    """Rank 0's trace of one step of ``arch``'s smoke config, with each
    storage's provenance (``fsdp``: the plan's parameters sharded over
    "data", as ``plan_for`` lays out a model of 10B parameters)."""
    cfg = smoke_config(arch)
    with fake_world(mesh[0] * mesh[1]):
        dmesh = mesh_mod.make_host_mesh(*mesh, device_type="cpu")
        plan = dataclasses.replace(plan_for(cfg, dmesh), fsdp=fsdp)
        tr = dryrun.lower_cell(cfg, ShapeConfig("share2", seq, batch, kind), dmesh, plan,
                               holders=True)
    return cfg, tr


def _names(h):
    return [f.split()[-1] for f in h.frames]


def test_decode_looks_up_its_table_shard_fault22():
    """recurrentgemma-2b's smoke decode on (2, 4): no storage the step makes
    is larger than the bf16 table's (V/4, D) shard, and its collectives
    move fewer bytes than that shard. Before, each rank gathered the whole
    (V, D) table (4 shards, and 3 of them over the wire)."""
    dp, tp = 2, 4
    cfg, tr = _trace("recurrentgemma-2b", "decode", 64, 8, (dp, tp))
    shard = cfg.vocab // tp * cfg.d_model * 2
    worst = max(tr.made, key=lambda h: h.nbytes)
    moved = sum(b for _, b in tr.collectives)
    print("largest", worst, "collective bytes", moved, "table shard", shard)
    assert worst.nbytes <= shard, (worst, shard)
    assert moved < shard, (moved, shard)


def test_training_looks_up_its_table_shard_fault22():
    """smollm-135m's smoke training step on (2, 4) (its table tied to the
    head): no storage the step makes, forward or backward, is larger than
    the float32 table's (V/4, D) shard. Before, the forward gathered the
    whole bf16 table and the backward made its whole gradient."""
    dp, tp = 2, 4
    cfg, tr = _trace("smollm-135m", "train", 16, 8, (dp, tp))
    shard = cfg.vocab // tp * cfg.d_model * 4
    worst = max(tr.made, key=lambda h: h.nbytes)
    print("largest", worst, "table shard", shard)
    assert worst.nbytes <= shard, (worst, shard)


# the mLSTM block's own code, and the storages it may hold whole: the head
# products' transient gather (and its gradient before the reduce-scatter),
# the parallel form's keys and final state (fault 18), the sLSTM's norm
_MLSTM_CODE = {"_mlstm_qkvif", "_up_halves", "_head_products", "mlstm_block_forward",
               "_mlstm_out", "_group_norm", "<lambda>"}
_MLSTM_WHOLE_OK = {"mlstm_parallel", "mlstm_final_state", "_mlstm_parallel_shards",
                   "_mlstm_final_state_shards", "slstm_forward"}


def test_mlstm_inner_width_at_its_share_fault21():
    """xlstm-1.3b's smoke training step on (2, 8), 4 heads on a model axis
    of 8: no storage made by the mLSTM block's code, forward or backward,
    holds a rank's batch at the whole inner width, (B/2) x S x di elements
    or more (the weights, gathered whole, are smaller at this size), but
    for the head products' transient gather (``_gathered_heads``) and the
    parallel form's keys. Before, ``torch.chunk`` of the up projection
    made (B/2, S, 2·di) and the group norm (B/2, S, NH, dh) float32."""
    dp, tp = 2, 8
    b, s = 8, 128
    cfg, tr = _trace("xlstm-1.3b", "train", s, b, (dp, tp))
    whole = b // dp * s * cfg.d_inner_xlstm
    mine = [h for h in tr.made
            if any(f.startswith("models/xlstm.py") and f.split()[-1] in _MLSTM_CODE
                   for f in h.frames[:4])
            and not any(n in _MLSTM_WHOLE_OK or n.startswith("_gathered_heads")
                        for n in _names(h))]
    assert mine
    worst = max(mine, key=lambda h: math.prod(h.shape))
    print("largest", worst, "whole inner width", whole)
    assert math.prod(worst.shape) < whole, (worst, whole)


def test_fsdp_logits_at_their_share_fault23():
    """mistral-nemo-12b's smoke training step with FSDP on (2, 4), B 8, S
    64: no storage of the logits' product (made in ``lm._logits``, forward
    or backward) has more elements than a rank's (B/2, S, V/4) share.
    Before, the product held the global batch on every rank."""
    dp, tp = 2, 4
    b, s = 8, 64
    cfg, tr = _trace("mistral-nemo-12b", "train", s, b, (dp, tp), fsdp=True)
    share = b // dp * s * cfg.vocab // tp
    made = [h for h in tr.made if "_logits" in _names(h)]
    assert made
    worst = max(made, key=lambda h: math.prod(h.shape))
    print("largest", worst, "share", share)
    assert math.prod(worst.shape) <= share, (worst, share)


def test_backward_storages_named_by_their_forward_frames():
    """The recorder names a storage the backward makes by the autograd
    node that made it and that node's forward frames (smollm-135m's smoke
    training step on (2, 4)): none is named by the training step's call
    to ``torch.autograd.grad`` alone, and the embedding's gradient is named
    by ``lm._embed``. Before, every one was ``train_step.py
    loss_and_grads``."""
    _, tr = _trace("smollm-135m", "train", 16, 8, (2, 4))
    back = [h for h in tr.made if h.backward is not None]
    assert back
    unnamed = [h for h in back if not h.frames or h.frames[0].endswith(" loss_and_grads")]
    assert not unnamed, unnamed[:5]
    assert any("_embed" in _names(h) for h in back)


# ---------------------------------------------------------------------------
# the values on gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["embed_train", "embed_decode", "embed_fsdp", "mlstm",
                                  "remat"])
def test_sharded_values_and_grads_match_one_process_and_reference(results, case):
    """On (2, 2) gloo ranks, as ``DTensor``s: the vocabulary-parallel
    lookup of a training batch's and a decode's tokens (the table's V over
    "model", and its D over "data" as FSDP lays it out), the mLSTM block
    at 3 heads (its parallel form and tail on row blocks), and smollm-135m's
    training loss under remat with S whole in the activation's layout (each
    repeat's kept input split along S): the outputs within 1e-5 of their
    largest |value| (the loss within 2e-4) and each gradient leaf within
    1e-4 of its largest |g|, against the port's one process and against
    the reference (``jax.grad`` on the same inputs)."""
    ref, port = results
    (out_one, g_one), (out_sh, g_sh) = port[case]
    r = ref[case]
    shares = {"out_one": _out_share(out_sh, out_one), "out_ref": _out_share(out_sh, r["outs"]),
              "grad_one": _worst_share(g_sh, g_one), "grad_ref": _worst_share(g_sh, r["grads"])}
    print(case, shares)
    if case == "remat":
        assert abs(float(out_sh[0]) - float(out_one[0])) < LOSS_TOL
        assert abs(float(out_sh[0]) - float(r["outs"][0])) < LOSS_TOL
    else:
        assert shares["out_one"] <= OUT_REL and shares["out_ref"] <= OUT_REL, shares
    assert shares["grad_one"] < GRAD_REL and shares["grad_ref"] < GRAD_REL, shares
