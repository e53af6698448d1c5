"""Each rank computes only its own share (faults 17-20): the RG-LRU's scan,
the mLSTM's parallel form, the LM loss's (B, S, V) tensors and pixtral's
attention, on meshes where the faults showed (a model axis wider than the
smoke heads, a data axis above 1).

Traced on fake CPU ranks (``launch.dryrun.lower_cell`` with the recorder
keeping each storage's provenance, ``StepRecorder(holders=True)``): no
tensor made inside the scan, the pair matrices, the loss or the attention
is larger than its rank's shard of the global tensor, and pixtral's
attention never falls back to running whole on ``DTensor``s
(``Trace.local_fallbacks``). Before the repairs each of those held a
dimension at its global size on every rank (the scan's interleave at the
global batch and width, the pair matrices at every query row, the loss's
one-hot at the whole vocabulary, pixtral's accumulator at the global batch
and every head).

Held by value on one job of 4 gloo ranks on (2, 2), each rank a
``python -c`` process that imports this module (no JAX), as ``DTensor``s:
the RG-LRU's scan; the mLSTM's parallel form on blocks of query rows and
its final state on shares of the key width (3 heads, which the model axis
of 2 does not divide); pixtral's ``loss_fn`` one layer deep (its first
attention after the image positions, its loss over a vocabulary split 2
ways). Each against the same computation on one process and against the
reference's (``jax.grad``) on the same inputs: outputs within 1e-5 of
their largest |value|, the loss within 2e-4 and each gradient leaf within
1e-4 of its largest |g| (the bounds of ``tests/test_torch_distributed.py``
and ``tests/test_torch_lm_grads.py``).

One reference subprocess (16 forced CPU devices, compiled with
``--xla_cpu_max_isa=AVX`` as the other reference jobs are) writes the
weights first, which the ranks wait for, then its loss and gradients, and
the per-device flops of the xlstm smoke prefill's 1x roofline point on a
(2, 8) ("data", "model") ``Auto`` mesh, which the port's rank 0 must not
exceed there (its pair products were whole on every model rank).
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.shardings import plan_for
from repro_torch.roofline.trace import fake_world

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

# the gloo job's mesh: data 2 over model 2
VALUE_MESH = (2, 2)
# the ops' sizes: RG-LRU width D; the mLSTM's heads (3, which the model
# axis of 2 does not divide, so its query rows are split) of width DH;
# B sequences of S positions
B, S, D, NH, DH = 4, 24, 64, 3, 16
# pixtral's smoke config one layer deep (its image positions, then text)
PIXTRAL = {"n_layers": 1}
OUT_REL = 1e-5      # an op's output, of its largest |value|
LOSS_TOL = 2e-4     # test_torch_distributed.py's sharded-step bound
GRAD_REL = 1e-4     # of a leaf's largest |g| (test_torch_lm_grads.py, _distributed.py)
ROUNDING, FLOOR = 1e-6, 1e-2   # test_torch_lm_grads.py's rule for rounding-level leaves
# the flops cell: the xlstm smoke prefill's 1x point (its 8-block pattern)
FLOPS_MESH = (2, 8)
FLOPS_SHAPE = ShapeConfig("prefill_small", 16, 8, "prefill")
WAIT_S = 300


def _env(n_devices=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + HERE + os.pathsep + env.get("PYTHONPATH", "")
    if n_devices is not None:
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={n_devices} "
                            "--xla_cpu_max_isa=AVX")
        env["JAX_PLATFORMS"] = "cpu"
    return env


def _inputs():
    """The numpy inputs of the three value cases: the RG-LRU's gate
    weights, x and h0; the mLSTM's q, k, v and gates; pixtral's weights
    (the port's seed-0 init, by path) and batch; each case's objective
    weights (a fixed random weighting of the outputs, summed)."""
    from repro_torch.convert import tree_flatten_with_paths
    from repro_torch.models import lm
    from repro_torch.models.layers import DEFAULT_PLAN

    rng = np.random.default_rng(0)

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    rglru = {"wa": f32(D, D, scale=D ** -0.5), "wxg": f32(D, D, scale=D ** -0.5),
             "ba": f32(D, scale=0.1), "bxg": f32(D, scale=0.1),
             "lam": (2.0 + 4.0 * rng.uniform(size=D)).astype(np.float32),
             "xc": f32(B, S, D), "h0": f32(B, D), "w_h": f32(B, S, D), "w_last": f32(B, D)}
    mlstm = {"q": f32(B, S, NH, DH), "k": f32(B, S, NH, DH), "v": f32(B, S, NH, DH),
             "i_raw": f32(B, S, NH), "f_raw": f32(B, S, NH, scale=2.0),
             "w_h": f32(B, S, NH, DH), "w_c": f32(B, NH, DH, DH), "w_n": f32(B, NH, DH)}
    cfg = dataclasses.replace(smoke_config("pixtral-12b"), **PIXTRAL)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, DEFAULT_PLAN, device="cpu")
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32),
             "image_embeds": f32(B, cfg.n_image_tokens, 1024)}
    pixtral = {"params": {p: x.numpy() for p, x in tree_flatten_with_paths(params)},
               "batch": batch}
    return {"rglru": rglru, "mlstm_rows": mlstm, "pixtral": pixtral}


_REF = r"""
import dataclasses, json, os, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
devices = jax.devices()
import repro.launch.dryrun as D
from repro import models as M
from repro.checkpoint.manager import _flatten_with_paths
from repro.configs import smoke_config
from repro.configs.base import ShapeConfig
from repro.launch.shardings import plan_for
from repro.models import rglru, xlstm
from repro.roofline.analysis import cost_point

work, pixtral_repl = sys.argv[1], json.loads(sys.argv[2])
flops_mesh, flops_shape = json.loads(sys.argv[3]), ShapeConfig(*json.loads(sys.argv[4]))
with open(os.path.join(work, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
res = {}

# the RG-LRU's scan: h and h_last against fixed weights
r = {k: jnp.asarray(v) for k, v in inp["rglru"].items()}
names = ["xc", "h0", "wa", "ba", "wxg", "bxg", "lam"]
def rg(*a):
    kw = dict(zip(names, a))
    h, last = rglru.rglru_scan({k: kw[k] for k in ("wa", "ba", "wxg", "bxg", "lam")},
                               kw["xc"], kw["h0"])
    return jnp.sum(h * r["w_h"]) + jnp.sum(last * r["w_last"]), (h, last)
(val, outs), g = jax.value_and_grad(rg, argnums=tuple(range(len(names))), has_aux=True)(
    *[r[n] for n in names])
res["rglru"] = {"outs": [np.asarray(o) for o in outs],
                "grads": [(n, np.asarray(x)) for n, x in zip(names, g)]}

# the mLSTM's parallel form and final state
m = {k: jnp.asarray(v) for k, v in inp["mlstm_rows"].items()}
names = ["q", "k", "v", "i_raw", "f_raw"]
def ml(*a):
    h = xlstm.mlstm_parallel(*a)
    st = xlstm.mlstm_final_state(*a[1:])
    return (jnp.sum(h * m["w_h"]) + jnp.sum(st["C"] * m["w_c"]) + jnp.sum(st["n"] * m["w_n"]),
            (h, st["C"], st["n"], st["m"]))
(val, outs), g = jax.value_and_grad(ml, argnums=tuple(range(len(names))), has_aux=True)(
    *[m[n] for n in names])
res["mlstm_rows"] = {"outs": [np.asarray(o) for o in outs],
                     "grads": [(n, np.asarray(x)) for n, x in zip(names, g)]}

# pixtral one layer deep: loss_fn on the port's weights
cfg = dataclasses.replace(smoke_config("pixtral-12b"), **pixtral_repl)
paths, _, treedef = _flatten_with_paths(M.init_params(jax.random.PRNGKey(0), cfg))
params = jax.tree_util.tree_unflatten(
    treedef, [jnp.asarray(inp["pixtral"]["params"][p]) for p in paths])
batch = {k: jnp.asarray(v) for k, v in inp["pixtral"]["batch"].items()}
loss, g = jax.jit(jax.value_and_grad(lambda p, b: M.loss_fn(p, b, cfg)[0]))(params, batch)
gp, gl, _ = _flatten_with_paths(g)
res["pixtral"] = {"outs": [np.asarray(loss)], "grads": list(zip(gp, (np.asarray(x) for x in gl)))}

# the per-device flops of the xlstm smoke prefill's 1x point
n = int(np.prod(flops_mesh))
mesh = Mesh(np.array(devices[:n]).reshape(flops_mesh), ("data", "model"))
cfg = smoke_config("xlstm-1.3b")
plan = plan_for(cfg, mesh)
rcfg = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern), unroll_layers=True)
res["flops"] = {"flops": cost_point(D.lower_cell(rcfg, flops_shape, mesh, plan).compile())["flops"],
                "slstm": D.slstm_flops_correction(rcfg, flops_shape, rcfg.n_layers, n)}
with open(os.path.join(work, "ref.pkl"), "wb") as f:
    pickle.dump(res, f)
"""


# ---------------------------------------------------------------------------
# the gloo ranks
# ---------------------------------------------------------------------------

def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _objective_grads(fn, names, args, dist_args):
    """``fn``'s (objective, outputs) and the objective's gradients by
    autograd, on plain ``args`` and on ``dist_args`` (their ``DTensor``s):
    full tensors of each, as numpy."""
    res = []
    for a in (args, dist_args):
        live = [x.detach().requires_grad_(True) for x in a]
        val, outs = fn(*live)
        gs = torch.autograd.grad(val, live)
        res.append(([_full(o).detach().numpy() for o in outs],
                    [(n, _full(g).numpy()) for n, g in zip(names, gs)]))
    return res


def _rank_main(rank: int, world: int, init: str, work: str) -> None:
    import datetime

    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.convert import tree_flatten_with_paths, tree_unflatten
    from repro_torch.launch.shardings import (Sharding, constrainer_ctx, shard_tree,
                                              shardings_for)
    from repro_torch.models import lm, rglru, xlstm
    from repro_torch.models.sharding_ctx import P

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=WAIT_S))
    try:
        with open(os.path.join(work, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = mesh_mod.make_host_mesh(*VALUE_MESH, device_type="cpu")
        batch, col, rep = [Shard(0), Replicate()], [Replicate(), Shard(1)], [Replicate()] * 2
        out = {}

        # the RG-LRU's scan: x as an activation (batch over "data"), the gate
        # weights' columns and biases over "model", h0 as its state's spec
        r = {k: torch.from_numpy(v) for k, v in inp["rglru"].items()}
        names = ["xc", "h0", "wa", "ba", "wxg", "bxg", "lam"]
        layout = {"xc": batch, "h0": [Shard(0), Shard(1)], "wa": col, "wxg": col,
                  "ba": [Replicate(), Shard(0)], "bxg": [Replicate(), Shard(0)],
                  "lam": [Replicate(), Shard(0)]}

        plain_w = [r["w_h"], r["w_last"]]
        dist_w = [distribute_tensor(x, mesh, rep) for x in plain_w]

        def rg(xc, h0, *w):
            ws = dist_w if hasattr(xc, "placements") else plain_w
            h, last = rglru.rglru_scan(dict(zip(names[2:], w)), xc, h0)
            return torch.sum(h * ws[0]) + torch.sum(last * ws[1]), (h, last)

        out["rglru"] = _objective_grads(
            rg, names, [r[n] for n in names],
            [distribute_tensor(r[n], mesh, layout[n]) for n in names])

        # the mLSTM: q, k, v with their head width over "model", as the block's
        # products leave them; the gates' rows of batch shards
        m = {k: torch.from_numpy(v) for k, v in inp["mlstm_rows"].items()}
        names = ["q", "k", "v", "i_raw", "f_raw"]
        layout = {"q": [Shard(0), Shard(3)], "k": [Shard(0), Shard(3)],
                  "v": [Shard(0), Shard(3)], "i_raw": batch, "f_raw": batch}
        plain_w = [m["w_h"], m["w_c"], m["w_n"]]
        dist_w = [distribute_tensor(x, mesh, rep) for x in plain_w]

        def ml(*a):
            ws = dist_w if hasattr(a[0], "placements") else plain_w
            h = xlstm._mlstm_parallel_shards(*a)
            st = xlstm._mlstm_final_state_shards(*a[1:])
            return (torch.sum(h * ws[0]) + torch.sum(st["C"] * ws[1])
                    + torch.sum(st["n"] * ws[2]), (h, st["C"], st["n"], st["m"]))

        out["mlstm_rows"] = _objective_grads(
            ml, names, [m[n] for n in names],
            [distribute_tensor(m[n], mesh, layout[n]) for n in names])

        # pixtral one layer deep: loss_fn and its gradients
        cfg = dataclasses.replace(smoke_config("pixtral-12b"), **PIXTRAL)
        plan = plan_for(cfg, mesh)
        like = lm.init_params(torch.Generator().manual_seed(0), cfg, plan, device="cpu")
        flat = inp["pixtral"]["params"]
        paths = [p for p, _ in tree_flatten_with_paths(like)]
        params = tree_unflatten(like, [torch.from_numpy(flat[p]) for p in paths])
        b_np = inp["pixtral"]["batch"]
        tb = {k: torch.from_numpy(v) for k, v in b_np.items()}
        p_sh = shard_tree(params, shardings_for(lm.param_specs(cfg, plan), params, mesh))
        b_sh = shard_tree(tb, {k: Sharding(mesh, P("data", *[None] * (v.dim() - 1)))
                               for k, v in tb.items()})
        res = []
        for p_, b_, sharded in ((params, tb, False), (p_sh, b_sh, True)):
            live = [x.detach().requires_grad_(True) for _, x in tree_flatten_with_paths(p_)]
            with constrainer_ctx(mesh if sharded else None, plan), implicit_replication():
                loss, _ = lm.loss_fn(tree_unflatten(p_, live), b_, cfg, plan)
                gs = torch.autograd.grad(loss, live, allow_unused=True)
            res.append(([_full(loss).detach().numpy()],
                        [(p, None if g is None else _full(g).numpy())
                         for p, g in zip(paths, gs)]))
        out["pixtral"] = res
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
    work = str(tmp_path_factory.mktemp("share"))
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(_inputs(), f)
    flops_shape = [FLOPS_SHAPE.name, FLOPS_SHAPE.seq_len, FLOPS_SHAPE.global_batch,
                   FLOPS_SHAPE.kind]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REF, work, json.dumps(PIXTRAL), json.dumps(FLOPS_MESH),
         json.dumps(flops_shape)], env=_env(16), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)]
    world = VALUE_MESH[0] * VALUE_MESH[1]
    code = ("import sys, test_torch_dryrun_share as t; t._rank_main(int(sys.argv[1]), "
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

def _trace(arch, kind, seq, batch, mesh, repl=None):
    """Rank 0's trace of one step of ``arch``'s smoke config, with each
    storage's provenance."""
    cfg = dataclasses.replace(smoke_config(arch), **(repl or {}))
    with fake_world(mesh[0] * mesh[1]):
        dmesh = mesh_mod.make_host_mesh(*mesh, device_type="cpu")
        tr = dryrun.lower_cell(cfg, ShapeConfig("share", seq, batch, kind), dmesh,
                               plan_for(cfg, dmesh), holders=True)
    return cfg, tr


def _made_in(tr, functions):
    """The storages the step made whose innermost port frame is one of
    ``functions`` (``"file.py name"`` suffixes of the frame)."""
    return [h for h in tr.made
            if h.frames and any(h.frames[0].split(":")[0].endswith(f.split()[0])
                                and h.frames[0].endswith(" " + f.split()[1])
                                for f in functions)]


def _hold_shards(tr, functions, bound):
    made = _made_in(tr, functions)
    assert made, f"nothing made in {functions}"
    worst = max(made, key=lambda h: h.nbytes)
    print(functions, "largest", worst, "bound", bound)
    assert worst.nbytes <= bound, (worst, bound)


def test_rglru_scan_holds_its_shard_fault17():
    """The RG-LRU's scan on (2, 4): each rank scans its (B/2, S, D/4) shard
    of (log a, gated input); no tensor of the scan (its combine tree, the
    interleave, the first position's h0 term, the last position) is larger
    than that float32 shard. Before, the interleave made (B, S, D) on every
    rank (``new_empty`` on a ``DTensor`` is replicated)."""
    dp, tp = 2, 4
    b, s = 8, 64
    cfg, tr = _trace("recurrentgemma-2b", "prefill", s, b, (dp, tp))
    _hold_shards(tr, ("rglru.py _scan", "rglru.py associative_scan", "rglru.py _interleave",
                      "rglru.py _combine"), b * s * cfg.d_model * 4 // (dp * tp))


def test_mlstm_pair_matrices_hold_their_row_block_fault18():
    """The mLSTM's parallel form on (2, 8), its 4 heads on a model axis of
    8: each rank builds the pair matrices of its block of S/8 query rows
    against all S keys, (B/2, S/8, S, NH) float32, or the keys whole in
    float32 (B/2, S, NH, dh), whichever is larger. Before, every rank
    built them at every query row, (B/2, S, S, NH)."""
    dp, tp = 2, 8
    b, s = 4, 128
    cfg, tr = _trace("xlstm-1.3b", "prefill", s, b, (dp, tp))
    nh = cfg.n_heads
    di = int(cfg.d_model * cfg.xlstm_proj_factor)
    pairs = b * s * s * nh * 4 // (dp * tp)
    keys = b * s * di * 4 // dp
    _hold_shards(tr, ("xlstm.py mlstm_parallel",), max(pairs, keys))


def test_loss_tensors_keep_the_logits_layout_fault19():
    """The training loss on (2, 4): every (B, S, V) tensor of ``loss_fn``,
    forward and backward (the logits sliced and cast, the log-normaliser's
    exponent, the one-hot of the targets against the rank's own vocabulary
    ids, the gradient), is the logits' shard, B over "data" and V over
    "model": (B/2, S, V/4) float32. Before, the one-hot compared the
    targets with the whole vocabulary, and the gold logits' einsum gathered
    the global batch."""
    dp, tp = 2, 4
    b, s = 8, 32
    cfg, tr = _trace("smollm-135m", "train", s, b, (dp, tp))
    _hold_shards(tr, ("lm.py loss_fn", "lm.py _log_normaliser_and_gold", "lm.py forward",
                      "lm.py backward"),
                 b * s * cfg.vocab * 4 // (dp * tp))


def test_pixtral_attention_on_batch_and_head_shards_fault20():
    """pixtral's prefill on (2, 4): its embeddings (image positions then
    text) are laid out as an activation, so the first layer's q, k and v
    are (batch, head) shards and ``local_shards`` never falls back to
    running the attention whole on ``DTensor``s (0 fallbacks); no tensor of
    the attention is larger than its (B/2, H/4) shard of the accumulator
    or of a score chunk. Before, the adapter's column-sharded output left
    q a pending sum, and the attention held the global batch and every
    head."""
    dp, tp = 2, 4
    b, s = 8, 256
    cfg, tr = _trace("pixtral-12b", "prefill", s, b, (dp, tp))
    assert tr.local_fallbacks == 0
    h, dh = cfg.n_heads, cfg.head_dim
    acc = b * h * s * dh * 4 // (dp * tp)
    scores = b * h * s * min(s, 1024) * 4 // (dp * tp)
    _hold_shards(tr, ("attention.py _flash_attend",), max(acc, scores))


# ---------------------------------------------------------------------------
# the values on gloo ranks, and the flops against the reference
# ---------------------------------------------------------------------------

def _worst_share(got, want):
    """The worst leaf of ``got`` against ``want`` ([(name, array)] each), as
    a share of the leaf's largest |g| (a rounding-level leaf against the
    tree's, ``tests/test_torch_lm_grads.py``'s rule); no leaf may lose its
    gradient."""
    want = dict(want)
    assert [p for p, _ in got] == list(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    worst = 0.0
    for path, g in got:
        w = want[path]
        scale = float(np.abs(w).max())
        assert g is not None or scale == 0.0, f"{path} lost its gradient"
        g = np.zeros_like(w) if g is None else g
        scale = FLOOR * top if scale < ROUNDING * top else scale
        worst = max(worst, float(np.abs(g - w).max()) / scale)
    return worst


def _out_share(got, want):
    """The worst output of ``got`` against ``want``, as a share of its
    largest |value|."""
    return max(float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
               for g, w in zip(got, want))


@pytest.mark.parametrize("case", ["rglru", "mlstm_rows", "pixtral"])
def test_sharded_values_and_grads_match_one_process_and_reference(results, case):
    """On (2, 2) gloo ranks, as ``DTensor``s: the RG-LRU's scan (h and
    h_last), the mLSTM's parallel form on query-row blocks and its final
    state on key-width shards (3 heads on a model axis of 2), and pixtral's
    ``loss_fn`` one layer deep (its attention on (batch, head) shards, its
    loss over a vocabulary split 2 ways): the outputs within 1e-5 of their
    largest |value| (the loss within 2e-4) and each gradient leaf within
    1e-4 of its largest |g|, against the port's one process and against
    the reference (``jax.grad`` on the same inputs)."""
    ref, port = results
    (out_one, g_one), (out_sh, g_sh) = port[case]
    r = ref[case]
    shares = {"out_one": _out_share(out_sh, out_one), "out_ref": _out_share(out_sh, r["outs"]),
              "grad_one": _worst_share(g_sh, g_one), "grad_ref": _worst_share(g_sh, r["grads"])}
    print(case, shares)
    if case == "pixtral":
        assert abs(float(out_sh[0]) - float(out_one[0])) < LOSS_TOL
        assert abs(float(out_sh[0]) - float(r["outs"][0])) < LOSS_TOL
    else:
        assert shares["out_one"] <= OUT_REL and shares["out_ref"] <= OUT_REL, shares
    assert shares["grad_one"] < GRAD_REL and shares["grad_ref"] < GRAD_REL, shares


def test_xlstm_point_flops_within_reference_fault18(results):
    """The xlstm smoke prefill's 1x roofline point on (2, 8) fake ranks:
    rank 0's flops at most the reference's per-device HLO flops (plus its
    sLSTM correction) on the same (2, 8) mesh, as
    ``test_point_flops_bracketed_by_reference`` holds on (2, 2). Before,
    every model rank computed the mLSTM's pair products and final state
    whole, above the reference's count."""
    cfg = smoke_config("xlstm-1.3b")
    rcfg = dataclasses.replace(cfg, n_layers=len(cfg.block_pattern), unroll_layers=True)
    with fake_world(FLOPS_MESH[0] * FLOPS_MESH[1]):
        mesh = mesh_mod.make_host_mesh(*FLOPS_MESH, device_type="cpu")
        tr = dryrun.lower_cell(rcfg, FLOPS_SHAPE, mesh, plan_for(cfg, mesh))
    ref, _ = results
    want = ref["flops"]["flops"] + ref["flops"]["slstm"]
    print("port", tr.flops, "reference", want)
    assert 0 < tr.flops <= want


# ---------------------------------------------------------------------------
# states that would pin a layer's whole sequence
# ---------------------------------------------------------------------------

def _owns_storage(x):
    return x.untyped_storage().nbytes() == x.numel() * x.element_size()


@pytest.mark.parametrize("kind", ["rglru", "mlstm"])
def test_prefill_states_own_their_storage(kind):
    """A layer's prefill state on plain tensors is a copy, not a view of a
    sequence-long tensor: the RG-LRU's ``h_last`` (once ``h[:, -1]``,
    which kept the whole (B, S, D) scan alive in every layer's state) and
    the causal conv's state (once the last K-1 positions of the (B, S+3,
    D) concatenation; the mLSTM takes the same conv)."""
    from repro_torch.models import rglru, xlstm

    cfg = smoke_config("recurrentgemma-2b" if kind == "rglru" else "xlstm-1.3b")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 40, cfg.d_model, generator=g)
    if kind == "rglru":
        p = rglru.init_rglru_block(g, cfg)
        _, h_last = rglru.rglru_scan(p, x)
        assert h_last.shape == (2, cfg.d_model) and _owns_storage(h_last)
        _, state = rglru.recurrent_block_forward(p, x)
    else:
        _, state = xlstm.mlstm_block_forward(xlstm.init_mlstm_block(g, cfg), x)
    for name, leaf in state.items():
        assert _owns_storage(leaf), (name, tuple(leaf.shape),
                                     leaf.untyped_storage().nbytes())
