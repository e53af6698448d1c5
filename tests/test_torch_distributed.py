"""The port's process-group layer on gloo ranks (CPU) against the
reference's own sharded results: the (2, 2) sharded LM train step (llama3-8b,
and qwen3-moe through the all-to-all MoE), the GPipe pipeline, the
all-to-all MoE, the int8 compressed all-reduce and the elastic checkpoint
restore. Held against the port's one-process results: sharded serving on
(2, 2) with float32, bf16 and int8 caches, and xLSTM's train step,
gradients and serving on (1, 8), a model axis wider than its heads.

One JAX subprocess (``--xla_force_host_platform_device_count=8``) computes
every reference result on meshes built as ``jax.sharding.Mesh`` (their
axes are ``Auto``; ``jax.make_mesh`` makes ``Explicit`` axes under which
the reference's code does not run) and writes them to an ``.npz``. The
port then runs as one job of 4 gloo ranks and one of 8, side by side,
each rank a ``python -c`` process that imports no JAX, with a ``file://``
rendezvous under the test's temporary directory. Each rank runs all of
its cases; rank 0 writes the results the tests read.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

PIPE_CASES = {
    # name: (layers, width, microbatches, NaN-bubble stage_fn)
    "steady": (8, 16, 6, False),          # test_distributed.py:124
    "mostly_bubble": (4, 8, 2, False),    # :154, n_micro < n_stages
    "nan_bubble": (4, 8, 6, True),        # :178
}
MOE_CFG = dict(n_experts=8, top_k=2, d_expert=32, capacity_factor=2.0)
# a smoke config whose sharded step takes a Replicate() detour around an op
# DTensor has no rule for (the MoE dispatch's searchsorted), held against
# the port's one-process step
DETOUR_ARCHS = ("qwen3-moe-235b-a22b",)
# smoke configs served (prefill, then greedy decode steps) as DTensors on the
# (2, 2) mesh, held against the port's one-process serving: (arch, batch,
# prompt, decode steps). recurrentgemma's batch of 1 lies on 2 data ranks
# and its 72-token prompt overflows its 64-position window, so prefill rolls
# the local caches and decode wraps them; llama3-8b's caches are sharded
# over batch and kv heads
SERVE_CASES = (("recurrentgemma-2b", 1, 72, 6), ("llama3-8b", 2, 24, 4))
CACHE_DTYPES = ("float32", "bfloat16", "int8")
# recurrentgemma-2b's prefill_32k / train_4k geometry (fault 14) on (2, 4):
# query heads that do not divide the model axis (6 on 4, as 10 on 16) over
# one kv head, and a sequence long enough that the RG-LRU's gate products
# take the route the repair gives them at production size: (smoke config
# changes, tokens a sequence; the train step's batch 4, serving's 2 with 2
# decode steps)
F14_REPL, F14_SEQ = {"n_heads": 6}, 1024
COMP_STEPS = 20


def _env(n_devices=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + HERE + os.pathsep + env.get("PYTHONPATH", "")
    if n_devices is not None:
        # no FMA in the compiled reference (AVX without FMA): jitted, it then
        # rounds as its op-by-op run does (the reference's own test runs the
        # compressed all-reduce op by op; with FMA, XLA contracts its error
        # update c - codes * scale into one fused op)
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={n_devices} "
                            "--xla_cpu_max_isa=AVX")
        env["JAX_PLATFORMS"] = "cpu"
    return env


# ---------------------------------------------------------------------------
# the reference, in one subprocess
# ---------------------------------------------------------------------------

_REF = r"""
import dataclasses, json, sys, time
t0 = time.time()
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

out_dir = sys.argv[1]
PIPE_CASES = json.loads(sys.argv[2]); MOE_CFG = json.loads(sys.argv[3])
COMP_STEPS = int(sys.argv[4])
res = {}

def mesh(shape, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)

def leaves(tree):
    from repro.checkpoint.manager import _flatten_with_paths
    paths, ls, _ = _flatten_with_paths(tree)
    return paths, [np.asarray(x) for x in ls]

# -- the (2, 2) sharded train step (test_distributed.py:35) ----------------
from repro import models as M
from repro.configs import smoke_config
from repro.launch.shardings import plan_for, shardings_for, constrainer_ctx
from repro.optim import AdamWConfig, init_opt_state, opt_state_specs
from repro.train.train_step import make_train_step

cfg = smoke_config("llama3-8b")
key = jax.random.PRNGKey(0)
opt = AdamWConfig(lr=1e-3)
tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
batch = {"tokens": jnp.asarray(tokens)}
params = M.init_params(key, cfg)
p_one, _, m_one = jax.jit(make_train_step(cfg, M.DEFAULT_PLAN, opt, compute_dtype=jnp.float32))(
    params, init_opt_state(params, opt), batch)
m22 = mesh((2, 2), ("data", "model"))
plan = plan_for(cfg, m22)
params2 = M.init_params(key, cfg, plan)
opt2 = init_opt_state(params2, opt)
pspecs = M.param_specs(cfg, plan)
p_sh = shardings_for(pspecs, params2, m22)
o_sh = shardings_for(opt_state_specs(pspecs), opt2, m22)
b_sh = {"tokens": NamedSharding(m22, P(("data",), None))}
with constrainer_ctx(m22, plan):
    step = jax.jit(make_train_step(cfg, plan, opt, compute_dtype=jnp.float32),
                   in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, None))
    p_out, _, m_sh = step(params2, opt2, batch)
paths, init = leaves(params2)
res["lm_paths"] = paths
arrs = {"lm_tokens": tokens}
for i, (a, b, c) in enumerate(zip(init, leaves(p_out)[1], leaves(p_one)[1])):
    arrs[f"lm_init_{i}"], arrs[f"lm_sharded_{i}"], arrs[f"lm_one_{i}"] = a, b, c
res["lm_loss_sharded"] = float(m_sh["loss"]); res["lm_loss_one"] = float(m_one["loss"])
res["lm_param_diff_ref"] = max(float(np.abs(a - b).max())
                               for a, b in zip(leaves(p_out)[1], leaves(p_one)[1]))

# -- the qwen3-moe step through the all-to-all MoE (constrainer_ctx moe_a2a),
# and kimi-k2's, whose MoE blocks add a shared expert --------------------------
for pre, arch, seed in (("a2a", "qwen3-moe-235b-a22b", 3), ("a2a_kimi", "kimi-k2-1t-a32b", 4)):
    acfg = smoke_config(arch)
    aplan = plan_for(acfg, m22)
    aparams = M.init_params(jax.random.PRNGKey(seed), acfg, aplan)
    aopt = init_opt_state(aparams, opt)
    atokens = np.random.default_rng(seed).integers(0, acfg.vocab, (4, 16)).astype(np.int32)
    aspecs = M.param_specs(acfg, aplan)
    ap_sh = shardings_for(aspecs, aparams, m22)
    ao_sh = shardings_for(opt_state_specs(aspecs), aopt, m22)
    with constrainer_ctx(m22, aplan, moe_a2a=True):
        astep = jax.jit(make_train_step(acfg, aplan, opt, compute_dtype=jnp.float32),
                        in_shardings=(ap_sh, ao_sh, b_sh), out_shardings=(ap_sh, ao_sh, None))
        ap_out, _, am = astep(aparams, aopt, {"tokens": jnp.asarray(atokens)})
    res[f"{pre}_paths"] = leaves(aparams)[0]
    arrs[f"{pre}_tokens"] = atokens
    for i, (a, b) in enumerate(zip(leaves(aparams)[1], leaves(ap_out)[1])):
        arrs[f"{pre}_init_{i}"], arrs[f"{pre}_sharded_{i}"] = a, b
    res[f"{pre}_loss_sharded"] = float(am["loss"])

print("lm", time.time() - t0, flush=True)
# -- the pipeline (test_distributed.py:124, :154, :178) ---------------------
from repro.distributed.pipeline import pipeline_forward, split_layers_to_stages

m4 = mesh((4,), ("pod",))
x64 = jax.enable_x64(True)      # float64: the schedule is held exactly
x64.__enter__()
for name, (L, D, n_micro, nan_bubble) in PIPE_CASES.items():
    rng = np.random.default_rng(len(name))
    w = rng.normal(size=(L, D, D)) * 0.4
    mbs = rng.normal(size=(n_micro, 3, D))
    if nan_bubble:
        def body(c, p):
            return jnp.tanh((c / jnp.sqrt(jnp.sum(c * c))) @ p), None
    else:
        def body(c, p):
            return jnp.tanh(c @ p), None
    def stage_fn(params, x):
        return jax.lax.scan(body, x, params)[0]
    def pipe(w_):
        return pipeline_forward(split_layers_to_stages(w_, 4), jnp.asarray(mbs), stage_fn, m4)
    def seq(w_):
        return jnp.stack([jax.lax.scan(body, jnp.asarray(mbs[i]), w_)[0] for i in range(n_micro)])
    arrs[f"pipe_{name}_w"], arrs[f"pipe_{name}_mbs"] = w, mbs
    arrs[f"pipe_{name}_out"] = np.asarray(jax.jit(pipe)(jnp.asarray(w)))
    arrs[f"pipe_{name}_seq"] = np.asarray(jax.jit(seq)(jnp.asarray(w)))
    if not nan_bubble:
        arrs[f"pipe_{name}_gpipe"] = np.asarray(
            jax.jit(jax.grad(lambda w_: jnp.sum(pipe(w_) ** 2)))(jnp.asarray(w)))
        arrs[f"pipe_{name}_gseq"] = np.asarray(
            jax.jit(jax.grad(lambda w_: jnp.sum(seq(w_) ** 2)))(jnp.asarray(w)))

x64.__exit__(None, None, None)
print("pipe", time.time() - t0, flush=True)
# -- the all-to-all MoE on (2, 4) (test_perf_features.py:54) ----------------
from repro.configs.base import MoEConfig
from repro.models import moe as moe_mod
from repro.models.moe_a2a import apply_moe_a2a

mcfg = dataclasses.replace(smoke_config("qwen3-moe-235b-a22b"), moe=MoEConfig(**MOE_CFG))
p = moe_mod.init_moe(jax.random.PRNGKey(0), mcfg)
x = (np.random.default_rng(1).normal(size=(4, 8, mcfg.d_model)) * 0.5).astype(np.float32)
m24 = mesh((2, 4), ("data", "model"))
out, aux = jax.jit(lambda p_, x_: apply_moe_a2a(p_, x_, mcfg, m24, ("data",), "model"))(p, x)
g = jax.jit(jax.grad(lambda p_: apply_moe_a2a(p_, jnp.asarray(x), mcfg, m24, ("data",),
                                               "model")[0].sum()))(p)
ref, aux_ref = moe_mod.apply_moe(p, jnp.asarray(x), mcfg)
res["moe_keys"] = sorted(p)
for k_ in sorted(p):
    arrs[f"moe_p_{k_}"] = np.asarray(p[k_])
arrs.update(moe_x=x, moe_out=np.asarray(out), moe_ref=np.asarray(ref),
            moe_g_w_gate=np.asarray(g["w_gate"]))
res["moe_aux"], res["moe_aux_ref"] = float(aux), float(aux_ref)
# with a shared expert (kimi-style): its output is psum'd over tp
scfg = dataclasses.replace(mcfg, moe=MoEConfig(**MOE_CFG, n_shared_experts=1))
ps = moe_mod.init_moe(jax.random.PRNGKey(2), scfg)
out_s, aux_s = jax.jit(lambda p_, x_: apply_moe_a2a(p_, x_, scfg, m24, ("data",), "model"))(ps, x)
ref_s, _ = moe_mod.apply_moe(ps, jnp.asarray(x), scfg)
for k_, v_ in jax.tree_util.tree_flatten_with_path(ps)[0]:
    arrs["moe_ps_" + jax.tree_util.keystr(k_)] = np.asarray(v_)
arrs.update(moe_shared_out=np.asarray(out_s), moe_shared_unsharded=np.asarray(ref_s))
res["moe_shared_aux"] = float(aux_s)

print("moe", time.time() - t0, flush=True)
# -- the compressed all-reduce on 8 devices (test_distributed.py:348) ------
from jax.experimental.shard_map import shard_map
from repro.optim.compression import make_compressed_allreduce, quantize_ef

m8 = mesh((8,), ("data",))
fn = jax.jit(make_compressed_allreduce(m8, "data"))

def sums(gs, es):   # the code sums compressed_psum_tree forms, exposed
    def inner(g_, e_):
        g_, e_ = g_[0], e_[0]
        amax = jax.lax.pmax(jnp.max(jnp.abs(g_.astype(jnp.float32) + e_)), "data")
        scale = jnp.maximum(amax, 1e-12) / 127.0
        codes, _ = quantize_ef(g_, e_, scale)
        return jax.lax.psum(codes.astype(jnp.int32), "data")[None], scale[None]
    return shard_map(inner, mesh=m8, in_specs=(P("data"), P("data")),
                     out_specs=(P("data"), P("data")))(gs, es)
sums = jax.jit(sums)

gbase = np.random.default_rng(2).normal(size=(8, 256)).astype(np.float32)
err = {"g": jnp.zeros((8, 256))}
arrs["comp_g"] = gbase
for s in range(COMP_STEPS):
    gs = jnp.asarray(gbase) * (1.0 + 0.01 * s)
    cs, sc = sums(gs, err["g"])
    mean, err = fn({"g": gs}, err)
    arrs[f"comp_sum_{s}"] = np.asarray(cs[0]); arrs[f"comp_scale_{s}"] = np.asarray(sc[0])
    arrs[f"comp_mean_{s}"] = np.asarray(mean["g"]); arrs[f"comp_err_{s}"] = np.asarray(err["g"])
    arrs[f"comp_exact_{s}"] = np.asarray(gs.mean(0))

print("comp", time.time() - t0, flush=True)
# -- a checkpoint saved from a sharded Auto (4, 1) mesh (test_distributed.py:408)
from repro.checkpoint.manager import CheckpointManager

m41 = mesh((4, 1), ("data", "model"))
xs = jnp.arange(64.0).reshape(8, 8)
tree = {"x": jax.device_put(xs, NamedSharding(m41, P("data", None))),
        "h": jax.device_put(jnp.linspace(-3, 3, 32).astype(jnp.bfloat16).reshape(4, 8),
                            NamedSharding(m41, P("data", None)))}
CheckpointManager(out_dir + "/ckpt_ref").save(1, tree, blocking=True)

np.savez(out_dir + "/ref.npz", **arrs)
with open(out_dir + "/ref.json", "w") as f:
    json.dump(res, f)
print("ok")
"""


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("torch_dist"))


@pytest.fixture(scope="module")
def ref(work):
    out = subprocess.run(
        [sys.executable, "-c", _REF, work, json.dumps(PIPE_CASES), json.dumps(MOE_CFG),
         str(COMP_STEPS)],
        capture_output=True, text=True, env=_env(8), timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(os.path.join(work, "ref.json")) as f:
        res = json.load(f)
    return res, dict(np.load(os.path.join(work, "ref.npz")))


# ---------------------------------------------------------------------------
# the port, on gloo ranks
# ---------------------------------------------------------------------------

def _start_ranks(world: int, work: str, job: str) -> list:
    """``_rank_main(job, ...)`` of this module in ``world`` processes."""
    init = os.path.join(work, f"init_{job}")
    code = ("import sys, test_torch_distributed as t; t._rank_main(sys.argv[1], "
            "int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])")
    return [subprocess.Popen([sys.executable, "-c", code, job, str(r), str(world), init, work],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=_env())
            for r in range(world)]


def _wait_ranks(procs: list, work: str, job: str) -> dict:
    """Wait for a job's ranks; the results its rank 0 wrote."""
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err)
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"{job} rank {r}: {errs[r][-4000:]}"
    with open(os.path.join(work, f"{job}.json")) as f:
        return json.load(f)


def _rank_main(job: str, rank: int, world: int, init: str, work: str) -> None:
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        ref = dict(np.load(os.path.join(work, "ref.npz")))
        with open(os.path.join(work, "ref.json")) as f:
            meta = json.load(f)
        out = (_job4 if job == "w4" else _job8)(rank, ref, meta, work)
        if rank == 0:
            with open(os.path.join(work, f"{job}.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _dt_full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _job4(rank, ref, meta, work):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import smoke_config
    from repro_torch.convert import tree_flatten_with_paths, tree_unflatten
    from repro_torch.distributed.pipeline import pipeline_forward, split_layers_to_stages
    from repro_torch.launch.shardings import (Sharding, constrainer_ctx, plan_for, shard,
                                              shard_tree, shardings_for)
    from repro_torch.models import lm
    from repro_torch.models.sharding_ctx import P
    from repro_torch.optim import AdamWConfig, init_opt_state, opt_state_specs
    from repro_torch.train.train_step import make_train_step

    res = {}
    # -- the sharded train step on (2, 2) ---------------------------------
    m22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = smoke_config("llama3-8b")
    plan = plan_for(cfg, m22)
    like = lm.init_params(torch.Generator().manual_seed(0), cfg, plan, device="cpu")
    paths = [p for p, _ in tree_flatten_with_paths(like)]
    assert paths == meta["lm_paths"], "parameter trees differ"
    params = tree_unflatten(like, [torch.from_numpy(ref[f"lm_init_{i}"])
                                   for i in range(len(paths))])
    opt = AdamWConfig(lr=1e-3)
    ostate = init_opt_state(params, opt)
    batch = {"tokens": torch.from_numpy(ref["lm_tokens"])}
    p_one, _, m_one = make_train_step(cfg, plan, opt, compute_dtype=torch.float32)(
        params, ostate, batch)
    pspecs = lm.param_specs(cfg, plan)
    p_sh = shardings_for(pspecs, params, m22)
    o_sh = shardings_for(opt_state_specs(pspecs), ostate, m22)
    b_sh = {"tokens": Sharding(m22, P(("data",), None))}
    with constrainer_ctx(m22, plan):
        p_out, o_out, m_sh = make_train_step(cfg, plan, opt, compute_dtype=torch.float32)(
            shard_tree(params, p_sh), shard_tree(ostate, o_sh), shard_tree(batch, b_sh))
    full = [_dt_full(x) for _, x in tree_flatten_with_paths(p_out)]
    one = [x for _, x in tree_flatten_with_paths(p_one)]
    res["lm"] = {
        "loss_sharded": float(_dt_full(m_sh["loss"])), "loss_one": float(m_one["loss"]),
        "vs_ref_sharded": max(float((a - torch.from_numpy(ref[f"lm_sharded_{i}"])).abs().max())
                              for i, a in enumerate(full)),
        "vs_port_one": max(float((a - b).abs().max()) for a, b in zip(full, one)),
        "all_dtensor": all(type(x).__name__ == "DTensor"
                           for _, x in tree_flatten_with_paths(p_out))
                       and all(type(x).__name__ == "DTensor"
                               for _, x in tree_flatten_with_paths(o_out)),
        "placements_kept": all(tuple(x.placements) == s.placements for (_, x), (_, s) in zip(
            tree_flatten_with_paths(p_out), tree_flatten_with_paths(p_sh))),
        "embed_placements": str(tuple(p_out["embed"].placements)),
    }

    res["detour"] = {a: _sharded_vs_one(a, m22) for a in DETOUR_ARCHS}
    # xLSTM's sLSTM scan on batch shards (2 data ranks) and head shards (4
    # heads on a model axis of 2): r's gradient summed over the batch's ranks
    res["xlstm22"] = {"step": _sharded_vs_one("xlstm-1.3b", m22),
                      "grads": _sharded_grads_vs_one("xlstm-1.3b", m22)}
    res["serve"] = {f"{a}/{dt}": _sharded_serve_vs_one(a, m22, b, s, n, getattr(torch, dt))
                    for a, b, s, n in SERVE_CASES for dt in CACHE_DTYPES}
    res["a2a"] = _a2a_step(m22, ref, meta)
    res["a2a_kimi"] = _a2a_step(m22, ref, meta, "kimi-k2-1t-a32b", "a2a_kimi")

    # -- the pipeline on a (4,) "pod" mesh ---------------------------------
    m4 = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",))
    res["pipe"] = {}
    for name, (n_layers, width, n_micro, nan_bubble) in PIPE_CASES.items():
        def body(c, p, nan_bubble=nan_bubble):
            if nan_bubble:
                c = c / torch.sqrt(torch.sum(c * c))
            return torch.tanh(c @ p)

        def stage_fn(params, x, body=body):
            for i in range(params.shape[0]):
                x = body(x, params[i])
            return x

        w = torch.from_numpy(ref[f"pipe_{name}_w"]).requires_grad_(True)
        mbs = torch.from_numpy(ref[f"pipe_{name}_mbs"])
        out = pipeline_forward(split_layers_to_stages(w, 4), mbs, stage_fn, m4)
        r = {"finite": bool(torch.isfinite(out).all()),
             "fwd_vs_ref": float((out - torch.from_numpy(ref[f"pipe_{name}_out"])).abs().max()),
             "fwd_vs_seq": float((out - torch.from_numpy(ref[f"pipe_{name}_seq"])).abs().max())}
        if not nan_bubble:
            torch.sum(out ** 2).backward()
            r["grad_vs_ref"] = float((w.grad - torch.from_numpy(ref[f"pipe_{name}_gpipe"]))
                                     .abs().max())
            r["grad_vs_seq"] = float((w.grad - torch.from_numpy(ref[f"pipe_{name}_gseq"]))
                                     .abs().max())
        res["pipe"][name] = r

    # -- elastic restore ----------------------------------------------------
    m41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    x = torch.arange(64.0).reshape(8, 8)
    h = torch.from_numpy(np.load(os.path.join(work, "ckpt_ref", "step_00000001", "arr_0.npy"))
                         .view(np.int16).copy()).view(torch.bfloat16)
    want = {"x": x, "h": h}
    target = {k: Sharding(m22, P("data", "model")) for k in want}

    def check(tree):
        return {"equal": all(torch.equal(_dt_full(tree[k]).view(torch.uint8),
                                         want[k].view(torch.uint8)) for k in want),
                "placements": [str(tuple(tree[k].placements)) for k in sorted(want)]}

    # the reference's checkpoint (saved from its sharded Auto (4, 1) mesh)
    restored, _ = CheckpointManager(os.path.join(work, "ckpt_ref")).restore(
        want, shardings=target)
    res["restore_ref"] = check(restored)
    # the port's: saved from DTensors on (4, 1), restored onto (2, 2)
    src = {k: shard(v, Sharding(m41, P("data", None))) for k, v in want.items()}
    CheckpointManager(os.path.join(work, "ckpt_port")).save(1, src, blocking=True)
    restored, _ = CheckpointManager(os.path.join(work, "ckpt_port")).restore(
        want, shardings=target)
    res["restore_port"] = check(restored)
    res["want_placements"] = str((Shard(0), Shard(1)))
    # float32 only, for the reference's manager (it cannot load '<V2' leaves)
    CheckpointManager(os.path.join(work, "ckpt_port_f32")).save(3, {"x": src["x"]},
                                                                 blocking=True)
    res["trainer"] = _trainer_resume(m22, os.path.join(work, "trainer"))
    return res


def _sharded_vs_one(arch, mesh, repl=None, seq=16):
    """One float32 train step of ``arch``'s smoke config (with the fields
    ``repl`` changes), batch 4 x ``seq``, as DTensors on ``mesh`` and as
    plain tensors: (loss diff, param diff)."""
    from repro_torch.configs import smoke_config
    from repro_torch.convert import tree_flatten_with_paths
    from repro_torch.launch.shardings import (Sharding, constrainer_ctx, plan_for, shard_tree,
                                              shardings_for)
    from repro_torch.models import lm
    from repro_torch.models.sharding_ctx import P
    from repro_torch.optim import AdamWConfig, init_opt_state, opt_state_specs
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(smoke_config(arch), **(repl or {}))
    plan = plan_for(cfg, mesh)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, plan, device="cpu")
    opt = AdamWConfig(lr=1e-3)
    ostate = init_opt_state(params, opt)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, seq),
                                     generator=torch.Generator().manual_seed(1)).int()}
    step = make_train_step(cfg, plan, opt, compute_dtype=torch.float32)
    p_one, _, m_one = step(params, ostate, batch)
    pspecs = lm.param_specs(cfg, plan)
    with constrainer_ctx(mesh, plan):
        p_sh, _, m_sh = step(shard_tree(params, shardings_for(pspecs, params, mesh)),
                             shard_tree(ostate, shardings_for(opt_state_specs(pspecs),
                                                              ostate, mesh)),
                             shard_tree(batch, {"tokens": Sharding(mesh, P(("data",), None))}))
    return {"loss_diff": abs(float(_dt_full(m_sh["loss"])) - float(m_one["loss"])),
            "param_diff": max(float((_dt_full(b) - a).abs().max()) for (_, a), (_, b) in zip(
                tree_flatten_with_paths(p_one), tree_flatten_with_paths(p_sh)))}


def _sharded_serve_vs_one(arch, mesh, batch, prompt, steps, cache_dtype, repl=None):
    """``arch``'s smoke config (with the fields ``repl`` changes) served as
    DTensors on ``mesh`` and as plain tensors: prefill of ``batch`` x
    ``prompt`` tokens, then ``steps`` greedy
    decode steps, each side fed its own tokens. Returns the largest logit
    and final-state differences, whether the greedy tokens agree, and
    whether the sharded steps left their input states as they were."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import smoke_config
    from repro_torch.convert import tree_flatten_with_paths
    from repro_torch.launch.shardings import constrainer_ctx, plan_for, shard_tree, shardings_for
    from repro_torch.models import lm
    from repro_torch.models.sharding_ctx import P
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step

    cfg = dataclasses.replace(smoke_config(arch), **(repl or {}))
    plan = plan_for(cfg, mesh)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, plan, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (batch, prompt),
                           generator=torch.Generator().manual_seed(1)).int()
    state = lm.init_decode_state(cfg, plan, batch, prompt + steps, cache_dtype=cache_dtype,
                                 device="cpu")
    prefill, decode = make_prefill_step(cfg, plan), make_decode_step(cfg, plan)
    sspecs = lm.decode_state_specs(cfg, plan, cache_dtype=cache_dtype)

    def flat(tree):
        return [_dt_full(x) for _, x in tree_flatten_with_paths(tree)]

    def serve(params, state, tokens, place):
        logits, st = prefill(params, {"tokens": place(tokens, P(plan.dp_axes, None))}, state)
        outs, toks, kept = [_dt_full(logits)], [], True
        nxt = torch.argmax(_dt_full(logits), dim=-1).to(torch.int32)
        for i in range(steps):
            before = [x.clone() for x in flat(st)]
            nxt, logits, new = decode(params, st, place(nxt, P(plan.dp_axes)),
                                      place(torch.tensor(prompt + i), P()))
            kept &= all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                        for a, b in zip(before, flat(st)))
            st = new
            outs.append(_dt_full(logits))
            toks.append(_dt_full(nxt))
        return outs, toks, flat(st), kept

    o_one, t_one, s_one, _ = serve(params, state, tokens, lambda x, spec: x)

    def place(x, spec):
        return shard_tree({"x": x}, shardings_for({"x": spec}, {"x": x}, mesh))["x"]

    p_sh = shard_tree(params, shardings_for(lm.param_specs(cfg, plan), params, mesh))
    s_sh = shard_tree(state, shardings_for(sspecs, state, mesh))
    with constrainer_ctx(mesh, plan), implicit_replication():
        o_sh, t_sh, s_out, kept = serve(p_sh, s_sh, tokens, place)
    return {"logit_diff": max(float((a - b).abs().max()) for a, b in zip(o_one, o_sh)),
            "logit_scale": max(float(a.abs().max()) for a in o_one),
            # each state leaf's difference as a share of its largest |value|
            "state_rel": max(float((a.float() - b.float()).abs().max())
                             / max(float(a.float().abs().max()), 1e-30)
                             for a, b in zip(s_one, s_out)),
            "tokens_equal": all(torch.equal(a, b) for a, b in zip(t_one, t_sh)),
            "input_state_kept": bool(kept)}


def _sharded_grads_vs_one(arch, mesh):
    """``loss_fn``'s float32 gradients of ``arch``'s smoke config, batch
    4 x 16, with the parameters as DTensors on ``mesh`` and as plain
    tensors: the loss difference and the worst leaf's gradient difference
    as a share of that leaf's largest |g|."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import smoke_config
    from repro_torch.convert import tree_flatten_with_paths
    from repro_torch.launch.shardings import (Sharding, constrainer_ctx, plan_for, shard_tree,
                                              shardings_for)
    from repro_torch.models import lm
    from repro_torch.models.sharding_ctx import P

    cfg = smoke_config(arch)
    plan = plan_for(cfg, mesh)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg, plan, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 16),
                                     generator=torch.Generator().manual_seed(1)).int()}

    def grads(p, b):
        leaves = [x.requires_grad_(True) for _, x in tree_flatten_with_paths(p)]
        loss, _ = lm.loss_fn(p, b, cfg, plan)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(_dt_full(loss).detach()), [None if g is None else _dt_full(g) for g in gs]

    loss_one, g_one = grads(params, batch)
    p_sh = shard_tree(params, shardings_for(lm.param_specs(cfg, plan), params, mesh))
    with constrainer_ctx(mesh, plan), implicit_replication():
        loss_sh, g_sh = grads(p_sh, shard_tree(batch, {"tokens": Sharding(mesh, P(("data",),
                                                                                 None))}))
    top = max(float(g.abs().max()) for g in g_one if g is not None)
    worst = 0.0
    for a, b in zip(g_one, g_sh):
        a = torch.zeros(()) if a is None else a
        b = torch.zeros(()) if b is None else b
        worst = max(worst, float((a - b).abs().max()) / max(float(a.abs().max()), 1e-6 * top))
    return {"loss_diff": abs(loss_sh - loss_one), "grad_share": worst,
            "lost": sum((a is None) != (b is None) for a, b in zip(g_one, g_sh))}


def _a2a_step(mesh, ref, meta, arch="qwen3-moe-235b-a22b", pre="a2a"):
    """The reference's smoke step of ``arch`` (its weights and batch 4 x 16,
    stored under ``pre``) as DTensors on ``mesh`` under
    ``constrainer_ctx(..., moe_a2a=True)``, so every MoE block dispatches
    through ``apply_moe_a2a`` on DTensors (kimi-k2's with its shared
    expert): (loss, params) against the reference's sharded step, and how
    many times each MoE route ran."""
    from repro_torch.configs import smoke_config
    from repro_torch.convert import tree_flatten_with_paths, tree_unflatten
    from repro_torch.launch.shardings import (Sharding, constrainer_ctx, plan_for, shard_tree,
                                              shardings_for)
    from repro_torch.models import blocks, lm
    from repro_torch.models.sharding_ctx import P
    from repro_torch.optim import AdamWConfig, init_opt_state, opt_state_specs
    from repro_torch.train.train_step import make_train_step

    cfg = smoke_config(arch)
    plan = plan_for(cfg, mesh)
    like = lm.init_params(torch.Generator().manual_seed(0), cfg, plan, device="cpu")
    paths = [p for p, _ in tree_flatten_with_paths(like)]
    assert paths == meta[f"{pre}_paths"], "parameter trees differ"
    params = tree_unflatten(like, [torch.from_numpy(ref[f"{pre}_init_{i}"])
                                   for i in range(len(paths))])
    opt = AdamWConfig(lr=1e-3)
    ostate = init_opt_state(params, opt)
    pspecs = lm.param_specs(cfg, plan)
    calls = {"a2a": 0, "plain": 0}
    routes = {"a2a": blocks.apply_moe_a2a, "plain": blocks.moe_mod.apply_moe}

    def counted(name):
        def fn(*args):
            calls[name] += 1
            return routes[name](*args)
        return fn

    blocks.apply_moe_a2a = counted("a2a")
    blocks.moe_mod.apply_moe = counted("plain")
    try:
        with constrainer_ctx(mesh, plan, moe_a2a=True):
            p_out, o_out, m_sh = make_train_step(cfg, plan, opt, compute_dtype=torch.float32)(
                shard_tree(params, shardings_for(pspecs, params, mesh)),
                shard_tree(ostate, shardings_for(opt_state_specs(pspecs), ostate, mesh)),
                shard_tree({"tokens": torch.from_numpy(ref[f"{pre}_tokens"])},
                           {"tokens": Sharding(mesh, P(("data",), None))}))
    finally:
        blocks.apply_moe_a2a, blocks.moe_mod.apply_moe = routes["a2a"], routes["plain"]
    leaves = [x for _, x in tree_flatten_with_paths(p_out)]
    return {
        "loss_sharded": float(_dt_full(m_sh["loss"])),
        "vs_ref_sharded": max(float((_dt_full(a) - torch.from_numpy(ref[f"{pre}_sharded_{i}"]))
                                    .abs().max()) for i, a in enumerate(leaves)),
        "calls": calls, "moe_layers": sum(k == "moe" for k in cfg.layer_kinds),
        "shared_experts": cfg.moe.n_shared_experts,
        "all_dtensor": all(type(x).__name__ == "DTensor" for x in leaves)
                       and all(type(x).__name__ == "DTensor"
                               for _, x in tree_flatten_with_paths(o_out)),
    }


def _trainer_resume(mesh, directory):
    """``Trainer.run(shardings=)``: a run interrupted at step 5 and resumed
    onto DTensors equals an uninterrupted one, bit for bit."""
    from repro_torch.launch.shardings import relayout, shard_tree, shardings_for
    from repro_torch.models.sharding_ctx import P
    from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state, opt_state_specs
    from repro_torch.train.trainer import Trainer, TrainerConfig

    opt = AdamWConfig(lr=1e-2)
    specs = {"w": P("data", "model"), "b": P("model")}
    params = {"w": torch.randn((8, 6), generator=torch.Generator().manual_seed(3)),
              "b": torch.zeros((6,))}
    ostate = init_opt_state(params, opt)
    sh = {"params": shardings_for(specs, params, mesh),
          "opt": shardings_for(opt_state_specs(specs), ostate, mesh)}

    def data_fn(step):
        g = torch.Generator().manual_seed(100 + step)
        return {"x": torch.randn((4, 8), generator=g), "y": torch.randn((4, 6), generator=g)}

    def step_fn(p, o, batch):
        live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        pred = batch["x"] @ live["w"] + live["b"]
        loss = torch.mean((pred - batch["y"]) ** 2)
        grads = torch.autograd.grad(loss, [live["b"], live["w"]])
        new_p, new_o, m = adamw_update({"b": grads[0], "w": grads[1]}, o, p, opt, opt.lr)
        return relayout(new_p, p), relayout(new_o, o), {"loss": loss.detach(), **m}

    from torch.distributed.tensor.experimental import implicit_replication

    def fresh():
        return shard_tree(params, sh["params"]), shard_tree(ostate, sh["opt"])

    with implicit_replication():
        full = Trainer(step_fn, data_fn, TrainerConfig(
            total_steps=10, ckpt_every=2, ckpt_dir=directory + "/a")).run(*fresh())
        with_fail = Trainer(step_fn, data_fn, TrainerConfig(
            total_steps=10, ckpt_every=2, ckpt_dir=directory + "/b", fail_at_step=5))
        try:
            with_fail.run(*fresh())
        except RuntimeError:
            pass
        # the restart: fresh state is only a template, the checkpoint wins
        resumed = Trainer(step_fn, data_fn, TrainerConfig(
            total_steps=10, ckpt_every=2, ckpt_dir=directory + "/b")).run(
                {k: torch.zeros_like(v) for k, v in params.items()},
                init_opt_state(params, opt), shardings=sh)
    return {
        "params_equal": all(torch.equal(_dt_full(full[0][k]), _dt_full(resumed[0][k]))
                            for k in params),
        "moments_equal": all(torch.equal(_dt_full(full[1][m][k]), _dt_full(resumed[1][m][k]))
                             for m in ("m", "v") for k in params),
        "resumed_dtensor": all(type(v).__name__ == "DTensor" for v in resumed[0].values()),
        "placements": {k: str(tuple(v.placements)) for k, v in resumed[0].items()},
    }


def _job8(rank, ref, meta, work):
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe_a2a import apply_moe_a2a
    from repro_torch.optim.compression import compressed_sum, make_compressed_allreduce

    res = {}
    # -- the all-to-all MoE on (2, 4) ---------------------------------------
    m24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(smoke_config("qwen3-moe-235b-a22b"), moe=MoEConfig(**MOE_CFG))
    p = {k: torch.from_numpy(ref[f"moe_p_{k}"]).requires_grad_(True) for k in meta["moe_keys"]}
    out, aux = apply_moe_a2a(p, torch.from_numpy(ref["moe_x"]), cfg, m24, ("data",), "model")
    out.sum().backward()
    g_ref = torch.from_numpy(ref["moe_g_w_gate"])
    ps = {"shared": {}}
    for key, v in ref.items():
        if key.startswith("moe_ps_"):       # "['shared']['w_up']" or "['router']"
            path = [k.strip("'") for k in key[len("moe_ps_") + 1:-1].split("][")]
            (ps["shared"] if path[0] == "shared" else ps)[path[-1]] = torch.from_numpy(v)
    scfg = dataclasses.replace(cfg, moe=MoEConfig(**MOE_CFG, n_shared_experts=1))
    out_s, aux_s = apply_moe_a2a(ps, torch.from_numpy(ref["moe_x"]), scfg, m24, ("data",),
                                 "model")
    res["moe_shared"] = {
        "out_vs_ref": float((out_s - torch.from_numpy(ref["moe_shared_out"])).abs().max()),
        "ref_vs_unsharded": float(np.abs(ref["moe_shared_out"]
                                         - ref["moe_shared_unsharded"]).max()),
        "aux_vs_ref": abs(float(aux_s) - meta["moe_shared_aux"]),
    }
    res["moe"] = {
        "out_vs_ref": float((out - torch.from_numpy(ref["moe_out"])).abs().max()),
        "out_vs_unsharded": float((out - torch.from_numpy(ref["moe_ref"])).abs().max()),
        "aux_vs_ref": abs(float(aux) - meta["moe_aux"]),
        "g_vs_ref": float((p["w_gate"].grad - g_ref).abs().max()),
        "g_scale": float(g_ref.abs().max()),
    }

    # -- xLSTM's 4 heads on a model axis of 8 --------------------------------
    m18 = init_device_mesh("cpu", (1, 8), mesh_dim_names=("data", "model"))
    res["xlstm"] = {"step": _sharded_vs_one("xlstm-1.3b", m18),
                    "grads": _sharded_grads_vs_one("xlstm-1.3b", m18),
                    "serve": _sharded_serve_vs_one("xlstm-1.3b", m18, 2, 24, 4, torch.float32)}

    # -- recurrentgemma's fault-14 geometry on (2, 4) ------------------------
    m24r = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    res["rg_f14"] = {
        "step": _sharded_vs_one("recurrentgemma-2b", m24r, F14_REPL, seq=F14_SEQ),
        "serve": _sharded_serve_vs_one("recurrentgemma-2b", m24r, 2, F14_SEQ, 2, torch.float32,
                                       F14_REPL)}

    # -- the compressed all-reduce over 8 ranks, 20 steps ------------------
    m8 = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
    fn = make_compressed_allreduce(m8, "data")
    group = m8.get_group("data")
    gbase = torch.from_numpy(ref["comp_g"])
    err = {"g": torch.zeros(256)}
    sums_equal, err_equal, mean_bitwise, mean_ulps = True, True, True, 0
    tot_c, tot_e = torch.zeros(256), torch.zeros(256)
    for s in range(COMP_STEPS):
        gs = gbase * (1.0 + 0.01 * s)
        cs, _, _ = compressed_sum(gs[rank], err["g"], group)
        mean, err = fn({"g": gs[rank]}, err)
        sums_equal &= torch.equal(cs, torch.from_numpy(ref[f"comp_sum_{s}"]))
        err_equal &= torch.equal(err["g"], torch.from_numpy(ref[f"comp_err_{s}"][rank]))
        want = torch.from_numpy(ref[f"comp_mean_{s}"][rank])
        mean_bitwise &= torch.equal(mean["g"], want)
        mean_ulps = max(mean_ulps, int((mean["g"].view(torch.int32).long()
                                        - want.view(torch.int32).long()).abs().max()))
        exact = gs.mean(0)
        tot_c, tot_e = tot_c + mean["g"], tot_e + exact
    res["comp"] = {
        "sums_equal": bool(sums_equal), "err_equal": bool(err_equal),
        "mean_bitwise": bool(mean_bitwise), "mean_ulps": mean_ulps,
        "one_rel": float((mean["g"] - exact).abs().max() / exact.abs().max()),
        "cum_rel": float((tot_c - tot_e).abs().max() / tot_e.abs().max()),
    }
    return res


@pytest.fixture(scope="module")
def ports(ref, work):
    """The 4-rank and the 8-rank job, run at the same time."""
    jobs = {"w4": _start_ranks(4, work, "w4"), "w8": _start_ranks(8, work, "w8")}
    try:
        return {job: _wait_ranks(procs, work, job) for job, procs in jobs.items()}
    finally:
        for procs in jobs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()


@pytest.fixture(scope="module")
def port4(ports):
    return ports["w4"]


@pytest.fixture(scope="module")
def port8(ports):
    return ports["w8"]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_reference_sharded_step_runs_on_auto_mesh(ref):
    """The reference's own bound, sharded step vs one device, on the
    ``Auto`` (2, 2) mesh its failing test cannot build."""
    res, _ = ref
    print("reference: loss one / sharded", res["lm_loss_one"], res["lm_loss_sharded"],
          "param diff", res["lm_param_diff_ref"])
    assert abs(res["lm_loss_one"] - res["lm_loss_sharded"]) < 2e-4
    assert res["lm_param_diff_ref"] < 5e-5


def test_sharded_train_step_matches_reference(ref, port4):
    res, _ = ref
    lm_ = port4["lm"]
    print("port sharded loss", lm_["loss_sharded"], "reference sharded", res["lm_loss_sharded"],
          "| params vs reference sharded", lm_["vs_ref_sharded"])
    assert abs(lm_["loss_sharded"] - res["lm_loss_sharded"]) < 2e-4
    assert lm_["vs_ref_sharded"] < 5e-5


def test_sharded_train_step_matches_single_process(port4):
    lm_ = port4["lm"]
    print("port sharded loss", lm_["loss_sharded"], "one process", lm_["loss_one"],
          "| params", lm_["vs_port_one"])
    assert abs(lm_["loss_sharded"] - lm_["loss_one"]) < 2e-4
    assert lm_["vs_port_one"] < 5e-5


@pytest.mark.parametrize("arch", DETOUR_ARCHS)
def test_sharded_step_through_replicate_detours(port4, arch):
    r = port4["detour"][arch]
    print(arch, r)
    assert r["loss_diff"] < 2e-4 and r["param_diff"] < 5e-5, r


def _hold_serving(r, cache_dtype):
    """Sharded serving against one process: logits within the llama3-8b
    step's parameter bound, each state leaf within 5e-5 of its largest
    |value| (one bf16 ulp, 2^-8 of it, for a bf16 cache), the same greedy
    tokens, and the caller's state left as it was."""
    print(r)
    assert r["logit_diff"] < 5e-5, r
    assert r["state_rel"] < (2.0 ** -8 if cache_dtype == "bfloat16" else 5e-5), r
    assert r["tokens_equal"] and r["input_state_kept"], r


@pytest.mark.parametrize("arch", [c[0] for c in SERVE_CASES])
@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
def test_sharded_serving_matches_single_process(port4, arch, cache_dtype):
    """Prefill and decode steps as DTensors on (2, 2) (the cache's slot
    write and contraction on local shards, the rolled window, the argmax
    over a vocabulary made whole) against the port's one-process serving."""
    _hold_serving(port4["serve"][f"{arch}/{cache_dtype}"], cache_dtype)


def test_xlstm_step_past_its_heads_matches_single_process(port8):
    """xLSTM's 4 heads on a model axis of 8 (the head width sharded, as on
    the production mesh's 16): the train step within the llama3-8b step's
    bounds of the one-process step."""
    r = port8["xlstm"]["step"]
    print(r)
    assert r["loss_diff"] < 2e-4 and r["param_diff"] < 5e-5, r


def test_xlstm_grads_past_its_heads_match_single_process(port8):
    """The same cell's ``loss_fn`` gradients (the head split's and merge's
    gradients made whole, the mLSTM on batch shards) within 1e-4 of each
    leaf's largest |g| of the one-process gradients, the bound of
    ``tests/test_torch_lm_grads.py``; no leaf loses its gradient."""
    r = port8["xlstm"]["grads"]
    print(r)
    assert r["loss_diff"] < 2e-4 and r["grad_share"] < 1e-4 and r["lost"] == 0, r


def test_xlstm_serving_past_its_heads_matches_single_process(port8):
    _hold_serving(port8["xlstm"]["serve"], "float32")


def test_xlstm_step_on_batch_and_head_shards_matches_single_process(port4):
    """xLSTM on (2, 2): the sLSTM's scan op runs on each rank's shard of
    the batch and of the heads (4 on a model axis of 2), its recurrent
    weights whole, their gradient summed over the data ranks. The train
    step within the llama3-8b step's bounds of the one-process step."""
    r = port4["xlstm22"]["step"]
    print(r)
    assert r["loss_diff"] < 2e-4 and r["param_diff"] < 5e-5, r


def test_xlstm_grads_on_batch_and_head_shards_match_single_process(port4):
    """The same cell's ``loss_fn`` gradients within 1e-4 of each leaf's
    largest |g| of the one-process gradients; no leaf loses its gradient.
    Measured 9.6e-5, at an mLSTM ``b_i`` (the parent's tree, whose sLSTM
    looped per position under ``DTensor``, measures the same there); the
    sLSTM's leaves are not among the five worst (each below 4.9e-5)."""
    r = port4["xlstm22"]["grads"]
    print(r)
    assert r["loss_diff"] < 2e-4 and r["grad_share"] < 1e-4 and r["lost"] == 0, r


def test_recurrentgemma_fault14_step_matches_single_process(port8):
    """recurrentgemma's train_4k geometry (6 query heads on a model axis of
    4 over one kv head, 1024 tokens, the RG-LRU gates on their repaired
    route) as DTensors on (2, 4): the train step within the llama3-8b
    step's bounds of the one-process step (measured 0.0 and 0.0)."""
    r = port8["rg_f14"]["step"]
    print(r)
    assert r["loss_diff"] < 2e-4 and r["param_diff"] < 5e-5, r


def test_recurrentgemma_fault14_serving_matches_single_process(port8):
    """The same geometry's prefill of 1024 tokens and 2 decode steps as
    DTensors, held as sharded serving is (``_hold_serving``; measured: logits
    1.0e-6 off, state 9.4e-7 of its largest |value|)."""
    _hold_serving(port8["rg_f14"]["serve"], "float32")


def _hold_a2a(ref, port4, pre, shared):
    res, _ = ref
    r = port4[pre]
    print(pre, "port a2a loss", r["loss_sharded"], "reference", res[f"{pre}_loss_sharded"],
          "| params vs reference sharded", r["vs_ref_sharded"], "| calls", r["calls"])
    assert r["calls"] == {"a2a": r["moe_layers"], "plain": 0} and r["moe_layers"] > 0, r
    assert r["shared_experts"] == shared, r
    assert r["all_dtensor"], r
    assert abs(r["loss_sharded"] - res[f"{pre}_loss_sharded"]) < 2e-4
    assert r["vs_ref_sharded"] < 5e-5


def test_sharded_moe_a2a_step_matches_reference(ref, port4):
    """The qwen3-moe step with every MoE block routed through
    ``apply_moe_a2a`` on DTensors, against the reference's sharded step
    under ``constrainer_ctx(..., moe_a2a=True)`` on its ``Auto`` (2, 2) mesh,
    at the reference's bounds."""
    _hold_a2a(ref, port4, "a2a", 0)


def test_sharded_moe_a2a_shared_expert_step_matches_reference(ref, port4):
    """kimi-k2's smoke step, whose MoE blocks add a shared expert, through
    ``apply_moe_a2a`` on DTensors (the shared expert's branch), against the
    reference's sharded step under ``constrainer_ctx(..., moe_a2a=True)`` on
    its ``Auto`` (2, 2) mesh, at the reference's bounds: loss 2e-4,
    parameters 5e-5 (measured: loss 9.5e-7, parameters 0.0)."""
    _hold_a2a(ref, port4, "a2a_kimi", 1)


def test_sharded_train_step_keeps_dtensor_layouts(port4):
    """Parameters and optimiser state stay DTensors in the fitted layouts
    (embed: vocab over "model", replicated over "data")."""
    lm_ = port4["lm"]
    assert lm_["all_dtensor"] and lm_["placements_kept"], lm_
    assert lm_["embed_placements"] == "(Replicate(), Shard(dim=0))", lm_


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipeline_forward_matches_reference(port4, case):
    r = port4["pipe"][case]
    print(case, r)
    assert r["finite"], "a bubble tick poisoned the select"
    assert r["fwd_vs_ref"] < 1e-6 and r["fwd_vs_seq"] < 1e-6, r


@pytest.mark.parametrize("case", [c for c, v in PIPE_CASES.items() if not v[3]])
def test_pipeline_gradients_match_reference(port4, case):
    r = port4["pipe"][case]
    assert r["grad_vs_ref"] < 1e-5 and r["grad_vs_seq"] < 1e-5, r


def test_moe_a2a_matches_reference(ref, port8):
    r = port8["moe"]
    print(r)
    assert r["out_vs_ref"] < 1e-5 and r["out_vs_unsharded"] < 1e-5, r
    assert r["aux_vs_ref"] < 1e-6, r
    assert r["g_vs_ref"] < 1e-5 * r["g_scale"] and r["g_scale"] > 0, r


def test_moe_a2a_shared_expert_matches_reference(port8):
    """A shared expert under the all-to-all dispatch: its tp-sliced output
    summed over the tp ranks by an all-reduce, as the reference's psum
    sums it (printed: how far that sum sits from the unsharded
    ``apply_moe``, a property of the reference the port keeps)."""
    r = port8["moe_shared"]
    print(r)
    assert r["out_vs_ref"] < 1e-5 and r["aux_vs_ref"] < 1e-6, r


def test_compressed_allreduce_codes_and_errors_bitwise(port8):
    r = port8["comp"]
    assert r["sums_equal"] and r["err_equal"], r


def test_compressed_allreduce_means(port8):
    """The dequantised means are bitwise the reference's (both divide the
    int32 sum times the scale by the replica count in float32)."""
    r = port8["comp"]
    print(r)
    assert r["mean_bitwise"] and r["mean_ulps"] == 0, r


def test_compressed_allreduce_error_feedback(port8):
    r = port8["comp"]
    assert r["one_rel"] < 0.03, r
    assert r["cum_rel"] < r["one_rel"], r    # EF cancels error over steps


@pytest.mark.parametrize("source", ["restore_ref", "restore_port"])
def test_elastic_restore_onto_shard_shard(port4, source):
    """A checkpoint saved from (4, 1) — by the reference from its Auto
    mesh, or by the port from DTensors — restores onto (2, 2) with
    Shard/Shard placements, bytes equal."""
    r = port4[source]
    assert r["equal"], r
    assert r["placements"] == [port4["want_placements"]] * 2, r


def test_port_sharded_save_writes_the_reference_bytes(port4, work):
    """Both saved the same tree from a sharded (4, 1) mesh: the port's files
    are byte for byte the reference's (the bf16 leaf as '<V2' words)."""
    for name in ("manifest.json", "arr_0.npy", "arr_1.npy"):
        with open(os.path.join(work, "ckpt_ref", "step_00000001", name), "rb") as f:
            a = f.read()
        with open(os.path.join(work, "ckpt_port", "step_00000001", name), "rb") as f:
            b = f.read()
        assert a == b, name


def test_reference_restores_port_sharded_checkpoint(port4, work):
    """The reference's manager restores what the port saved from DTensors,
    and places it on a mesh of its own."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from repro.checkpoint.manager import CheckpointManager as RefManager

    target = NamedSharding(Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model")),
                           PartitionSpec("data", "model"))
    tree, step = RefManager(os.path.join(work, "ckpt_port_f32")).restore(
        {"x": jnp.zeros((8, 8), jnp.float32)}, shardings={"x": target})
    assert step == 3 and tree["x"].sharding == target
    np.testing.assert_array_equal(np.asarray(tree["x"]), np.arange(64.0).reshape(8, 8))


def test_trainer_resumes_onto_shardings_bitwise(port4):
    r = port4["trainer"]
    print(r)
    assert r["params_equal"] and r["moments_equal"], r
    assert r["resumed_dtensor"], r
    assert r["placements"] == {"b": "(Replicate(), Shard(dim=0))",
                               "w": "(Shard(dim=0), Shard(dim=1))"}, r


def test_meshes_refuse_cpu_default(monkeypatch):
    """The process-group meshes default to CUDA and refuse without it."""
    from repro_torch.launch import mesh as mesh_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.make_host_mesh(2, 2)
