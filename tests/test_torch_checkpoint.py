"""Fault tolerance of the port's training loop (the reference's
``tests/test_fault_tolerance.py`` properties, on the port's classifier
step) and checkpoints shared between the two packages.

A checkpoint is a directory of ``.npy`` files named by a manifest in JAX's
leaf order, so a checkpoint written by either package restores bitwise in
the other; bfloat16 leaves are written as the reference writes them
(2-byte words under the descr ``'<V2'``).
"""

import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as j_optim
from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.core import frontend as j_fe
from repro.core import projection as j_proj
from repro.models import vit as j_vit
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import params_from_numpy, tree_flatten_with_paths
from repro_torch.core import frontend as t_fe
from repro_torch.core import projection as t_proj
from repro_torch.data.pipeline import SceneStream
from repro_torch.models import vit as t_vit
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step, stream_batches


def _cfg():
    fcfg = t_fe.FrontendConfig(image_h=32, image_w=32, active_fraction=0.25,
                               patch=t_proj.PatchSpec(8, 8, n_vectors=8))
    return t_vit.ViTConfig(frontend=fcfg, n_layers=1, d_model=16, n_heads=2, d_ff=32)


def _setup(tmp, total=12, fail_at=None, ckpt_every=4):
    cfg = _cfg()
    params = t_vit.init_vit(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = AdamWConfig(lr=1e-3)
    opt_state = init_opt_state(params, opt)
    step = make_train_step(lambda p, rgb, labels: t_vit.vit_loss(p, rgb, labels, cfg), opt)
    data = stream_batches(SceneStream(image=32), 4, "cpu")
    tcfg = TrainerConfig(total_steps=total, ckpt_every=ckpt_every, ckpt_dir=str(tmp),
                         log_every=1, fail_at_step=fail_at)
    return params, opt_state, step, data, tcfg


def _assert_trees_equal(a, b):
    fa, fb = tree_flatten_with_paths(a), tree_flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_restart_bitwise_identical(tmp_path):
    """Interrupted-then-resumed training equals uninterrupted training."""
    p, o, s, data, tcfg = _setup(tmp_path / "a")
    pA, oA, hA = Trainer(s, data, tcfg).run(p, o)
    p, o, s, data, tcfg = _setup(tmp_path / "b", fail_at=6)
    failing = Trainer(s, data, tcfg)
    with pytest.raises(RuntimeError, match="injected failure"):
        failing.run(p, o)
    failing.ckpt.wait()   # the commit in flight when the step failed
    p, o, s, data, tcfg = _setup(tmp_path / "b")
    pB, oB, hB = Trainer(s, data, tcfg).run(p, o)
    _assert_trees_equal(pA, pB)
    _assert_trees_equal(oA, oB)
    assert int(oB["step"]) == 12 and all(np.isfinite(h["loss"]) for h in hA)
    assert [h["step"] for h in hB] == list(range(5, 12))   # resumed after the step-4 commit
    assert [h["loss"] for h in hB] == [h["loss"] for h in hA[5:]]


def test_atomic_commit_ignores_partial(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    tree = {"w": torch.ones((4,))}
    cm.save(3, tree, blocking=True)
    os.makedirs(str(tmp_path / "step_00000009.tmp"))   # a crash mid-save
    assert cm.latest_step() == 3
    restored, step = cm.restore(tree, device="cpu")
    assert step == 3 and torch.equal(restored["w"], tree["w"])


def test_checkpoint_gc_keeps_last(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones((2,))}
    for s in (1, 2, 3, 4):
        cm.save(s, tree, blocking=True)
    assert cm.all_steps() == [3, 4]
    for s in (5, 6):
        cm.save(s, tree)
    cm.wait()
    assert cm.all_steps() == [5, 6]


def test_tree_mismatch_rejected(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"w": torch.ones((2,))}, blocking=True)
    with pytest.raises(ValueError, match="mismatch"):
        cm.restore({"wrong_name": torch.ones((2,))}, device="cpu")
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"w": torch.ones(2)}, device="cpu")


def test_async_save_snapshots_before_returning(tmp_path):
    """``save`` copies to host memory before it returns: an in-place update
    right after it does not reach the file."""
    cm = CheckpointManager(str(tmp_path))
    w = torch.arange(1 << 16, dtype=torch.float32)
    cm.save(1, {"w": w})
    w.add_(1.0)
    cm.wait()
    restored, _ = cm.restore({"w": w}, device="cpu")
    assert torch.equal(restored["w"], torch.arange(1 << 16, dtype=torch.float32))


def test_background_write_error_is_raised(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_00000002.tmp" / "arr_0.npy")   # a directory in the way
    cm.save(2, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        cm.wait()
    cm.wait()   # raised once


def test_straggler_counter(tmp_path):
    p, o, s, data, tcfg = _setup(tmp_path, total=10, ckpt_every=100)
    tr = Trainer(s, data, tcfg)
    calls = {"n": 0}

    def slow_step(*a):
        calls["n"] += 1
        if calls["n"] == 9:
            time.sleep(1.0)       # a straggler step
        return s(*a)

    tr.step_fn = slow_step
    tr.run(p, o)
    assert tr.n_stragglers >= 1 and len(tr.step_times) == 10


def test_sigterm_drains_with_a_blocking_save(tmp_path):
    p, o, s, data, tcfg = _setup(tmp_path, total=12, ckpt_every=100)
    calls = {"n": 0}

    def preempted_step(*a):
        calls["n"] += 1
        if calls["n"] == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return s(*a)

    before = signal.getsignal(signal.SIGTERM)
    params, opt_state, history = Trainer(preempted_step, data, tcfg).run(p, o)
    assert signal.getsignal(signal.SIGTERM) is before      # the handler is put back
    assert history[-1]["step"] == 3 and calls["n"] == 4
    cm = CheckpointManager(str(tmp_path))
    assert cm.latest_step() == 3
    restored, _ = cm.restore({"params": params, "opt": opt_state}, device="cpu")
    _assert_trees_equal(restored, {"params": params, "opt": opt_state})


# ---- checkpoints shared with the reference -------------------------------------------

def _ref_state(opt_kw=None):
    fcfg = j_fe.FrontendConfig(image_h=32, image_w=32, active_fraction=0.25,
                               patch=j_proj.PatchSpec(8, 8, n_vectors=8))
    cfg = j_vit.ViTConfig(frontend=fcfg, n_layers=2, d_model=16, n_heads=2, d_ff=32)
    params = j_vit.init_vit(jax.random.PRNGKey(3), cfg)
    opt = j_optim.AdamWConfig(**(opt_kw or {}))
    state = j_optim.init_opt_state(params, opt)
    grads = jax.tree.map(lambda x: jnp.full(x.shape, 0.01, x.dtype), params)
    params, state, _ = j_optim.adamw_update(grads, state, params, opt, jnp.float32(1e-3))
    return {"params": params, "opt": state}


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _ref_leaves(tree):
    return [(p, np.asarray(v)) for p, v in tree_flatten_with_paths(jax.tree.map(np.asarray, tree))]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref = _ref_state()
    CheckpointManager(str(tmp_path)).save(7, _port(ref), blocking=True)
    got, step = RefManager(str(tmp_path)).restore(ref)
    assert step == 7
    for (pa, a), (pb, b) in zip(_ref_leaves(got), _ref_leaves(ref)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref = _ref_state()
    RefManager(str(tmp_path)).save(5, ref, blocking=True)
    like = _port(ref)
    got, step = CheckpointManager(str(tmp_path)).restore(like, device="cpu")
    assert step == 5
    _assert_trees_equal(got, like)
    assert got["opt"]["step"].dtype == torch.int32 and got["opt"]["step"].dim() == 0


def test_manifests_are_the_same(tmp_path):
    ref = _ref_state()
    RefManager(str(tmp_path / "ref")).save(1, ref, blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(1, _port(ref), blocking=True)
    read = [json.loads((tmp_path / d / "step_00000001" / "manifest.json").read_text())
            for d in ("ref", "port")]
    assert read[0] == read[1]
    assert "['opt']/['m']/['layers']/[0]/['attn']/['wq']" in read[0]["paths"]
    for i in range(len(read[0]["paths"])):
        a = (tmp_path / "ref" / "step_00000001" / f"arr_{i}.npy").read_bytes()
        b = (tmp_path / "port" / "step_00000001" / f"arr_{i}.npy").read_bytes()
        assert a == b, read[0]["paths"][i]


def test_bf16_moments_round_trip_and_match_reference_bytes(tmp_path):
    ref = _ref_state({"moment_dtype": jnp.bfloat16})
    m = ref["opt"]["m"]
    tm = jax.tree.map(lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16),
                      m)
    CheckpointManager(str(tmp_path / "port")).save(2, {"m": tm}, blocking=True)
    RefManager(str(tmp_path / "ref")).save(2, {"m": m}, blocking=True)
    n = len(tree_flatten_with_paths(tm))
    for i in range(n):
        a = (tmp_path / "port" / "step_00000002" / f"arr_{i}.npy").read_bytes()
        b = (tmp_path / "ref" / "step_00000002" / f"arr_{i}.npy").read_bytes()
        assert a == b
        assert b"'descr': '<V2'" in a[:128]
    got, _ = CheckpointManager(str(tmp_path / "port")).restore({"m": tm}, device="cpu")
    _assert_trees_equal(got, {"m": tm})

