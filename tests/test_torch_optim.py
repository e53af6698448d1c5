"""Port parity: AdamW, the cosine schedule and int8 error feedback against
the reference's ``repro.optim``, same numpy inputs, and the port's
counterparts of ``tests/test_optim.py``'s properties.

Tolerances. Against the reference run op by op (``jax.disable_jit``),
the first and second moments are bitwise the reference's while the clip
is inactive (float32 moments: the same float32 products and sums in the
same order). Under ``jax.jit``, as the reference trains, XLA contracts
``m * b1 + g * (1 - b1)`` into fused multiply-adds, which round once where
PyTorch rounds twice, so the moments move by an ulp from the second step
on. Everything else meets two more differences: XLA's and PyTorch's
``pow`` (``b ** step`` in the bias corrections) may differ by an ulp, and
the global norm sums in another order, which moves the clip factor by an
ulp. So parameters are held at rtol 1e-6 / atol 1e-7, the moments
elsewhere within 1e-6 of each leaf's largest magnitude (a moment that
nearly cancels moves by more than 1e-6 of itself; bfloat16 moments: 1 bf16
ulp, rtol 2**-7), the gradient norm at rtol 1e-6, the schedule at rtol
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as j_adamw
from repro.optim import compression as j_comp
from repro.optim import schedule as j_sched
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compression as t_comp
from repro_torch.optim import schedule as t_sched

SHAPES = {"a": (8, 16), "b": [(5,), (3, 4)], "c": {"s": (), "w": (33,)}}


def _tree(rng, scale, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, scale, v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(rng, scale, v) for v in shapes]
    return (rng.normal(size=shapes) * scale).astype(np.float32)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, copy=True)), tree)


def _np(tree):
    """A port tree as numpy (bf16 through float32)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.to(torch.float32).numpy() if tree.dtype == torch.bfloat16 else tree.numpy()


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(
        lambda x: np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 else np.asarray(x),
        tree))


@pytest.mark.parametrize("jit", [False, True], ids=["op_by_op", "jit"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["inactive", "active"])
def test_adamw_matches_reference(moments, clip, jit):
    rng = np.random.default_rng(0)
    params = _tree(rng, 1.0)
    grad_scale = 0.02 if clip == "inactive" else 3.0
    grads = [_tree(rng, grad_scale) for _ in range(5)]
    jcfg = j_adamw.AdamWConfig(lr=2e-3, weight_decay=0.01,
                               moment_dtype=getattr(jnp, moments))
    tcfg = t_adamw.AdamWConfig(lr=2e-3, weight_decay=0.01,
                               moment_dtype=getattr(torch, moments))
    jp, tp = _j(params), _t(params)
    js, ts = j_adamw.init_opt_state(jp, jcfg), t_adamw.init_opt_state(tp, tcfg)
    assert ts["step"].dtype == torch.int32 and ts["m"]["a"].dtype == tcfg.moment_dtype
    upd = lambda g, s, p: j_adamw.adamw_update(g, s, p, jcfg, jnp.float32(jcfg.lr))  # noqa: E731
    for g in grads:
        if jit:
            jp, js, jm = jax.jit(upd)(_j(g), js, jp)
        else:
            with jax.disable_jit():
                jp, js, jm = upd(_j(g), js, jp)
        tp, ts, tm = t_adamw.adamw_update(_t(g), ts, tp, tcfg, tcfg.lr)
        assert int(ts["step"]) == int(js["step"])
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert (float(jm["grad_norm"]) > 1.0) == (clip == "active")
        for got, want in zip(_leaves(_np(tp)), _leaves(jp)):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        for key in ("m", "v"):
            got, want = _leaves(_np(ts[key])), _leaves(js[key])
            for a, b in zip(got, want):
                if clip == "inactive" and moments == "float32" and not jit:
                    np.testing.assert_array_equal(a, b)
                elif moments == "float32":
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())
                else:
                    np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=0)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = _tree(rng, 2.0)
    np.testing.assert_allclose(float(t_adamw.global_norm(_t(tree))),
                               float(j_adamw.global_norm(_j(tree))), rtol=1e-6)


def test_cosine_with_warmup_matches_reference():
    steps = np.arange(0, 140, dtype=np.int32)
    for warmup, total, ratio in ((10, 120, 0.1), (0, 50, 0.0), (30, 30, 0.2)):
        want = np.asarray(jax.vmap(lambda s: j_sched.cosine_with_warmup(
            s, 1e-3, warmup, total, ratio))(jnp.asarray(steps)))
        got = np.array([float(t_sched.cosine_with_warmup(torch.tensor(s), 1e-3, warmup,
                                                         total, ratio)) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        whole = t_sched.cosine_with_warmup(torch.from_numpy(steps), 1e-3, warmup, total, ratio)
        np.testing.assert_array_equal(whole.numpy(), got.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_ef_bitwise(seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(257,)) * 3).astype(np.float32)
    err = (rng.normal(size=(257,)) * 0.01).astype(np.float32)
    scale = np.float32(np.abs(g + err).max() / 127.0 * (0.5 if seed == 2 else 1.0))
    jc, je = j_comp.quantize_ef(jnp.asarray(g), jnp.asarray(err), jnp.asarray(scale))
    for s in (torch.tensor(scale), float(scale)):
        tc, te = t_comp.quantize_ef(torch.from_numpy(g), torch.from_numpy(err), s)
        assert tc.dtype == torch.int8
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_init_error_buffers():
    tree = _t(_tree(np.random.default_rng(0), 1.0))
    bufs = t_comp.init_error_buffers(tree)
    ref = j_comp.init_error_buffers(_j(_tree(np.random.default_rng(0), 1.0)))
    for got, want in zip(_leaves(_np(bufs)), _leaves(ref)):
        assert got.dtype == np.float32 and got.shape == want.shape and not got.any()


# ---- the reference's properties (tests/test_optim.py) on the port -------------

@pytest.mark.parametrize("seed,lr", [(3, 1e-3), (11, 1e-5), (12, 1e-2)])
def test_adamw_descends_quadratic(seed, lr):
    g = torch.Generator().manual_seed(seed)
    params = {"x": torch.randn((16,), generator=g) * 3}
    opt = t_adamw.AdamWConfig(lr=lr, weight_decay=0.0)
    state = t_adamw.init_opt_state(params, opt)
    loss = lambda p: torch.sum(p["x"] ** 2)  # noqa: E731
    l0 = float(loss(params))
    for _ in range(25):
        grads = {"x": 2.0 * params["x"]}
        params, state, _ = t_adamw.adamw_update(grads, state, params, opt, lr)
    assert float(loss(params)) < l0


def test_adamw_grad_clip_bounds_update():
    params = {"x": torch.zeros((4,))}
    opt = t_adamw.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    state = t_adamw.init_opt_state(params, opt)
    new_params, _, m = t_adamw.adamw_update({"x": torch.full((4,), 1e6)}, state, params,
                                            opt, torch.tensor(0.1))
    assert float(new_params["x"].abs().max()) < 1.0
    assert float(m["grad_norm"]) > 1e5                # the norm is reported unclipped


def test_adamw_bf16_moments_roundtrip():
    params = {"x": torch.ones((8,))}
    opt = t_adamw.AdamWConfig(moment_dtype=torch.bfloat16)
    state = t_adamw.init_opt_state(params, opt)
    assert state["m"]["x"].dtype == torch.bfloat16
    _, state, _ = t_adamw.adamw_update({"x": torch.full((8,), 0.1)}, state, params, opt, 1e-3)
    assert state["m"]["x"].dtype == torch.bfloat16 and state["v"]["x"].dtype == torch.bfloat16


def test_cosine_schedule_shape():
    lr = t_sched.cosine_with_warmup(torch.arange(0, 1000), 1e-3, 100, 1000)
    assert float(lr[0]) == 0.0
    assert float(lr[100]) >= float(lr[999])           # decays after warm-up
    assert int(torch.argmax(lr)) <= 101               # peak at the end of warm-up
    assert float(lr[999]) >= 1e-4 - 1e-9              # floor = min_ratio * base


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_error_feedback_identity(seed):
    """codes * scale + err == the corrected input (exact decomposition)."""
    g = torch.randn((64,), generator=torch.Generator().manual_seed(seed))
    err0 = torch.randn((64,), generator=torch.Generator().manual_seed(seed + 1)) * 0.01
    scale = torch.max(torch.abs(g + err0)) / 127.0
    codes, err = t_comp.quantize_ef(g, err0, scale)
    np.testing.assert_allclose((codes.to(torch.float32) * scale + err).numpy(),
                               (g + err0).numpy(), rtol=1e-5, atol=1e-6)
    assert float(err.abs().max()) <= float(scale) * 0.5 + 1e-6
