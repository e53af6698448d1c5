"""Port parity for LM training: remat, ``train/train_step.py`` and the
``train_lm`` example, against the reference on its seed-0 weights and the
same numpy batches.

* Remat (``torch.utils.checkpoint``) under both policies is bitwise remat
  off, loss and every gradient, for every arch at its smoke config; the
  ``"dots"`` policy keeps the weight products (``aten.mm``), the same
  products of the same sizes that the reference's policy keeps, and
  recomputes the rest; prefill and decode ignore remat.
* ``make_train_step`` in float32 over 3 steps: loss, ``ce``, ``moe_aux``,
  ``grad_norm`` and ``lr`` within rel 1e-5 of the reference's every step,
  the same metric keys. The free-running parameters are not held
  element-wise: AdamW divides each moment by its own root mean square,
  so an element whose gradient is small against its leaf's largest (where
  the 1e-6 fp32 rounding of the backward is a large share of it) moves by
  that share of ``lr``; 4.5e-2 of a near-zero weight after 3 steps on
  smollm. The two halves are held apart instead: the gradients in
  ``tests/test_torch_lm_grads.py`` (1e-4 of each leaf's largest), and
  here the port's update on the reference's own gradients and state,
  parameters and moments within rel 1e-5 of the reference's step (or
  1e-6 of the leaf's largest value, where XLA's fused multiply-adds keep
  the rounding of two terms that cancel).
* bf16 compute (float32 masters): every weight product (``aten.mm``) of
  the forward and backward runs on bf16 operands (float32 ones under
  float32 compute); the loss within rel 2e-4 of the reference's bf16 step
  and 2e-3 of its own float32 step, each step. Measured on smollm over 3
  steps: 7.5e-5 against the reference's bf16 step, 1.6e-4 against the
  port's float32 step (the reference's bf16 against its float32: 8.2e-5).
* ``microbatches`` 2 and 4 against 1 in float32: loss rel 1e-5,
  gradients within 1e-5 of each leaf's largest, accumulated in
  ``opt.moment_dtype``; the reference's metric keys.
* The reference's "same batch, loss must drop" test, for every arch; its
  restart test (interrupted at step 6, resumed, bitwise); ``cast_tree``;
  the example on the CPU.
"""

import dataclasses

import jax
import jax.extend.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import models as JM
from repro.optim import AdamWConfig as JAdamW
from repro.optim import init_opt_state as j_init_opt
from repro.train import train_step as j_ts
from repro_torch import models as TM
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.convert import tree_flatten_with_paths, tree_unflatten
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.examples import train_lm
from repro_torch.optim import AdamWConfig, adamw_update, cosine_with_warmup, init_opt_state
from repro_torch.train import train_step as t_ts
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_lm_models import ARCHS, carried, make_batch, smoke_pair, to_jax, to_torch

REL = 1e-5
LR = 1e-3
# XLA contracts AdamW's ``a * b + c`` into FMAs; where the two terms cancel
# (a weight decayed to ~lr times its update, a moment near 0) the result
# keeps the terms' rounding, not its own: held at this share of the leaf's
# largest value there
CANCEL = 1e-6
# bf16-compute loss, port against reference, each step: 7.5e-5 measured
# on smollm's smoke config over 3 steps
BF16_REL = 2e-4


def _leaves(tree):
    return [x for _, x in tree_flatten_with_paths(tree)]


def _grads(tp, batch, cfg):
    live = [x.detach().requires_grad_(True) for x in _leaves(tp)]
    loss, _ = TM.loss_fn(tree_unflatten(tp, live), batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, live)


# ---- remat ---------------------------------------------------------------

@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_remat_off(arch, policy):
    _, tc = smoke_pair(arch)
    tp = TM.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    batch = to_torch(make_batch(tc))
    l0, g0 = _grads(tp, batch, dataclasses.replace(tc, remat=False))
    l1, g1 = _grads(tp, batch, dataclasses.replace(tc, remat=True, remat_policy=policy))
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = str(func.overloadpacket)
        self.n[key] = self.n.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_the_reference_recomputes():
    """``"nothing"`` recomputes every op of a repeat in the backward, the
    weight products (``aten.mm``) included; ``"dots"`` (the reference's
    ``dots_with_no_batch_dims_saveable``) recomputes the rest but not the
    weight products. Counted over one loss and its gradient."""
    _, tc = smoke_pair("smollm-135m")
    tc = dataclasses.replace(tc, n_layers=4)
    tp = TM.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    batch = to_torch(make_batch(tc))
    counts = {}
    for name, c in (("off", dataclasses.replace(tc, remat=False)),
                    ("nothing", dataclasses.replace(tc, remat=True, remat_policy="nothing")),
                    ("dots", dataclasses.replace(tc, remat=True, remat_policy="dots"))):
        with _OpCount() as m:
            _grads(tp, batch, c)
        counts[name] = m.n
    off, nothing, dots = counts["off"], counts["nothing"], counts["dots"]
    assert nothing["aten.mm"] > off["aten.mm"]
    assert dots["aten.mm"] == off["aten.mm"]
    for op in ("aten.bmm", "aten.mul"):
        assert dots[op] == nothing[op] > off[op], op


def _ref_saved_products(jc, jp, batch):
    """Sizes of the products that the reference's ``"dots"`` policy saves
    over one forward: the ``dot_general`` without batch dims inside each
    ``jax.checkpoint`` body, counted once per trip of the scans around it."""
    jaxpr = jax.make_jaxpr(lambda p: JM.loss_fn(p, batch, jc)[0])(jp)
    sizes = []

    def subs(v):
        if isinstance(v, jax.extend.core.ClosedJaxpr):
            return [v.jaxpr]
        if isinstance(v, jax.extend.core.Jaxpr):
            return [v]
        if isinstance(v, (tuple, list)):
            return [j for x in v for j in subs(x)]
        return []

    def walk(jx, trips, inside):
        for eqn in jx.eqns:
            name = eqn.primitive.name
            if inside and name == "dot_general":
                (_, _), (lb, rb) = eqn.params["dimension_numbers"]
                if not lb and not rb:
                    sizes.extend([int(np.prod(eqn.outvars[0].aval.shape))] * trips)
            n = trips * eqn.params["length"] if name == "scan" else trips
            for sub in subs(list(eqn.params.values())):
                walk(sub, n, inside or name in ("remat2", "checkpoint"))

    walk(jaxpr.jaxpr, 1, False)
    return sorted(sizes)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_policy_saves_the_reference_products(arch, monkeypatch):
    """Under ``remat_policy="dots"`` the port saves, in the forward, the
    products the reference's ``dots_with_no_batch_dims_saveable`` saves:
    the same number of weight products, of the same sizes. The products
    with batch dims (attention's scores and values, the MoE's experts,
    the mLSTM's per-head projections) are recomputed in both."""
    import torch.utils.checkpoint as tuc

    jc, tc = smoke_pair(arch)
    jc = dataclasses.replace(jc, remat=True, remat_policy="dots")
    tc = dataclasses.replace(tc, remat=True, remat_policy="dots")
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    b = make_batch(jc)
    want = _ref_saved_products(jc, jp, to_jax(b))

    got, make = [], tuc.create_selective_checkpoint_contexts
    out_size = {torch.ops.aten.mm.default: lambda a: a[0].shape[0] * a[1].shape[1],
                torch.ops.aten.addmm.default: lambda a: a[1].shape[0] * a[2].shape[1]}

    def spy(policy_fn, *a, **k):
        def fn(ctx, op, *args, **kw):
            d = policy_fn(ctx, op, *args, **kw)
            if not ctx.is_recompute and d == tuc.CheckpointPolicy.MUST_SAVE:
                got.append(int(out_size[op](args)))
            return d
        return make(fn, *a, **k)

    monkeypatch.setattr(tuc, "create_selective_checkpoint_contexts", spy)
    _grads(carried(jp), to_torch(b), tc)
    assert sorted(got) == want, (sorted(got), want)
    # whisper's decoder layers run outside the remat scan in both packages
    assert bool(want) != jc.is_encoder_decoder


def test_remat_leaves_prefill_and_decode_unchanged():
    """Serving with ``remat=True`` (the default config's) is bitwise the same
    serving with remat off, and records no checkpoint."""
    _, tc = smoke_pair("llama3-8b")
    tp = TM.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    toks = to_torch(make_batch(tc))["tokens"]
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(tc, remat=remat, remat_policy="dots")
        st = TM.init_decode_state(c, TM.DEFAULT_PLAN, toks.shape[0], toks.shape[1],
                                  cache_dtype=torch.float32, device="cpu")
        lg, st = TM.prefill(tp, {"tokens": toks[:, :-1]}, c, TM.DEFAULT_PLAN, st)
        lg2, _ = TM.decode_step(tp, st, toks[:, -1], torch.tensor(toks.shape[1] - 1), c)
        out[remat] = (lg, lg2)
    assert all(torch.equal(a, b) for a, b in zip(out[False], out[True]))


# ---- cast_tree -------------------------------------------------------------

def test_cast_tree_matches_reference_and_keeps_float32_grads():
    tree = {"w": np.ones((2, 3), np.float32), "n": np.arange(3, dtype=np.int32),
            "sub": [np.zeros(2, np.float32)]}
    jt = j_ts.cast_tree(jax.tree.map(jnp.asarray, tree), jnp.bfloat16)
    tt = t_ts.cast_tree({"w": torch.ones(2, 3), "n": torch.arange(3, dtype=torch.int32),
                         "sub": [torch.zeros(2)]}, torch.bfloat16)
    assert [str(x.dtype).removeprefix("torch.") for x in _leaves(tt)] == \
        [np.asarray(x).dtype.name for x in jax.tree.leaves(jt)]
    w = torch.ones(4, requires_grad=True)
    (t_ts.cast_tree({"w": w}, torch.bfloat16)["w"] * 3).sum().backward()
    assert w.grad.dtype == torch.float32 and torch.equal(w.grad, torch.full((4,), 3.0))


# ---- make_train_step against the reference ------------------------------

def _ref_step(jc, dtype, **kw):
    return jax.jit(j_ts.make_train_step(jc, JM.DEFAULT_PLAN, JAdamW(lr=LR), compute_dtype=dtype,
                                        warmup=0, total_steps=10, **kw))


def _port_step(tc, dtype, **kw):
    return t_ts.make_train_step(tc, TM.DEFAULT_PLAN, AdamWConfig(lr=LR), compute_dtype=dtype,
                                warmup=0, total_steps=10, **kw)


def _np_tree(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-235b-a22b", "pixtral-12b-ip2"])
def test_train_step_matches_reference_float32(arch):
    jc, tc = smoke_pair(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    tp = carried(jp)
    jo, to = j_init_opt(jp, JAdamW(lr=LR)), init_opt_state(tp, AdamWConfig(lr=LR))
    jstep, tstep = _ref_step(jc, jnp.float32), _port_step(tc, torch.float32)
    jgrad = jax.jit(jax.grad(lambda p, b: JM.loss_fn(p, b, jc)[0]))
    for s in range(3):
        batch = make_batch(jc, seed=s)
        g_ref = jgrad(jp, to_jax(batch))
        jp_prev, jo_prev = jp, jo
        jp, jo, jm = jstep(jp, jo, to_jax(batch))
        tp, to, tm = tstep(tp, to, to_torch(batch))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=REL, abs=1e-7), (s, k)
        # the port's update on the reference's gradients and state
        p_prev = carried(jp_prev)
        o_prev = {"m": carried(jo_prev["m"]), "v": carried(jo_prev["v"]),
                  "step": torch.tensor(int(jo_prev["step"]), dtype=torch.int32)}
        lr = cosine_with_warmup(o_prev["step"], LR, 0, 10)
        new_p, new_o, _ = adamw_update(carried(g_ref), o_prev, p_prev, AdamWConfig(lr=LR), lr)
        for got, want in ((new_p, jp), (new_o["m"], jo["m"]), (new_o["v"], jo["v"])):
            for a, b in zip(_leaves(got), _np_tree(want)):
                np.testing.assert_allclose(a.numpy(), b, rtol=REL,
                                           atol=CANCEL * float(np.abs(b).max()))
    assert int(to["step"]) == int(jo["step"]) == 3


def test_train_step_bf16_compute_against_reference_and_float32():
    jc, tc = smoke_pair("smollm-135m")
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    runs = {}
    for name, step, params, opt in (
            ("ref_bf16", _ref_step(jc, jnp.bfloat16), jp, j_init_opt(jp, JAdamW(lr=LR))),
            ("ref_f32", _ref_step(jc, jnp.float32), jp, j_init_opt(jp, JAdamW(lr=LR))),
            ("port_bf16", _port_step(tc, torch.bfloat16), carried(jp), None),
            ("port_f32", _port_step(tc, torch.float32), carried(jp), None)):
        port = name.startswith("port")
        if port:
            opt = init_opt_state(params, AdamWConfig(lr=LR))
        losses = []
        for s in range(3):
            b = make_batch(jc, seed=s)
            params, opt, m = step(params, opt, to_torch(b) if port else to_jax(b))
            losses.append(float(m["loss"]))
        runs[name] = np.array(losses)
        if port:
            assert all(x.dtype == torch.float32 for x in _leaves(params))
    rel = lambda a, b: float(np.abs(runs[a] - runs[b]).max() / np.abs(runs[b]).max())  # noqa: E731
    assert rel("port_bf16", "ref_bf16") <= BF16_REL
    assert rel("port_bf16", "port_f32") <= 2e-3
    assert rel("ref_bf16", "ref_f32") <= 2e-3
    assert rel("port_f32", "ref_f32") <= REL
    # the forward and backward run their weight products in compute_dtype
    for dtype in (torch.bfloat16, torch.float32):
        grads_of = t_ts.make_grads_fn(tc, TM.DEFAULT_PLAN, AdamWConfig(lr=LR), dtype)
        with _MatmulDtypes() as m:
            grads_of(carried(jp), to_torch(make_batch(jc)))
        assert m.mm and m.mm == {dtype}, (dtype, m.mm)


class _MatmulDtypes(TorchDispatchMode):
    """The operand dtypes of every ``aten.mm`` (the weight products)."""

    def __init__(self):
        super().__init__()
        self.mm = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.mm:
            self.mm.update(x.dtype for x in args)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatches_match_one_batch(microbatches):
    """A dense arch: the mean CE over equal slices is the mean over the
    batch (an MoE's balance loss and capacity depend on the slice)."""
    jc, tc = smoke_pair("smollm-135m")
    tp = carried(JM.init_params(jax.random.PRNGKey(0), jc))
    batch = to_torch(make_batch(jc))
    batch = {k: torch.cat([v, v.flip(0)]) for k, v in batch.items()}   # 4 rows
    opt = AdamWConfig(lr=LR)
    one = t_ts.make_grads_fn(tc, TM.DEFAULT_PLAN, opt, torch.float32)(tp, batch)
    many = t_ts.make_grads_fn(tc, TM.DEFAULT_PLAN, opt, torch.float32, microbatches)(tp, batch)
    assert float(many[0]) == pytest.approx(float(one[0]), rel=REL)
    assert many[1] == {}
    for a, b in zip(_leaves(many[2]), _leaves(one[2])):
        assert a.dtype == opt.moment_dtype
        assert float((a - b).abs().max()) <= REL * max(float(b.abs().max()), 1e-30)
    # the reference's metric keys with microbatches: loss, lr, grad_norm
    jm = _ref_step(jc, jnp.float32, microbatches=microbatches)(
        JM.init_params(jax.random.PRNGKey(0), jc),
        j_init_opt(JM.init_params(jax.random.PRNGKey(0), jc), JAdamW(lr=LR)),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})[2]
    tm = _port_step(tc, torch.float32, microbatches=microbatches)(
        tp, init_opt_state(tp, opt), batch)[2]
    assert sorted(tm) == sorted(jm) == ["grad_norm", "loss", "lr"]


def test_microbatch_accumulator_follows_the_moment_dtype():
    _, tc = smoke_pair("smollm-135m")
    tp = TM.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    batch = to_torch(make_batch(tc))
    opt = AdamWConfig(lr=LR, moment_dtype=torch.bfloat16)
    _, _, g = t_ts.make_grads_fn(tc, TM.DEFAULT_PLAN, opt, torch.float32, 2)(tp, batch)
    assert all(x.dtype == torch.bfloat16 for x in _leaves(g))


# ---- the reference's training tests --------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_decreases_loss(arch):
    """tests/test_models.py's: the same batch, 4 steps, the loss must drop."""
    cfg = smoke_config(arch)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = AdamWConfig(lr=5e-3)
    opt_state = init_opt_state(params, opt)
    step = t_ts.make_train_step(cfg, TM.DEFAULT_PLAN, opt, compute_dtype=torch.float32)
    batch = to_torch(make_batch(cfg))
    losses = []
    for _ in range(4):
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0]


def _setup(tmp, fail_at=None):
    cfg = smoke_config("smollm-135m")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    opt = AdamWConfig(lr=1e-3)
    step = t_ts.make_train_step(cfg, TM.DEFAULT_PLAN, opt, compute_dtype=torch.float32)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4))
    tcfg = TrainerConfig(total_steps=12, ckpt_every=4, ckpt_dir=tmp, log_every=1,
                         fail_at_step=fail_at)
    return params, init_opt_state(params, opt), step, \
        train_lm.token_batches(cfg, stream, 4, "cpu"), tcfg


def test_restart_bitwise_identical(tmp_path):
    """tests/test_fault_tolerance.py's: interrupted at step 6 (after the
    checkpoint at 4) and resumed equals the uninterrupted run, parameters
    and AdamW state bitwise."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    p, o, s, data, tcfg = _setup(d1)
    pa, oa, _ = Trainer(s, data, tcfg).run(p, o)
    p, o, s, data, tcfg = _setup(d2, fail_at=6)
    with pytest.raises(RuntimeError, match="injected failure"):
        Trainer(s, data, tcfg).run(p, o)
    p, o, s, data, tcfg = _setup(d2)
    pb, ob, _ = Trainer(s, data, tcfg).run(p, o)
    for a, b in zip(_leaves({"p": pa, "o": oa}), _leaves({"p": pb, "o": ob})):
        assert torch.equal(a, b)


def test_train_lm_example_on_cpu(tmp_path, capsys):
    out = train_lm.main(["--smoke", "--steps", "6", "--batch", "2", "--seq", "16",
                         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    assert "smollm-135m (smoke)" in capsys.readouterr().out
    losses = [h["loss"] for h in out["history"]]
    assert [h["step"] for h in out["history"]] == [0, 5]
    assert np.isfinite(losses).all()
    assert all(x.device.type == "cpu" for x in _leaves(out["params"]))
    assert (tmp_path / "ck").is_dir()
