"""Port parity of co-design training: gradients through the STE-quantised
analog path, the classifier's AdamW steps, the CNN baseline, and the
port's own ``test_ip2_vit_learns``.

Tolerances, with the figures measured on the CPU:

* at the rails of every clip (analog ReLU / saturation, ADC STE, PWM) the
  port's gradients equal ``jax.grad``'s exactly: JAX splits a tie 0.5 /
  0.5, and so does ``_arith.clip``;
* ``vit_loss`` gradients (dense, the compact float wire, ``qth=True``)
  within 1e-5 of each leaf's largest |g| (measured: at most 2.4e-6 with
  the sigmoid nonlinearity, below 1e-6 in every other case; the sums run
  in another order in XLA); a leaf whose
  gradient is 0 in exact arithmetic (largest |g| below 1e-6 of the tree's:
  the key bias ``bk``, ~1e-9, and ``a_rgb`` on black frames, 0) is held
  against 1e-2 of the tree's largest and printed (see ``_grad_close``);
* the CNN's logits within 1e-5, its gradients within 1e-5 of each leaf's
  largest |g| (measured at most 2.3e-6);
* one AdamW step of the classifier from the reference's parameters
  (teacher-forced, 5 times): losses within 1e-5; parameters within 1e-4
  everywhere, and within 1e-6 or 4 ulp of themselves on all but 0.01 %
  of them outside the key biases (measured: 10 of 472 160). AdamW divides
  each gradient element by its own running magnitude plus eps 1e-8, so an
  element near eps, moved by rounding, moves its weight by a share of lr
  (2e-3): the attention key bias, whose gradient is 0 in exact arithmetic
  and ~1e-9 of rounding noise in both packages, moves by up to 6.3e-5
  (measured), everything else by at most ~1.5e-5. Free-running 5 steps:
  losses within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as j_optim
from repro.core import adc as j_adc
from repro.core import analog_nl as j_nl
from repro.core import frontend as j_fe
from repro.core import projection as j_proj
from repro.core import pwm as j_pwm
from repro.models import cnn as j_cnn
from repro.models import vit as j_vit
from repro_torch._arith import clip
from repro_torch.convert import (params_from_numpy, tree_flatten_with_paths, tree_map,
                                 tree_unflatten)
from repro_torch.core import adc as t_adc
from repro_torch.core import analog_nl as t_nl
from repro_torch.core import frontend as t_fe
from repro_torch.core import projection as t_proj
from repro_torch.core import pwm as t_pwm
from repro_torch.data.pipeline import SceneStream
from repro_torch.models import cnn as t_cnn
from repro_torch.models import vit as t_vit
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train.trainer import make_train_step

KEY = jax.random.PRNGKey(0)
GRAD_RTOL = 1e-5
ZERO_FLOOR = 1e-2
ROUNDING = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _grad_close(tg, jg, case):
    """Each leaf within GRAD_RTOL of its largest |g|; prints the worst and
    every floored leaf (``-s`` shows them).
    A leaf whose gradient is 0 in exact arithmetic carries only rounding
    noise (the attention key bias ``bk``: softmax is shift-invariant along
    the keys, so its gradient is ~1e-9 in both packages). Only a leaf whose
    largest reference |g| is at that level, below ROUNDING of the tree's
    largest, is held against ZERO_FLOOR of the tree's largest instead."""
    worst, at = 0.0, None
    jl = dict((p, np.asarray(v)) for p, v in tree_flatten_with_paths(
        jax.tree.map(np.asarray, jg)))
    tree_max = float(max(np.abs(v).max() for v in jl.values()))
    for path, t in tree_flatten_with_paths(tg):
        want = jl[path]
        scale = float(np.abs(want).max())
        if scale < ROUNDING * tree_max:
            print(f"{case} {path}: floored, max |g| {scale:.3g} "
                  f"of the tree's {tree_max:.3g}")
            scale = ZERO_FLOOR * tree_max
        err = float(np.abs(t.numpy() - want).max()) / scale
        assert err <= GRAD_RTOL, f"{case} {path}: {err:.2e} of max |g| {scale:.3g}"
        if err >= worst:
            worst, at = err, path
    print(f"{case}: worst |dg| / max|g| = {worst:.2e} at {at}")


# ---- step 0: gradients at the rails ----------------------------------------------

def _rail_case(name):
    """(reference fn, port fn, input with values exactly on the rails)."""
    if name.startswith("analog_nl"):
        kind = name.split("_")[-1]
        v = [0.0, 1.0, -1.0, 0.5, -0.5, 1.5, -1.5, 2.0 ** -20]
        return (lambda x: j_nl.analog_nonlinearity(x, j_nl.AnalogNLSpec(kind=kind)),
                lambda x: t_nl.analog_nonlinearity(x, t_nl.AnalogNLSpec(kind=kind)), v)
    if name.startswith(("adc", "digital")):
        bits = 4 if name.endswith("4") else 8
        js, ts = j_adc.ADCSpec(bits=bits), t_adc.ADCSpec(bits=bits)
        v = [-1.0, 1.0, -1.5, 1.5, 0.0, 0.3, -0.7]
        if name.startswith("adc_quantize"):
            return (lambda x: j_adc.adc_quantize(x, js),
                    lambda x: t_adc.adc_quantize(x, ts), v)
        return (lambda x: j_adc.digital_readout(x, 0.5, 0.25, js),
                lambda x: t_adc.digital_readout(x, 0.5, 0.25, ts), v)
    if name == "pwm":
        return (lambda x: j_pwm.pwm_quantize(x, j_pwm.QuantSpec()),
                lambda x: t_pwm.pwm_quantize(x, t_pwm.QuantSpec()),
                [0.0, 1.0, -0.25, 1.25, 0.5, 0.123])
    raise AssertionError(name)


RAIL_CASES = ["analog_nl_relu", "analog_nl_none",
              "adc_quantize_8", "adc_quantize_4", "digital_readout_8", "digital_readout_4",
              "pwm"]


@pytest.mark.parametrize("name", RAIL_CASES)
def test_rail_gradients_equal_jax(name):
    jfn, tfn, v = _rail_case(name)
    v = np.array(v, np.float32)
    w = np.linspace(0.5, 2.0, v.size).astype(np.float32)   # a cotangent per element
    jg = np.asarray(jax.grad(lambda x: jnp.sum(jfn(x) * w))(jnp.asarray(v)))
    x = _t(v).requires_grad_(True)
    (tg,) = torch.autograd.grad(torch.sum(tfn(x) * _t(w)), x)
    np.testing.assert_array_equal(tfn(_t(v)).numpy(), np.asarray(jfn(jnp.asarray(v))))
    np.testing.assert_array_equal(tg.numpy(), jg)


def test_clip_splits_ties_like_jax():
    v = np.array([0.0, 1.0, -3.0, 0.5, 3.0, -0.0], np.float32)
    for lo, hi in ((0.0, 1.0), (None, 1.0), (0.0, None), (-1.0, 0.5)):
        def jfn(x):
            if lo is not None:
                x = jnp.maximum(x, lo)
            return x if hi is None else jnp.minimum(x, hi)
        jg = np.asarray(jax.grad(lambda x: jnp.sum(jfn(x)))(jnp.asarray(v)))
        x = _t(v).requires_grad_(True)
        y = clip(x, lo, hi)
        (tg,) = torch.autograd.grad(torch.sum(y), x)
        np.testing.assert_array_equal(tg.numpy(), jg)
        want = torch.clamp(_t(v), lo, hi)
        assert torch.equal(y.detach(), want)
        assert torch.equal(torch.signbit(y.detach()), torch.signbit(want))


# ---- vit_loss gradients ------------------------------------------------------------

def _cfgs(nl=None, bits=8, **vit):
    """The bench_accuracy frontend (64 x 64 frames, 16 x 16 patches, M 32,
    25 % active, AA at 0.5 Nyquist) in both packages, and a small ViT."""
    def build(proj, nl_mod, adc_mod, fe_mod, vit_mod):
        kw = {} if nl is None else {"nl": nl_mod.AnalogNLSpec(kind=nl)}
        fcfg = fe_mod.FrontendConfig(
            image_h=64, image_w=64, patch=proj.PatchSpec(16, 16, n_vectors=32, **kw),
            active_fraction=0.25, aa_cutoff=0.5, adc=adc_mod.ADCSpec(bits=bits))
        return vit_mod.ViTConfig(frontend=fcfg, **{**dict(n_layers=1, d_model=32,
                                                          n_heads=2, d_ff=64), **vit})
    return (build(j_proj, j_nl, j_adc, j_fe, j_vit), build(t_proj, t_nl, t_adc, t_fe, t_vit))


def _carry(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _port_grads(loss_fn, tp):
    """torch.autograd gradients of ``loss_fn`` at ``tp``, in its tree."""
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    grads = torch.autograd.grad(loss_fn(p), [x for _, x in tree_flatten_with_paths(p)])
    return tree_unflatten(p, grads)


GRAD_CASES = {
    "relu_8bit": dict(nl="relu"),
    "none_default_8bit": dict(),
    "sigmoid_8bit": dict(nl="sigmoid"),
    "relu_4bit": dict(nl="relu", bits=4),
    "none_4bit": dict(bits=4),
    "qth": dict(nl="relu", qth=True),
}


@pytest.mark.parametrize("case", GRAD_CASES)
def test_vit_loss_gradients_match_jax(case):
    jc, tc = _cfgs(**GRAD_CASES[case])
    jp = j_vit.init_vit(KEY, jc)
    tp = _carry(jp)
    rgb, labels = SceneStream(image=64).batch(3, 8)
    jg = jax.jit(jax.grad(
        lambda p: j_vit.vit_loss(p, jnp.asarray(rgb), jnp.asarray(labels), jc)[0]))(jp)
    tg = _port_grads(lambda p: t_vit.vit_loss(p, _t(rgb), _t(labels), tc)[0], tp)
    assert float(np.abs(np.asarray(jg["ip2"]["a_rgb"])).max()) > 0.0
    _grad_close(tg, jg, case)


def test_vit_loss_gradients_on_black_frames():
    """All-black frames put every PWM input on its 0 rail."""
    jc, tc = _cfgs(nl="relu")
    jp = j_vit.init_vit(KEY, jc)
    rgb = np.zeros((4, 64, 64, 3), np.float32)
    labels = np.array([0, 1, 2, 3], np.int32)
    jg = jax.jit(jax.grad(
        lambda p: j_vit.vit_loss(p, jnp.asarray(rgb), jnp.asarray(labels), jc)[0]))(jp)
    tg = _port_grads(lambda p: t_vit.vit_loss(p, _t(rgb), _t(labels), tc)[0], _carry(jp))
    _grad_close(tg, jg, "black_frames")


@pytest.mark.parametrize("qth", [False, True])
def test_compact_float_wire_gradients_match_jax(qth):
    """The co-design gradient through the gather and the STE quantisers on
    the compact path, via the float wire (tests/test_system.py)."""
    jc, tc = _cfgs(nl="relu", qth=qth)
    jp = j_vit.init_vit(KEY, jc)
    rgb = np.asarray(jax.random.uniform(KEY, (2, 64, 64, 3)))

    def jloss(p):
        logits, _ = j_vit.vit_forward_compact(p, jnp.asarray(rgb), jc, wire="float")
        return jnp.sum(logits ** 2)

    def tloss(p):
        logits, _ = t_vit.vit_forward_compact(p, _t(rgb), tc, wire="float")
        return torch.sum(logits ** 2)

    jg = jax.jit(jax.grad(jloss))(jp)
    tg = _port_grads(tloss, _carry(jp))
    assert float(tg["ip2"]["a_rgb"].abs().max()) > 0.0
    assert float(tg["ip2"]["bias"].abs().max()) > 0.0
    _grad_close(tg, jg, f"compact_float_wire{'_qth' if qth else ''}")


# ---- the classifier's AdamW steps --------------------------------------------------

def _classifier():
    jc, tc = _cfgs(n_layers=2, d_model=64, n_heads=4, d_ff=128)
    jopt = j_optim.AdamWConfig(lr=2e-3, weight_decay=0.01)
    topt = AdamWConfig(lr=2e-3, weight_decay=0.01)

    @jax.jit
    def jstep(params, opt_state, rgb, labels):
        (loss, acc), g = jax.value_and_grad(j_vit.vit_loss, has_aux=True)(
            params, rgb, labels, jc)
        params, opt_state, _ = j_optim.adamw_update(g, opt_state, params, jopt,
                                                    jnp.float32(jopt.lr))
        return params, opt_state, loss

    tstep = make_train_step(lambda p, rgb, labels: t_vit.vit_loss(p, rgb, labels, tc), topt)
    jp = j_vit.init_vit(KEY, jc)
    return jc, tc, jp, j_optim.init_opt_state(jp, jopt), topt, jstep, tstep


def _batch(i, n=16):
    rgb, labels = SceneStream(image=64).batch(i, n)
    return rgb, labels


def test_classifier_adamw_steps_teacher_forced():
    """Each step starts from the reference's parameters and state."""
    jc, tc, jp, js, topt, jstep, tstep = _classifier()
    worst, loose, total = 0.0, 0, 0
    for i in range(5):
        rgb, labels = _batch(i)
        tp, ts, tm = tstep(_carry(jp), _carry(js),
                           {"rgb": _t(rgb), "labels": _t(labels)})
        jp, js, jl = jstep(jp, js, jnp.asarray(rgb), jnp.asarray(labels))
        assert abs(float(tm["loss"]) - float(jl)) <= 1e-5
        assert int(ts["step"]) == int(js["step"]) == i + 1
        want = dict(tree_flatten_with_paths(jax.tree.map(np.asarray, jp)))
        for path, t in tree_flatten_with_paths(tp):
            d = np.abs(t.numpy() - want[path])
            assert float(d.max()) <= 1e-4, f"step {i} {path}: {float(d.max()):.2e}"
            worst = max(worst, float(d.max()))
            if path.endswith("['bk']"):   # a gradient of rounding noise only
                continue
            loose += int((d > np.maximum(1e-6, 4 * np.spacing(np.abs(want[path])))).sum())
            total += d.size
    assert loose <= total // 10_000, f"{loose} of {total} parameters moved beyond 1e-6 / 4 ulp"
    print(f"teacher-forced AdamW steps: worst |dp| = {worst:.2e}, "
          f"{loose} of {total} beyond 1e-6 / 4 ulp")


def test_classifier_adamw_steps_free_running():
    jc, tc, jp, js, topt, jstep, tstep = _classifier()
    tp, ts = _carry(jp), _carry(js)
    for i in range(5):
        rgb, labels = _batch(i)
        tp, ts, tm = tstep(tp, ts, {"rgb": _t(rgb), "labels": _t(labels)})
        jp, js, jl = jstep(jp, js, jnp.asarray(rgb), jnp.asarray(labels))
        assert abs(float(tm["loss"]) - float(jl)) <= 1e-4, (i, float(tm["loss"]), float(jl))


def test_ip2_vit_learns():
    """The reference's test_ip2_vit_learns on the port: the analog frontend
    trains end to end through the STE; held-out accuracy after 150 steps
    must beat chance (0.25) by a wide margin."""
    _, tc = _cfgs(n_layers=2, d_model=64, n_heads=4, d_ff=128)
    tc = dataclasses.replace(tc, n_classes=4)
    params = t_vit.init_vit(tc, torch.Generator().manual_seed(0), device="cpu")
    opt = AdamWConfig(lr=2e-3, weight_decay=0.01)
    opt_state = init_opt_state(params, opt)
    step = make_train_step(lambda p, rgb, labels: t_vit.vit_loss(p, rgb, labels, tc), opt)
    stream = SceneStream(image=64)
    for i in range(150):
        rgb, labels = stream.batch(i, 32)
        params, opt_state, _ = step(params, opt_state, {"rgb": _t(rgb), "labels": _t(labels)})
    accs = []
    with torch.no_grad():
        for j in range(4):
            rgb, labels = stream.batch(50_000 + j, 32)
            accs.append(float(t_vit.vit_loss(params, _t(rgb), _t(labels), tc)[1]))
    assert sum(accs) / len(accs) > 0.5   # chance = 0.25


def test_example_trains_and_resumes_on_cpu(tmp_path, capsys):
    from repro_torch.examples import train_ip2_classifier as example

    argv = ["--device", "cpu", "--steps", "3", "--ckpt-dir", str(tmp_path)]
    first = example.main(argv)
    assert first["n_params"] == 94_560 and [h["step"] for h in first["history"]] == [0]
    assert 0.0 <= first["held_out_acc"] <= 1.0
    again = example.main(["--device", "cpu", "--steps", "4", "--ckpt-dir", str(tmp_path)])
    assert again["history"] == [] and int(again["opt_state"]["step"]) == 4  # resumed at step 3
    assert "held-out accuracy" in capsys.readouterr().out


# ---- the CNN baseline ---------------------------------------------------------------

def test_init_cnn_layout():
    jp = j_cnn.init_cnn(KEY, n_classes=5, width=8)
    tp = t_cnn.init_cnn(torch.Generator().manual_seed(0), n_classes=5, width=8, device="cpu")
    want = dict(tree_flatten_with_paths(jax.tree.map(np.asarray, jp)))
    got = dict(tree_flatten_with_paths(tp))
    assert {k: v.shape for k, v in want.items()} == {k: tuple(v.shape) for k, v in got.items()}
    for k in ("c1", "c2", "c3"):   # normal / sqrt(9 cin): the same spread
        cin = want[f"['{k}']"].shape[2]
        assert abs(float(got[f"['{k}']"].std()) * np.sqrt(9 * cin) - 1.0) < 0.3


@pytest.mark.parametrize("size", [64, 50, 33])
def test_cnn_forward_loss_and_gradients_match_reference(size):
    """SAME padding at stride 2 (asymmetric: 0 before, 1 after at 64)."""
    jp = j_cnn.init_cnn(KEY, width=8)
    tp = _carry(jp)
    rng = np.random.default_rng(size)
    rgb = rng.uniform(size=(4, size, size, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 3], np.int32)
    np.testing.assert_allclose(t_cnn.cnn_forward(tp, _t(rgb)).detach().numpy(),
                               np.asarray(j_cnn.cnn_forward(jp, jnp.asarray(rgb))),
                               atol=1e-5, rtol=0)
    (jl, ja), jg = jax.value_and_grad(j_cnn.cnn_loss, has_aux=True)(
        jp, jnp.asarray(rgb), jnp.asarray(labels))
    tl, ta = t_cnn.cnn_loss(tp, _t(rgb), _t(labels))
    assert abs(float(tl) - float(jl)) <= 1e-6 and float(ta) == float(ja)
    tg = _port_grads(lambda p: t_cnn.cnn_loss(p, _t(rgb), _t(labels))[0], tp)
    _grad_close(tg, jg, f"cnn_{size}")
