"""Port parity: the frontend's three wires (codes, float, sign), dense mode
and the float simulation, against the JAX package, same numpy inputs.

Tolerances (the North star's "held against the reference"):

* integers exact: indices, valid flags, masks, event counts, MACs;
* ADC codes and sign bits may differ between the packages only on a
  counted, bounded number of rows (at most ``MAX_FLIP_ROWS`` per call):
  XLA and PyTorch order the projection's fp32 sums differently, and a sum
  on an ADC rounding boundary (or within rounding of V_R) moves;
* float readouts within 1 LSB on those same rows, atol 1e-6 elsewhere;
* the float simulation (no ADC) atol 1e-6;
* logits and saliency atol 1e-5; loss and accuracy atol 1e-6; dense
  against compact in the port atol 2e-5 (the reference's own bound,
  ``tests/test_system.py``).

The JAX side runs its kernel adapters in interpret mode.
"""

import dataclasses
import functools
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as j_adc
from repro.core import frontend as j_fe
from repro.core import power as j_pw
from repro.core import projection as j_proj
from repro.core import saliency as j_sal
from repro.core import switched_cap as j_sc
from repro.core import temporal as j_tm
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import backend_delta as j_bd
from repro.models import vit as j_vit
from repro_torch.convert import params_from_numpy
from repro_torch.core import adc as t_adc
from repro_torch.core import frontend as t_fe
from repro_torch.core import power as t_pw
from repro_torch.core import projection as t_proj
from repro_torch.core import saliency as t_sal
from repro_torch.core import switched_cap as t_sc
from repro_torch.core import temporal as t_tm
from repro_torch.data.pipeline import SceneStream
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import backend_delta as t_bd
from repro_torch.models import vit as t_vit

ATOL = 1e-6
LOGIT_ATOL = 1e-5
MAX_FLIP_ROWS = 2
WIRES = ("codes", "float", "sign")
ROUTES = ("plain", "kernel")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _fe_cfgs(analog=True, temporal=False):
    kw = dict(image_h=64, image_w=64, active_fraction=0.25, analog=analog)
    js = j_sc.SummerSpec(mode="passive", hold_time_s=0.0)
    ts = t_sc.SummerSpec(mode="passive", hold_time_s=0.0)
    jt = j_tm.TemporalSpec(delta_threshold=1e-3, recompute_budget=2)
    tt = t_tm.TemporalSpec(delta_threshold=1e-3, recompute_budget=2)
    if temporal:
        kw_j, kw_t = dict(kw, temporal=jt), dict(kw, temporal=tt)
    else:
        kw_j = kw_t = kw
    return (j_fe.FrontendConfig(patch=j_proj.PatchSpec(16, 16, n_vectors=32, summer=js),
                                **kw_j),
            t_fe.FrontendConfig(patch=t_proj.PatchSpec(16, 16, n_vectors=32, summer=ts),
                                **kw_t))


def _fe_params(seed=11):
    rng = np.random.default_rng(seed)
    jp = {"a_rgb": jnp.asarray((rng.normal(size=(32, 768)) * 6.4).astype(np.float32)),
          "bias": jnp.asarray((rng.normal(size=(32,)) * 0.05).astype(np.float32))}
    return jp, {k: _t(v) for k, v in jp.items()}


def _frames(n=3, step=0):
    rgb, _ = SceneStream(seed=5, image=64).batch(step, n)
    return rgb


def _adapters(route, wire, jc, tc):
    """The kernel adapter of ``wire`` in both packages (None: the plain
    projector)."""
    if route == "plain":
        return None, None
    if wire == "codes":
        return (j_ops.ip2_codes_fn(jc.patch, jc.adc, interpret=True),
                t_ops.ip2_codes_fn(tc.patch, tc.adc))
    if wire == "sign":
        return j_ops.ip2_sign_fn(jc.patch, interpret=True), t_ops.ip2_sign_fn(tc.patch)
    return j_ops.ip2_project_fn(jc.patch, interpret=True), t_ops.ip2_project_fn(tc.patch)


def _close_payload(got, want, lsb, float_only=False):
    """Codes / bits: equal off at most MAX_FLIP_ROWS rows, codes within 1
    LSB there. Floats: atol 1e-6 off at most MAX_FLIP_ROWS rows, 1 LSB
    there (``float_only``: the float simulation, atol 1e-6 everywhere).
    Returns the count of moved rows."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if float_only:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        return 0
    if got.dtype == np.float32:
        d = np.abs(got - want).reshape(-1, got.shape[-1]).max(-1)
        moved = d > ATOL
        assert (d <= lsb + ATOL).all(), f"a readout moved by {d.max()} > 1 LSB"
    else:
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        d = d.reshape(-1, got.shape[-1]).max(-1)
        moved = d > 0
        assert (d <= 1).all()
    assert int(moved.sum()) <= MAX_FLIP_ROWS, f"{int(moved.sum())} rows moved"
    return int(moved.sum())


def _same_events(tev, jev):
    for a, b in zip(tev, jev):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b))


def _words(msg):
    """An error message without the reference's design-document pointers."""
    return re.sub(r"\s*\(DESIGN\.md §\d+\)|\s*— see DESIGN\.md §\d+", "", msg)


# ---- leaf helpers ------------------------------------------------------------

@pytest.mark.parametrize("bias", [0.0, "vector"])
def test_sign_scale_zero(bias):
    b = np.random.default_rng(0).normal(size=(32,)).astype(np.float32)
    jb, tb = (bias, bias) if bias == 0.0 else (jnp.asarray(b), _t(b))
    js, jz = j_adc.sign_scale_zero(jb)
    ts, tz = t_adc.sign_scale_zero(tb)
    assert ts.dtype == tz.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    # bit {0, 1} -> -v_mag + bias, +v_mag + bias
    bits = np.array([[False], [True]])
    deq = t_adc.dequantize(_t(bits), ts, tz).numpy()
    np.testing.assert_array_equal(deq, np.asarray(j_adc.dequantize(jnp.asarray(bits), js, jz)))
    np.testing.assert_allclose(deq, np.stack([-0.1 + b, 0.1 + b]) if bias != 0.0
                               else [[-0.1], [0.1]], atol=ATOL, rtol=0)


@pytest.mark.parametrize("frac", [0.25, 0.5, 0.01])
def test_topk_patch_mask_with_ties(frac):
    rng = np.random.default_rng(1)
    scores = rng.integers(0, 3, size=(4, 16)).astype(np.float32)   # many ties
    scores[3] = 1.0                                                   # all tied
    want = np.asarray(j_sal.topk_patch_mask(jnp.asarray(scores), frac))
    got = t_sal.topk_patch_mask(_t(scores), frac).numpy()
    np.testing.assert_array_equal(got, want)
    k = max(1, int(round(16 * frac)))
    assert (got.sum(-1) == k).all()


def test_mask_views():
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(3, 16, 8)).astype(np.float32)
    mask = rng.random((3, 16)) < 0.3
    mask[2] = False
    mask[2, [3, 11]] = True                                           # fewer than k
    np.testing.assert_array_equal(
        t_sal.apply_patch_mask(_t(feats), _t(mask)).numpy(),
        np.asarray(j_sal.apply_patch_mask(jnp.asarray(feats), jnp.asarray(mask))))
    for k in (4, 6):
        tg, ti = t_sal.compact_active(_t(feats), _t(mask), k)
        jg, ji = j_sal.compact_active(jnp.asarray(feats), jnp.asarray(mask), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        _, tcfg = _fe_cfgs()
        if k == tcfg.n_active:
            tg2, ti2 = t_fe.compact_features(_t(feats), _t(mask), tcfg)
            assert torch.equal(tg2, tg) and torch.equal(ti2, ti)
    np.testing.assert_array_equal(t_sal.active_fraction(_t(mask)).numpy(),
                                  np.asarray(j_sal.active_fraction(jnp.asarray(mask))))


@pytest.mark.parametrize("dtype", ["int8", "float32", "bool"])
def test_held_features(dtype):
    rng = np.random.default_rng(3)
    jc, tc = _fe_cfgs()
    p, m = jc.n_patches, jc.patch.n_vectors
    if dtype == "int8":
        f = rng.integers(-128, 128, (2, p, m)).astype(np.int8)
    elif dtype == "bool":
        f = rng.random((2, p, m)) < 0.5
    else:
        f = rng.normal(size=(2, p, m)).astype(np.float32)
    jcache = j_tm.FeatureCache(
        features=jnp.asarray(f),
        energy=jnp.zeros((2, p), jnp.float32),
        age=jnp.asarray(rng.integers(0, 6, (2, p)).astype(np.int32)),
        valid=jnp.asarray(rng.random((2, p)) < 0.7),
        n_stale=jnp.zeros((2,), jnp.int32))
    tcache = t_tm.FeatureCache(*(_t(x) for x in jcache))
    idx = np.stack([rng.permutation(p)[:4] for _ in range(2)]).astype(np.int32)
    summer = j_sc.SummerSpec(mode="opamp", hold_time_s=10e-6)       # droop: gain < 1
    t_summer = t_sc.SummerSpec(mode="opamp", hold_time_s=10e-6)
    bias = rng.normal(size=(m,)).astype(np.float32) * 0.05
    if dtype == "bool":
        (js, jz), (ts, tz) = j_adc.sign_scale_zero(jnp.asarray(bias)), \
            t_adc.sign_scale_zero(_t(bias))
    else:
        (js, jz), (ts, tz) = (j_adc.readout_scale_zero(0.0, jnp.asarray(bias)),
                              t_adc.readout_scale_zero(0.0, _t(bias)))
    want = j_tm.held_features(jcache, jnp.asarray(idx), summer, js, jz)
    got = t_tm.held_features(tcache, _t(idx), t_summer, ts, tz)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if dtype != "float32":
        with pytest.raises(ValueError, match="scale, zero"):
            t_tm.held_features(tcache, _t(idx), t_summer)


@pytest.mark.parametrize("readout", ["adc", "sign"])
def test_readout_events(readout):
    n_sel = np.array([4.0, 3.0, 0.0], np.float32)
    n_stale = np.array([2.0, 0.0, 1.0], np.float32)
    want = j_pw.frontend_frame_events(4096.0, 256, 32, jnp.asarray(n_sel), jnp.asarray(n_sel),
                                      readout=readout)
    got = t_pw.frontend_frame_events(4096.0, 256, 32, _t(n_sel), _t(n_sel), readout=readout)
    _same_events(got, want)
    want = j_tm.gated_frame_events(4096.0, 256, 32, jnp.asarray(n_sel), jnp.asarray(n_stale),
                                   readout=readout)
    got = t_tm.gated_frame_events(4096.0, 256, 32, _t(n_sel), _t(n_stale), readout=readout)
    _same_events(got, want)
    conv = got.sign_comparisons if readout == "sign" else got.adc_conversions
    other = got.adc_conversions if readout == "sign" else got.sign_comparisons
    np.testing.assert_array_equal(conv.numpy(), n_stale * 32)
    assert not other.any()
    with pytest.raises(ValueError, match="readout"):
        t_pw.frontend_frame_events(4096.0, 256, 32, 1.0, 1.0, readout="ramp")


def test_adapter_attributes_and_counts():
    jc, tc = _fe_cfgs()
    n = np.array([4, 2, 0], np.int32)
    pairs = [(j_ops.ip2_project_fn(jc.patch), t_ops.ip2_project_fn(tc.patch)),
             (j_ops.ip2_codes_fn(jc.patch, jc.adc), t_ops.ip2_codes_fn(tc.patch, tc.adc)),
             (j_ops.ip2_sign_fn(jc.patch), t_ops.ip2_sign_fn(tc.patch))]
    for jf, tf in pairs:
        for attr in ("supports_row_counts", "emits_codes", "emits_sign"):
            assert getattr(tf, attr, False) == getattr(jf, attr, False), attr
        np.testing.assert_array_equal(np.asarray(tf.frame_conversions(n)),
                                      np.asarray(jf.frame_conversions(jnp.asarray(n))))
        assert hasattr(tf, "frame_sign_comparisons") == hasattr(jf, "frame_sign_comparisons")
        if hasattr(jf, "frame_sign_comparisons"):
            np.testing.assert_array_equal(np.asarray(tf.frame_sign_comparisons(n)),
                                          np.asarray(jf.frame_sign_comparisons(jnp.asarray(n))))
    assert t_ops.fused_adc_conversions(5, tc.patch, tc.adc) == 5 * 32
    assert t_ops.fused_adc_conversions(5, tc.patch) == 0
    assert t_ops.fused_sign_comparisons(5, tc.patch) == 5 * 32


def test_programmed_weights_are_used():
    """``programmed=`` replaces the weights the adapter is handed, bitwise
    the adapter over the raw weights."""
    _, tc = _fe_cfgs()
    g = torch.Generator().manual_seed(0)
    x = torch.rand((2, 4, 256), generator=g)
    w = torch.randn((32, 256), generator=g) * 6.4
    prog = t_ops.program_weights(w, tc.patch)
    for make in (lambda pw: t_ops.ip2_project_fn(tc.patch, programmed=pw),
                 lambda pw: t_ops.ip2_codes_fn(tc.patch, tc.adc, programmed=pw),
                 lambda pw: t_ops.ip2_sign_fn(tc.patch, programmed=pw)):
        want = make(None)(x, w, tc.patch)
        assert torch.equal(make(prog)(x, torch.zeros_like(w), tc.patch), want)
        counts = torch.tensor([3, 1])
        ragged = make(prog)(x, torch.zeros_like(w), tc.patch, row_counts=counts)
        assert torch.equal(ragged[0, :3], want[0, :3]) and torch.equal(ragged[1, :1], want[1, :1])
        assert not ragged[0, 3:].any() and not ragged[1, 1:].any()


# ---- host-side activation quantisation and ops.quant_matmul -------------------

def test_quantize_activations_and_quant_matmul_bitwise():
    rng = np.random.default_rng(4)
    a = (rng.normal(size=(3, 5, 40)) * rng.uniform(0.01, 30.0, size=(3, 5, 1))).astype(np.float32)
    a[0, 0] = 0.0                                                  # the 1e-12 floor
    a[1, 2, :3] = [127.5, -127.5, 0.5]                             # ties at the ends
    w = rng.normal(size=(40, 24)).astype(np.float32)
    ja8, jsa = j_ref.quantize_activations_ref(jnp.asarray(a))
    ta8, tsa = t_ref.quantize_activations_ref(_t(a))
    assert ta8.dtype == torch.int8 and tsa.dtype == torch.float32
    np.testing.assert_array_equal(ta8.numpy(), np.asarray(ja8))
    np.testing.assert_array_equal(tsa.numpy(), np.asarray(jsa))
    jw8, jsw = j_ops.quantize_weights_int8(jnp.asarray(w))
    tw8, tsw = t_ops.quantize_weights_int8(_t(w))
    want = j_ops.quant_matmul(jnp.asarray(a), jw8, jsw, interpret=True)
    t_ops.reset_launches()
    got = t_ops.quant_matmul(_t(a), tw8, tsw)
    assert t_ops.LAUNCHES["quant_matmul"] == 0                     # CPU: the plain version
    assert got.shape == (3, 5, 24) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- apply_frontend on the three wires ----------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("wire", WIRES)
def test_compact_wire_ungated(wire, route):
    jc, tc = _fe_cfgs()
    jp, tp = _fe_params()
    jfn, tfn = _adapters(route, wire, jc, tc)
    rgb = _frames()
    jcf = j_fe.apply_frontend(jp, jnp.asarray(rgb), jc, mode="compact", wire=wire,
                              project_fn=jfn)
    t_ops.reset_launches()
    tcf = t_fe.apply_frontend(tp, _t(rgb), tc, mode="compact", wire=wire, project_fn=tfn)
    assert not any(t_ops.LAUNCHES.values())
    for name in ("indices", "valid"):
        np.testing.assert_array_equal(getattr(tcf, name).numpy(), np.asarray(getattr(jcf, name)))
    for name in ("energy", "scale", "zero", "gain"):
        np.testing.assert_allclose(getattr(tcf, name).numpy(), np.asarray(getattr(jcf, name)),
                                   atol=ATOL, rtol=0)
    _same_events(tcf.events, jcf.events)
    _close_payload(tcf.features, jcf.features, jc.adc.lsb)
    want_dtype = {"codes": torch.int8, "float": torch.float32, "sign": torch.bool}[wire]
    assert tcf.features.dtype == want_dtype
    conv = tcf.events.sign_comparisons if wire == "sign" else tcf.events.adc_conversions
    np.testing.assert_array_equal(conv.numpy(), tc.n_active * tc.patch.n_vectors)
    np.testing.assert_allclose(t_fe.dequantize_features(tcf).numpy(),
                               np.asarray(j_fe.dequantize_features(jcf)),
                               atol=jc.adc.lsb + ATOL, rtol=0)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("wire", WIRES)
def test_compact_wire_gated(wire, route):
    """Three ticks of the temporal gate, teacher-forced (both packages start
    each tick from the reference's cache), with the governor's knobs set."""
    jc, tc = _fe_cfgs(temporal=True)
    jp, tp = _fe_params()
    jfn, tfn = _adapters(route, wire, jc, tc)
    dt = {"codes": (jnp.int8, torch.int8), "float": (jnp.float32, torch.float32),
          "sign": (jnp.bool_, torch.bool)}[wire]
    jfront = jax.jit(lambda rgb, cache, k_cap, stale_cap: j_fe.apply_frontend(
        jp, rgb, jc, mode="compact", wire=wire, project_fn=jfn, cache=cache,
        k_cap=k_cap, stale_cap=stale_cap))
    jcache = j_tm.init_feature_cache(jc, (2,), dtype=dt[0])
    pool = _frames(4)
    for t in range(3):
        rgb = np.stack([pool[(t // 2) % 4], pool[(t // 2 + 1) % 4]])
        k_cap, stale_cap = np.array([4, 3 - t % 2], np.int32), np.array([2, 1 + t % 2], np.int32)
        jcf, jnew = jfront(jnp.asarray(rgb), jcache, jnp.asarray(k_cap), jnp.asarray(stale_cap))
        tcache = t_tm.FeatureCache(*(_t(x) for x in jcache))
        assert tcache.features.dtype == dt[1]
        tcf, tnew = t_fe.apply_frontend(tp, _t(rgb), tc, mode="compact", wire=wire,
                                        project_fn=tfn, cache=tcache, k_cap=_t(k_cap),
                                        stale_cap=_t(stale_cap))
        assert tcf.features.dtype == tnew.features.dtype == dt[1]
        _close_payload(tcf.features, jcf.features, jc.adc.lsb)
        _close_payload(tnew.features, jnew.features, jc.adc.lsb)
        for name in ("indices", "valid"):
            np.testing.assert_array_equal(getattr(tcf, name).numpy(),
                                          np.asarray(getattr(jcf, name)))
        for name in ("age", "valid", "n_stale"):
            np.testing.assert_array_equal(getattr(tnew, name).numpy(),
                                          np.asarray(getattr(jnew, name)))
        for name in ("energy", "gain", "zero", "scale"):
            np.testing.assert_allclose(getattr(tcf, name).numpy(),
                                       np.asarray(getattr(jcf, name)), atol=ATOL, rtol=0)
        _same_events(tcf.events, jcf.events)
        jcache = jnew
    assert int(np.asarray(jcache.valid).sum()) > 0


def test_float_wire_is_the_dequantised_code_wire():
    """On the plain route the float wire dequantises bitwise to the code
    wire, ungated and through the gate."""
    _, tc = _fe_cfgs(temporal=True)
    _, tp = _fe_params()
    rgb = _t(_frames())
    cfs = {w: t_fe.apply_frontend(tp, rgb, tc, mode="compact", wire=w) for w in ("codes", "float")}
    assert torch.equal(t_fe.dequantize_features(cfs["float"]),
                       t_fe.dequantize_features(cfs["codes"]))
    caches = {w: t_tm.init_feature_cache(tc, (3,), dtype=d, device="cpu")
              for w, d in (("codes", None), ("float", torch.float32))}
    for t in range(2):
        x = _t(_frames(3, step=t))
        out = {w: t_fe.apply_frontend(tp, x, tc, mode="compact", wire=w, cache=caches[w])
               for w in caches}
        assert torch.equal(t_fe.dequantize_features(out["float"][0]),
                           t_fe.dequantize_features(out["codes"][0]))
        caches = {w: o[1] for w, o in out.items()}


# ---- dense mode and the float simulation --------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("select", ["indices", "mask", "energy"])
def test_dense_mode(select, route):
    jc, tc = _fe_cfgs()
    jp, tp = _fe_params()
    rgb = _frames()
    rng = np.random.default_rng(6)
    kw_j, kw_t = {}, {}
    if select == "indices":
        idx = np.stack([rng.permutation(16)[:4] for _ in range(3)]).astype(np.int32)
        kw_j, kw_t = {"indices": jnp.asarray(idx)}, {"indices": _t(idx)}
    elif select == "mask":
        mask = rng.random((3, 16)) < 0.3
        kw_j, kw_t = {"mask": jnp.asarray(mask)}, {"mask": _t(mask)}
    jfn, tfn = _adapters(route, "float", jc, tc)
    jf, jm = j_fe.apply_frontend(jp, jnp.asarray(rgb), jc, mode="dense", project_fn=jfn, **kw_j)
    tf_, tm = t_fe.apply_frontend(tp, _t(rgb), tc, mode="dense", project_fn=tfn, **kw_t)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tf_.shape == (3, 16, 32) and tf_.dtype == torch.float32
    _close_payload(tf_, jf, jc.adc.lsb)
    assert not tf_[~tm].any()


@pytest.mark.parametrize("mode", ["dense", "compact"])
def test_float_simulation(mode):
    """``analog=False``: full-RGB patches through the unquantised matrix,
    no ADC; its compact payload resolves to the float wire."""
    jc, tc = _fe_cfgs(analog=False)
    jp, tp = _fe_params()
    rgb = _frames()
    jout = j_fe.apply_frontend(jp, jnp.asarray(rgb), jc, mode=mode)
    tout = t_fe.apply_frontend(tp, _t(rgb), tc, mode=mode)
    if mode == "dense":
        np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
        _close_payload(tout[0], jout[0], None, float_only=True)
    else:
        assert tout.features.dtype == torch.float32
        np.testing.assert_array_equal(tout.indices.numpy(), np.asarray(jout.indices))
        _close_payload(tout.features, jout.features, None, float_only=True)
        _same_events(tout.events, jout.events)


def test_default_mode_is_dense_like_the_reference():
    """``apply_frontend(params, rgb, cfg)`` with no mode: the same kind of
    result in both packages, the same values."""
    jc, tc = _fe_cfgs()
    jp, tp = _fe_params()
    rgb = _frames()
    jout = j_fe.apply_frontend(jp, jnp.asarray(rgb), jc)
    tout = t_fe.apply_frontend(tp, _t(rgb), tc)
    assert isinstance(jout, tuple) and not isinstance(jout, j_fe.CompactFeatures)
    assert isinstance(tout, tuple) and not isinstance(tout, t_fe.CompactFeatures)
    assert len(tout) == len(jout) == 2
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    _close_payload(tout[0], jout[0], jc.adc.lsb)


# ---- the reference's rejections, word for word ---------------------------------

def _cache(a):
    return a.tm.init_feature_cache(a.cfg, (1,))


REJECTIONS = {
    "sign_adapter_on_code_wire": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, mode="compact", wire="codes", project_fn=a.sign_fn),
    "code_adapter_on_sign_wire": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, mode="compact", wire="sign", project_fn=a.codes_fn),
    "sign_adapter_on_float_wire": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, mode="compact", wire="float", project_fn=a.sign_fn),
    "code_adapter_on_float_wire": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, mode="compact", wire="float", project_fn=a.codes_fn),
    "sign_adapter_in_dense_mode": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, mode="dense", project_fn=a.sign_fn),
    "code_adapter_in_dense_mode": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, mode="dense", project_fn=a.codes_fn),
    "sign_wire_without_analog": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, dataclasses.replace(a.cfg, analog=False), mode="compact",
        wire="sign"),
    "code_cache_on_sign_wire": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, mode="compact", wire="sign", cache=_cache(a)),
    "sign_cache_on_code_wire": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, mode="compact",
        cache=a.tm.init_feature_cache(a.cfg, (1,), dtype=a.bool)),
    "code_cache_on_float_wire": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, mode="compact", wire="float", cache=_cache(a)),
    "bad_mode": lambda a: a.fe.apply_frontend(a.params, a.rgb, a.cfg, mode="sparse"),
    "bad_wire": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, mode="compact", wire="bits"),
    "cache_in_dense_mode": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, cache=_cache(a)),
    "k_cap_in_dense_mode": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, k_cap=a.to(np.array([2], np.int32))),
    "stale_cap_without_cache": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, mode="compact", stale_cap=a.to(np.array([1], np.int32))),
    "k_cap_with_mask": lambda a: a.fe.apply_frontend(
        a.params, a.rgb, a.cfg, mode="compact", mask=a.to(np.ones((1, 16), bool)),
        k_cap=a.to(np.array([2], np.int32))),
}


@pytest.mark.parametrize("name", list(REJECTIONS))
def test_frontend_rejections_match_reference(name):
    """Each bad call raises ValueError in both packages, with the same words
    (the reference's design-document pointers aside), in the reference's
    order of argument checks."""
    jc, tc = _fe_cfgs()
    jp, tp = _fe_params()
    rgb = _frames(1)
    both = {
        "jax": SimpleNamespace(
            fe=j_fe, tm=j_tm, cfg=jc, params=jp, rgb=jnp.asarray(rgb), to=jnp.asarray,
            bool=jnp.bool_, sign_fn=j_ops.ip2_sign_fn(jc.patch, interpret=True),
            codes_fn=j_ops.ip2_codes_fn(jc.patch, jc.adc, interpret=True)),
        "torch": SimpleNamespace(
            fe=t_fe, tm=SimpleNamespace(init_feature_cache=functools.partial(
                t_tm.init_feature_cache, device="cpu")),
            cfg=tc, params=tp, rgb=_t(rgb), to=_t, bool=torch.bool,
            sign_fn=t_ops.ip2_sign_fn(tc.patch), codes_fn=t_ops.ip2_codes_fn(tc.patch, tc.adc)),
    }
    words = {}
    for pkg, a in both.items():
        with pytest.raises(ValueError) as err:
            REJECTIONS[name](a)
        words[pkg] = _words(str(err.value))
    assert words["torch"] == words["jax"]


# ---- the compact forward on the float and sign wires ----------------------------

def _vit_cfgs(**kw):
    jf, tf = _fe_cfgs(**{k: kw.pop(k) for k in ("temporal",) if k in kw})
    vit = dict(n_layers=2, d_model=32, n_heads=2, d_ff=64)
    vit.update(kw)
    return j_vit.ViTConfig(frontend=jf, **vit), t_vit.ViTConfig(frontend=tf, **vit)


@pytest.fixture(scope="module")
def vit_params():
    jc, _ = _vit_cfgs()
    jp = j_vit.prepare_quant_embed(j_vit.init_vit(jax.random.PRNGKey(7), jc))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("wire", ["float", "sign"])
def test_forward_compact_wire(vit_params, wire, route):
    jp, tp = vit_params
    jc, tc = _vit_cfgs(quant_embed=True)
    jfn, tfn = _adapters(route, wire, jc.frontend, tc.frontend)
    rgb = _frames()
    jcf = j_fe.apply_frontend(jp["ip2"], jnp.asarray(rgb), jc.frontend, mode="compact",
                              wire=wire, project_fn=jfn)
    tcf = t_fe.apply_frontend(tp["ip2"], _t(rgb), tc.frontend, mode="compact",
                              wire=wire, project_fn=tfn)
    assert _close_payload(tcf.features, jcf.features, jc.frontend.adc.lsb) == 0, \
        "this seed is chosen so that no payload row moves"
    jl, ja = j_vit.vit_forward_compact(jp, jnp.asarray(rgb), jc, wire=wire, project_fn=jfn)
    t_ops.reset_launches()
    tl, ta = t_vit.vit_forward_compact(tp, _t(rgb), tc, wire=wire, project_fn=tfn)
    assert not any(t_ops.LAUNCHES.values())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(ta["saliency"].numpy(), np.asarray(ja["saliency"]),
                               atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(ta["indices"].numpy(), np.asarray(ja["indices"]))
    _same_events(ta["events"], ja["events"])
    if wire == "sign":
        # bool bits never enter the w8a8 kernel: quant_embed on and off agree
        plain_cfg = dataclasses.replace(tc, quant_embed=False)
        tl2, _ = t_vit.vit_forward_compact(tp, _t(rgb), plain_cfg, wire=wire, project_fn=tfn)
        assert torch.equal(tl, tl2)


def test_forward_compact_wire_rejections(vit_params):
    jp, tp = vit_params
    jc, tc = _vit_cfgs(quant_embed=True)
    rgb = _frames()
    cases = [
        (dict(fused=True), dict(wire="float")),
        (dict(fused=False), dict(wire="float", sign_mode=np.ones(3, bool))),
    ]
    for cfg_kw, kw in cases:
        jcfg = dataclasses.replace(jc, fused_embed=cfg_kw["fused"])
        tcfg = dataclasses.replace(tc, fused_embed=cfg_kw["fused"])
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        tkw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        with pytest.raises(ValueError) as jerr:
            j_vit.vit_forward_compact(jp, jnp.asarray(rgb), jcfg, **jkw)
        with pytest.raises(ValueError) as terr:
            t_vit.vit_forward_compact(tp, _t(rgb), tcfg, **tkw)
        assert _words(str(terr.value)) == _words(str(jerr.value))
    # the fused kernel converts through the ADC: no sign wire either
    with pytest.raises(ValueError, match="no sign wire"):
        t_vit.vit_forward_compact(tp, _t(rgb), dataclasses.replace(tc, fused_embed=True),
                                  wire="sign")


@pytest.mark.parametrize("wire", ["float", "sign"])
def test_delta_backend_on_wire(vit_params, wire):
    """The gated frontend and the delta backend on a float or sign payload:
    two ticks teacher-forced against the reference's compact forward with
    both caches. MACs exact, logits atol 1e-5."""
    jp, tp = vit_params
    jc, tc = _vit_cfgs(temporal=True, quant_embed=True, saliency_layers="last")
    dt = {"float": (jnp.float32, torch.float32), "sign": (jnp.bool_, torch.bool)}[wire]
    k = jc.frontend.n_active
    jcache = j_tm.init_feature_cache(jc.frontend, (2,), dtype=dt[0])
    jbc = j_bd.init_backend_cache(jc, k, (2,), dtype=dt[0])
    idx = np.stack([np.arange(k), np.arange(k) + 5]).astype(np.int32)
    fwd = jax.jit(lambda rgb, c, bc: j_vit.vit_forward_compact(
        jp, rgb, jc, indices=jnp.asarray(idx), wire=wire, cache=c, backend_cache=bc))
    imgs = _frames(2)
    for t, rgb in enumerate([imgs, imgs, np.roll(imgs, 3, axis=2)]):
        jl, ja = fwd(jnp.asarray(rgb), jcache, jbc)
        tl, ta = t_vit.vit_forward_compact(
            tp, _t(rgb), tc, indices=_t(idx), wire=wire,
            cache=t_tm.FeatureCache(*(_t(x) for x in jcache)),
            backend_cache=t_bd.BackendCache(*(_t(x) for x in jbc)))
        assert ta["cache"].features.dtype == ta["backend_cache"].feats.dtype == dt[1]
        assert _close_payload(ta["backend_cache"].feats, ja["backend_cache"].feats,
                              jc.frontend.adc.lsb) == 0
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"tick {t}")
        np.testing.assert_array_equal(ta["events"].backend_macs.numpy(),
                                      np.asarray(ja["events"].backend_macs))
        _same_events(ta["events"], ja["events"])
        jcache, jbc = ja["cache"], ja["backend_cache"]
    with pytest.raises(ValueError, match="backend cache dtype"):
        t_vit.vit_forward_compact(tp, _t(imgs), tc, indices=_t(idx), wire=wire,
                                  cache=t_tm.init_feature_cache(tc.frontend, (2,), dtype=dt[1],
                                                                 device="cpu"),
                                  backend_cache=t_bd.init_backend_cache(tc, k, (2,), device="cpu"))


# ---- vit_forward and vit_loss ----------------------------------------------------

def test_vit_forward_and_loss(vit_params):
    jp, tp = vit_params
    jc, tc = _vit_cfgs()
    rgb = _frames(4)
    labels = np.array([0, 3, 1, 2], np.int32)
    jl, ja = j_vit.vit_forward(jp, jnp.asarray(rgb), jc, return_aux=True)
    tl, ta = t_vit.vit_forward(tp, _t(rgb), tc, return_aux=True)
    np.testing.assert_array_equal(ta["mask"].numpy(), np.asarray(ja["mask"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(ta["saliency"].numpy(), np.asarray(ja["saliency"]),
                               atol=LOGIT_ATOL, rtol=0)
    assert torch.equal(t_vit.vit_forward(tp, _t(rgb), tc), tl)
    jloss, jacc = j_vit.vit_loss(jp, jnp.asarray(rgb), jnp.asarray(labels), jc)
    tloss, tacc = t_vit.vit_loss(tp, _t(rgb), _t(labels), tc)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["topk", "fewer_than_k"])
def test_dense_against_compact_in_port(vit_params, case):
    """Same selection: the zero-masked (B, P) grid and the k compact tokens
    give the same logits; saliency zero off the mask, positive on it."""
    _, tp = vit_params
    _, tc = _vit_cfgs()
    rgb = _t(_frames(3))
    if case == "topk":
        patches, _ = t_fe.sensor_patches(tp["ip2"], rgb, tc.frontend)
        mask = t_sal.topk_patch_mask(t_sal.patch_energy(patches), 0.25)
    else:
        mask = torch.zeros((3, 16), dtype=torch.bool)
        mask[:, 3] = mask[:, 11] = True
    ld, ad = t_vit.vit_forward(tp, rgb, tc, mask=mask, return_aux=True)
    lc, ac = t_vit.vit_forward_compact(tp, rgb, tc, mask=mask)
    np.testing.assert_allclose(ld.numpy(), lc.numpy(), atol=2e-5, rtol=0)
    for sal in (ad["saliency"], ac["saliency"]):
        assert (sal[~mask] == 0).all() and (sal[mask] > 0).all()
