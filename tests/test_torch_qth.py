"""Port parity: Fig. 4 QTH power-of-2 attention (``core/qth_attention.py``)
and ``ViTConfig(qth=True)`` through the forwards and both engines, against
the JAX package on the same seeded numpy inputs and parameters.

Exact matching. ``pow2_quantize`` rounds ``log2 p`` to the nearest integer,
so where softmax or ``log2`` differ by an ulp between XLA and PyTorch at a
half-integer exponent, one coefficient moves by a factor of 2 (or across
the ``2^min_exp`` threshold). The tests count such flips and bound them (at
most 2 per call), as the 1-LSB rule counts moved ADC codes; they never
widen a float tolerance. Everything else is exact: a pow-2 value's STE
forward ``p + (q - p)`` is ``q`` bit for bit (``q - p`` is exact within a
factor of 2), and sums of pow-2 coefficients are exact. Forwards and
logits: atol 1e-5, on calls with no flip and no moved code (both
asserted). Engines: indices and events exact, teacher-forced and
free-running.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontend as j_fe
from repro.core import projection as j_proj
from repro.core import switched_cap as j_sc
from repro.core import temporal as j_tm
from repro.kernels import ops as j_ops
from repro.models import vit as j_vit
from repro.serve import governor as j_gov
from repro.serve.engine import SaccadeEngine as JEngine
from repro_torch.convert import params_from_numpy
from repro_torch.core import frontend as t_fe
from repro_torch.core import projection as t_proj
from repro_torch.core import qth_attention as t_qth
from repro_torch.core import switched_cap as t_sc
from repro_torch.core import temporal as t_tm
from repro_torch.data.pipeline import SceneStream
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import vit as t_vit
from repro_torch.serve import governor as t_gov
from repro_torch.serve.engine import SaccadeEngine as TEngine

# repro.core re-exports the function qth_attention under the module's name
j_qth = importlib.import_module("repro.core.qth_attention")

ATOL = 1e-5
MAX_FLIPS = 2
SPECS = [dict(), dict(renormalize=False), dict(min_exp=-4), dict(min_exp=-4, renormalize=False),
         dict(ste=False), dict(ste=False, renormalize=False)]


def _ids(kw):
    return ",".join(f"{k}={v}" for k, v in kw.items()) or "default"


def _scores(shape=(2, 3, 16, 16), seed=0, scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _flips(got, want):
    """Coefficients that differ between the packages, each asserted to be a
    pow-2 exponent rounded the other way (a factor of 2) or a threshold
    crossing (one side 0)."""
    got, want = np.asarray(got), np.asarray(want)
    d = got != want
    for a, b in zip(got[d], want[d]):
        assert a == 2 * b or b == 2 * a or min(a, b) == 0.0, (a, b)
    return int(d.sum())


def _row_flips(got, want, got_raw, want_raw):
    """Renormalised weights: rows that differ must hold a flipped raw
    coefficient (the row's sum moved with it); returns the raw flips."""
    n = _flips(got_raw, want_raw)
    rows = np.any(np.asarray(got) != np.asarray(want), axis=-1)
    raw_rows = np.any(np.asarray(got_raw) != np.asarray(want_raw), axis=-1)
    assert not (rows & ~raw_rows).any(), "a row differs with no flipped coefficient"
    return n


# ---------------------------------------------------------------------------
# the quantiser and the weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", SPECS, ids=_ids)
def test_pow2_quantize_matches_reference(kw):
    jspec, tspec = j_qth.QTHSpec(**kw), t_qth.QTHSpec(**kw)
    s = _scores(seed=1)
    p = np.array(jax.nn.softmax(jnp.asarray(s), axis=-1))
    grid = np.concatenate([np.linspace(0.0, 1.0, 257),
                           [2.0 ** kw.get("min_exp", -8) * 0.999]]).astype(np.float32)
    for x in (p, grid):
        got = t_qth.pow2_quantize(torch.from_numpy(x), tspec)
        want = j_qth.pow2_quantize(jnp.asarray(x), jspec)
        assert got.dtype == torch.float32
        assert _flips(got.numpy(), want) <= MAX_FLIPS
    # 24 probabilities placed on half-integer exponents, where the two float32
    # log2s round apart: a difference may occur only there, as a flip
    ties = (2.0 ** -np.arange(0, 12, 0.5)).astype(np.float32)
    got = t_qth.pow2_quantize(torch.from_numpy(ties), tspec).numpy()
    want = np.asarray(j_qth.pow2_quantize(jnp.asarray(ties), jspec))
    _flips(got, want)
    at_half = np.abs(np.log2(ties.astype(np.float64)) % 1.0 - 0.5) < 1e-6
    assert not (got != want)[~at_half].any()


@pytest.mark.parametrize("kw", SPECS, ids=_ids)
@pytest.mark.parametrize("masked", [False, True])
def test_qth_attention_weights_match_reference(kw, masked):
    jspec, tspec = j_qth.QTHSpec(**kw), t_qth.QTHSpec(**kw)
    raw = dict(kw, renormalize=False)
    s = _scores(seed=2 + masked)
    valid = None
    if masked:   # (B, 1, k): a head axis, as the wired path passes it; one
        # slot with a single valid key, one with none
        n_valid = np.array([16, 11])[:, None, None]
        valid = np.arange(16)[None, None, :] < n_valid
        valid[1, 0, :] = False
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    got = t_qth.qth_attention_weights(torch.from_numpy(s), tspec, key_valid=tv)
    want = j_qth.qth_attention_weights(jnp.asarray(s), jspec, key_valid=jv)
    got_raw = t_qth.qth_attention_weights(torch.from_numpy(s), t_qth.QTHSpec(**raw),
                                          key_valid=tv)
    want_raw = j_qth.qth_attention_weights(jnp.asarray(s), j_qth.QTHSpec(**raw), key_valid=jv)
    assert got.shape == want.shape
    assert _row_flips(got.numpy(), want, got_raw.numpy(), want_raw) <= MAX_FLIPS
    if masked:
        assert not got.numpy()[0, :, :, 16:].any()


@pytest.mark.parametrize("renormalize", [True, False])
def test_ste_gradients_match_reference(renormalize):
    """The STE passes softmax gradients through the quantiser in both."""
    s = _scores(shape=(2, 2, 8, 8), seed=4)

    def jloss(x):
        return jnp.sum(j_qth.qth_attention_weights(x, j_qth.QTHSpec(renormalize=renormalize))
                       ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(s)))
    x = torch.from_numpy(s).requires_grad_(True)
    (t_qth.qth_attention_weights(x, t_qth.QTHSpec(renormalize=renormalize)) ** 2).sum() \
        .backward()
    assert np.isfinite(x.grad.numpy()).all() and np.abs(x.grad.numpy()).max() > 0
    np.testing.assert_allclose(x.grad.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [dict(), dict(renormalize=False), dict(min_exp=-4)], ids=_ids)
def test_qth_attention_matches_reference(kw):
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(3, 12, 16)).astype(np.float32) for _ in range(3))
    valid = np.arange(12)[None, :] < np.array([12, 9, 4])[:, None]
    jspec, tspec = j_qth.QTHSpec(**kw), t_qth.QTHSpec(**kw)
    for kv in (None, valid):
        got = t_qth.qth_attention(*(torch.from_numpy(a) for a in (q, k, v)), tspec,
                                  key_valid=None if kv is None else torch.from_numpy(kv))
        want = j_qth.qth_attention(*(jnp.asarray(a) for a in (q, k, v)), jspec,
                                   key_valid=None if kv is None else jnp.asarray(kv))
        # the weights these outputs mixed with: no flip on this seed
        sc = np.einsum("bqd,bkd->bqk", q, k) / np.float32(np.sqrt(16.0))
        tw = t_qth.qth_attention_weights(torch.from_numpy(sc), tspec,
                                         key_valid=None if kv is None else torch.from_numpy(kv))
        jw = j_qth.qth_attention_weights(jnp.asarray(sc), jspec,
                                         key_valid=None if kv is None else jnp.asarray(kv))
        assert _flips(tw.numpy(), jw) == 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_flip_census(capsys):
    """Factor-2 flips between the packages over 40 seeded calls at the
    serving attention shape (4 heads, 16 tokens) and a wide one (64 keys),
    at most 2 per call; the total is printed (``pytest -s``)."""
    total, calls = 0, 0
    for seed in range(20):
        for shape in ((8, 4, 16, 16), (2, 4, 64, 64)):
            s = _scores(shape=shape, seed=100 + seed, scale=2.0)
            raw = dict(renormalize=False)
            n = _flips(t_qth.qth_attention_weights(torch.from_numpy(s),
                                                   t_qth.QTHSpec(**raw)).numpy(),
                       j_qth.qth_attention_weights(jnp.asarray(s), j_qth.QTHSpec(**raw)))
            assert n <= MAX_FLIPS
            total += n
            calls += 1
    with capsys.disabled():
        print(f"\nqth flip census: {total} flipped coefficients in {calls} calls")


# ---------------------------------------------------------------------------
# the backend with qth=True
# ---------------------------------------------------------------------------

def _cfgs(**vit):
    kw = dict(image_h=64, image_w=64, active_fraction=0.25)
    base = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, qth=True)
    base.update(vit)
    jc = j_vit.ViTConfig(
        frontend=j_fe.FrontendConfig(patch=j_proj.PatchSpec(16, 16, n_vectors=32), **kw), **base)
    tc = t_vit.ViTConfig(
        frontend=t_fe.FrontendConfig(patch=t_proj.PatchSpec(16, 16, n_vectors=32), **kw), **base)
    return jc, tc


@pytest.fixture(scope="module")
def params():
    jc, _ = _cfgs(quant_embed=True)
    jp = j_vit.prepare_quant_embed(j_vit.init_vit(jax.random.PRNGKey(3), jc))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _rgb(seed, b=3, size=64):
    return np.random.default_rng(seed).uniform(size=(b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("quant_embed", [False, True])
@pytest.mark.parametrize("saliency_layers", ["all", "last"])
def test_vit_forward_compact_qth_matches_reference(params, quant_embed, saliency_layers):
    jp, tp = params
    jc, tc = _cfgs(quant_embed=quant_embed, saliency_layers=saliency_layers)
    rgb = _rgb(4)
    jl, ja = j_vit.vit_forward_compact(jp, jnp.asarray(rgb), jc)
    tl, ta = t_vit.vit_forward_compact(tp, torch.from_numpy(rgb), tc)
    np.testing.assert_array_equal(ta["indices"].numpy(), np.asarray(ja["indices"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ta["saliency"].numpy(), np.asarray(ja["saliency"]),
                               atol=ATOL, rtol=0)
    # qth is wired in: the logits move against softmax attention
    l_soft, _ = t_vit.vit_forward_compact(tp, torch.from_numpy(rgb),
                                          dataclasses.replace(tc, qth=False))
    assert not torch.equal(l_soft, tl)


def test_vit_forward_qth_matches_reference(params):
    """The dense path with qth=True, and dense == compact at full cover."""
    jp, tp = params
    jc, tc = _cfgs()
    rgb = _rgb(6)
    jl, ja = j_vit.vit_forward(jp, jnp.asarray(rgb), jc, return_aux=True)
    tl, ta = t_vit.vit_forward(tp, torch.from_numpy(rgb), tc, return_aux=True)
    np.testing.assert_array_equal(ta["mask"].numpy(), np.asarray(ja["mask"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ta["saliency"].numpy(), np.asarray(ja["saliency"]),
                               atol=ATOL, rtol=0)
    full = dataclasses.replace(tc, frontend=dataclasses.replace(tc.frontend,
                                                                active_fraction=1.0))
    np.testing.assert_allclose(t_vit.vit_forward(tp, torch.from_numpy(rgb), full).numpy(),
                               t_vit.vit_forward_compact(tp, torch.from_numpy(rgb),
                                                         full)[0].numpy(), atol=ATOL, rtol=0)


def _codes_fn(cfg, mod):
    return mod.ip2_codes_fn(cfg.frontend.patch, cfg.frontend.adc)


@pytest.mark.parametrize("teacher", [False, True])
def test_staged_engine_qth_matches_reference(params, teacher):
    """The staged engine (codes adapter, w8a8 embed) with qth=True for 3
    ticks with churn and a held stream: logits atol 1e-5, gaze, frame age
    and events exact; teacher-forced copies the reference's selection into
    the port before every tick."""
    jp, tp = params
    jc, tc = _cfgs(quant_embed=True)
    jeng = JEngine(jc, jp, capacity=3, project_fn=_codes_fn(jc, j_ops))
    teng = TEngine(tc, tp, capacity=3, device="cpu", project_fn=_codes_fn(tc, t_ops))
    stream = SceneStream(seed=11, image=64)
    schedule = [(["a", "b", "c"], [], ["a", "b", "c"]), ([], [], ["a", "c"]),
                (["d"], ["a"], ["b", "c", "d"])]
    for t, (admits, evicts, fed) in enumerate(schedule):
        for sid in evicts:
            jeng.evict(sid)
            teng.evict(sid)
        for sid in admits:
            assert jeng.admit(sid) == teng.admit(sid)
        rgb, _ = stream.batch(t, len(fed))
        frames = {s: rgb[i] for i, s in enumerate(fed)}
        if teacher:
            teng._state = teng.state._replace(
                indices=torch.from_numpy(np.array(jeng.state.indices)))
        jout, tout = jeng.step(frames), teng.step(frames)
        for sid in fed:
            np.testing.assert_allclose(tout[sid], jout[sid], atol=ATOL, rtol=0,
                                       err_msg=f"tick {t} stream {sid}")
            np.testing.assert_array_equal(teng.gaze(sid), np.asarray(jeng.gaze(sid)))
            for a, b in zip(teng.events(sid), jeng.events(sid)):
                assert a == b
    np.testing.assert_array_equal(teng.state.frame_age.numpy(), np.asarray(jeng.state.frame_age))


def _gated_cfgs():
    kw = dict(image_h=64, image_w=64, active_fraction=0.25)
    vit = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, quant_embed=True, qth=True,
               saliency_layers="last", delta_kernel=True)
    jc = j_vit.ViTConfig(frontend=j_fe.FrontendConfig(
        patch=j_proj.PatchSpec(16, 16, n_vectors=32,
                               summer=j_sc.SummerSpec(mode="passive", hold_time_s=0.0)),
        temporal=j_tm.TemporalSpec(delta_threshold=1e-3, recompute_budget=2), **kw), **vit)
    tc = t_vit.ViTConfig(frontend=t_fe.FrontendConfig(
        patch=t_proj.PatchSpec(16, 16, n_vectors=32,
                               summer=t_sc.SummerSpec(mode="passive", hold_time_s=0.0)),
        temporal=t_tm.TemporalSpec(delta_threshold=1e-3, recompute_budget=2), **kw), **vit)
    return jc, tc


@pytest.mark.parametrize("teacher", [False, True])
def test_gated_engine_qth_never_reaches_delta_attention(params, teacher, monkeypatch):
    """The gated engine (temporal gate, governor, delta backend with
    ``delta_kernel=True``) with qth=True: qth excludes the ragged attention
    kernel by design, so neither ``ops.delta_attention`` nor its plain
    version is called, while the engine matches the reference tick for
    tick (logits atol 1e-5; gaze, n_stale, j_cap, tier, cached, events
    exact)."""
    jp, tp = params
    jc, tc = _gated_cfgs()

    def refuse(*a, **kw):
        raise AssertionError("qth reached the ragged attention kernel")

    monkeypatch.setattr(t_ops, "delta_attention", refuse)
    monkeypatch.setattr(t_ref, "delta_attention_ref", refuse)
    gov = dict(budget_mw=0.4, backend_eps=1e-3, refresh_horizon=2)
    jeng = JEngine(jc, jp, capacity=3, temporal=True, governor=j_gov.GovernorSpec(**gov),
                   backend_delta=True, project_fn=_codes_fn(jc, j_ops))
    teng = TEngine(tc, tp, capacity=3, temporal=True, governor=t_gov.GovernorSpec(**gov),
                   backend_delta=True, project_fn=_codes_fn(tc, t_ops), device="cpu")
    pool, _ = SceneStream(seed=11, image=64).batch(0, 4)
    for sid in ("a", "b", "c"):
        assert jeng.admit(sid) == teng.admit(sid)
    cached = []
    t_ops.reset_launches()
    for t in range(5):
        fed = ["a", "b", "c"] if t != 3 else ["a", "c"]
        frames = {s: pool[(i + t // 2) % 4] for i, s in enumerate(fed)}
        if teacher:
            teng._state = teng.state._replace(
                indices=torch.from_numpy(np.array(jeng.state.indices)))
        jout, tout = jeng.step(frames), teng.step(frames)
        np.testing.assert_array_equal(teng.state.cache.features.numpy(),
                                      np.asarray(jeng.state.cache.features))
        for name in ("j_cap", "tier"):
            np.testing.assert_array_equal(getattr(teng.state.controls, name).numpy(),
                                          np.asarray(getattr(jeng.state.controls, name)))
        for sid in fed:
            np.testing.assert_allclose(tout[sid], jout[sid], atol=ATOL, rtol=0,
                                       err_msg=f"tick {t} stream {sid}")
            np.testing.assert_array_equal(teng.gaze(sid), np.asarray(jeng.gaze(sid)))
            assert teng.backend_cached(sid) == jeng.backend_cached(sid)
            for a, b in zip(teng.events(sid), jeng.events(sid)):
                assert a == b
            cached.append(teng.backend_cached(sid))
    assert t_ops.LAUNCHES["delta_attention"] == 0
    assert False in cached
