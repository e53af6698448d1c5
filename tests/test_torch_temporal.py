"""Port parity: the temporal gate (``core/temporal.py``) and the gated
compact frontend against the JAX package, same numpy inputs.

Integers (stale indices, ``needed``, ``n_stale``, ages, valid bits, event
counts) are exact; ADC codes are exact apart from 1-LSB flips on a counted,
bounded number of rows (XLA and PyTorch order the projection's fp32 sums
differently); floats (energies, gains) within atol 1e-6. The clip is
teacher-forced: every frame starts both packages from the reference's
cache and selection.
"""

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
from repro_torch.core import frontend as t_fe
from repro_torch.core import projection as t_proj
from repro_torch.core import switched_cap as t_sc
from repro_torch.core import temporal as t_tm
from repro_torch.data.pipeline import SceneStream
from repro_torch.kernels import ops as t_ops

ATOL = 1e-6
MAX_FLIP_ROWS = 2


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _cfgs(summer="opamp", budget=2, threshold=1e-3):
    kw = dict(image_h=64, image_w=64, active_fraction=0.25)
    js = j_sc.SummerSpec(mode=summer, hold_time_s=0.0 if summer == "passive" else 10e-6)
    ts = t_sc.SummerSpec(mode=summer, hold_time_s=js.hold_time_s)
    jc = j_fe.FrontendConfig(
        patch=j_proj.PatchSpec(16, 16, n_vectors=32, summer=js),
        temporal=j_tm.TemporalSpec(delta_threshold=threshold, recompute_budget=budget), **kw)
    tc = t_fe.FrontendConfig(
        patch=t_proj.PatchSpec(16, 16, n_vectors=32, summer=ts),
        temporal=t_tm.TemporalSpec(delta_threshold=threshold, recompute_budget=budget), **kw)
    return jc, tc


def _cache_to_torch(jcache):
    return t_tm.FeatureCache(*(_t(x) for x in jcache))


def _random_cache(jc, rng, batch=3):
    p, m = jc.n_patches, jc.patch.n_vectors
    return j_tm.FeatureCache(
        features=jnp.asarray(rng.integers(-128, 128, (batch, p, m)).astype(np.int8)),
        energy=jnp.asarray(rng.uniform(0, 0.01, (batch, p)).astype(np.float32)),
        age=jnp.asarray(rng.integers(0, 6, (batch, p)).astype(np.int32)),
        valid=jnp.asarray(rng.random((batch, p)) < 0.6),
        n_stale=jnp.zeros((batch,), jnp.int32))


def _select_both(jc, tc, energy, idx, jcache, sel_valid=None, cap=None):
    jout = j_tm.select_stale(
        jnp.asarray(energy), jnp.asarray(idx), jcache, jc.temporal, jc.patch.summer,
        jc.adc, sel_valid=None if sel_valid is None else jnp.asarray(sel_valid),
        cap=None if cap is None else jnp.asarray(cap))
    tout = t_tm.select_stale(
        _t(energy), _t(idx), _cache_to_torch(jcache), tc.temporal, tc.patch.summer,
        tc.adc, sel_valid=None if sel_valid is None else _t(sel_valid),
        cap=None if cap is None else _t(cap))
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return tout


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_stale_matches_reference(seed):
    jc, tc = _cfgs()
    rng = np.random.default_rng(seed)
    jcache = _random_cache(jc, rng)
    energy = rng.uniform(0, 0.01, (3, jc.n_patches)).astype(np.float32)
    idx = np.stack([rng.permutation(jc.n_patches)[:jc.n_active] for _ in range(3)]).astype(np.int32)
    _select_both(jc, tc, energy, idx, jcache)
    sel_valid = np.arange(jc.n_active)[None, :] < np.array([[4], [3], [1]])
    _select_both(jc, tc, energy, idx, jcache, sel_valid=sel_valid)
    _select_both(jc, tc, energy, idx, jcache, sel_valid=sel_valid,
                 cap=np.array([2, 1, 0], np.int32))


def test_select_stale_ties_take_the_lower_position():
    """Every patch never computed and no energy: every score ties, and both
    packages take the first j positions of the selection, in order."""
    jc, tc = _cfgs()
    p = jc.n_patches
    jcache = j_tm.init_feature_cache(jc, (2,))
    energy = np.zeros((2, p), np.float32)
    idx = np.array([[5, 1, 9, 3], [0, 15, 7, 2]], np.int32)
    stale_idx, needed, n_stale = _select_both(jc, tc, energy, idx, jcache)
    np.testing.assert_array_equal(stale_idx.numpy(), idx[:, :2])
    assert needed.all() and (n_stale.numpy() == 2).all()


def test_max_hold_frames_and_budget():
    for summer in ("opamp", "passive"):
        jc, tc = _cfgs(summer)
        assert tc.temporal.max_hold_frames(tc.patch.summer, tc.adc) == \
            jc.temporal.max_hold_frames(jc.patch.summer, jc.adc)
    assert t_tm.TemporalSpec(recompute_budget=9).budget(4) == 4
    with pytest.raises(ValueError):
        t_tm.TemporalSpec(recompute_budget=0).budget(4)


@pytest.mark.parametrize("summer", ["opamp", "passive"])
def test_refresh_and_held_gain(summer):
    jc, tc = _cfgs(summer)
    rng = np.random.default_rng(7)
    jcache = _random_cache(jc, rng)
    energy = rng.uniform(0, 0.01, (3, jc.n_patches)).astype(np.float32)
    idx = np.stack([rng.permutation(jc.n_patches)[:jc.n_active] for _ in range(3)]).astype(np.int32)
    st_idx, needed, n_stale = (np.asarray(x) for x in j_tm.select_stale(
        jnp.asarray(energy), jnp.asarray(idx), jcache, jc.temporal, jc.patch.summer, jc.adc))
    new = rng.integers(-128, 128, (3, 2, jc.patch.n_vectors)).astype(np.int8)
    jr = j_tm.refresh(jcache, jnp.asarray(st_idx), jnp.asarray(needed), jnp.asarray(new),
                      jnp.asarray(energy), jnp.asarray(n_stale))
    tr = t_tm.refresh(_cache_to_torch(jcache), _t(st_idx), _t(needed), _t(new),
                      _t(energy), _t(n_stale))
    for a, b in zip(tr, jr):
        assert a.dtype == _t(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jg = np.asarray(j_tm.held_gain(jr, jnp.asarray(idx), jc.patch.summer))
    tg = t_tm.held_gain(tr, _t(idx), tc.patch.summer).numpy()
    np.testing.assert_allclose(tg, jg, atol=ATOL, rtol=0)
    assert (tg[~np.asarray(j_tm.take_rows(jr.valid, jnp.asarray(idx)))] == 0).all()
    if summer == "passive":
        np.testing.assert_array_equal(tg, jg)   # d = 1: gains are exactly 0 or 1


def _flip_rows(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert d.max() <= 1, f"code difference {d.max()} > 1 LSB"
    rows = int((d.reshape(-1, d.shape[-1]).max(-1) > 0).sum())
    assert rows <= MAX_FLIP_ROWS, f"{rows} rows moved by 1 LSB"
    return rows


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_gated_frontend_clip_teacher_forced(route):
    """Six frames of a clip whose scenes change every other frame, with the
    governor's knobs moving: selection, stale sets, cache and events."""
    jc, tc = _cfgs("passive")
    rng = np.random.default_rng(11)
    pool, _ = SceneStream(seed=5, image=64).batch(0, 4)
    jparams = {"a_rgb": jnp.asarray((rng.normal(size=(32, 768)) * 6.4).astype(np.float32)),
               "bias": jnp.asarray((rng.normal(size=(32,)) * 0.05).astype(np.float32))}
    tparams = {k: _t(v) for k, v in jparams.items()}
    kw_j = kw_t = {}
    if route == "kernel":
        kw_j = {"project_fn": j_ops.ip2_codes_fn(jc.patch, jc.adc)}
        kw_t = {"project_fn": t_ops.ip2_codes_fn(tc.patch, tc.adc)}
    jfront = jax.jit(lambda rgb, idx, cache, k_cap, stale_cap: j_fe.apply_frontend(
        jparams, rgb, jc, mode="compact", indices=idx, cache=cache, k_cap=k_cap,
        stale_cap=stale_cap, **kw_j))
    jcache = j_tm.init_feature_cache(jc, (2,))
    flips = 0
    for t in range(6):
        rgb = np.stack([pool[(t // 2) % 4], pool[(t // 2 + 1) % 4]])
        idx = np.stack([rng.permutation(jc.n_patches)[:jc.n_active] for _ in range(2)])
        k_cap = np.array([4 - t % 3, 4], np.int32)
        stale_cap = np.array([2, t % 3], np.int32)
        jcf, jnew = jfront(jnp.asarray(rgb), jnp.asarray(idx), jcache,
                           jnp.asarray(k_cap), jnp.asarray(stale_cap))
        tcf, tnew = t_fe.apply_frontend(
            tparams, _t(rgb), tc, mode="compact", indices=_t(idx), cache=_cache_to_torch(jcache),
            k_cap=_t(k_cap), stale_cap=_t(stale_cap), **kw_t)
        assert tcf.features.dtype == torch.int8
        flips += _flip_rows(tcf.features.numpy(), np.asarray(jcf.features))
        flips += _flip_rows(tnew.features.numpy(), np.asarray(jnew.features))
        for name in ("indices", "valid"):
            np.testing.assert_array_equal(getattr(tcf, name).numpy(),
                                          np.asarray(getattr(jcf, name)))
        for name in ("energy", "gain", "zero", "scale"):
            np.testing.assert_allclose(getattr(tcf, name).numpy(),
                                       np.asarray(getattr(jcf, name)), atol=ATOL, rtol=0)
        for a, b in zip(tcf.events, jcf.events):
            np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b))
        for name in ("age", "valid", "n_stale"):
            np.testing.assert_array_equal(getattr(tnew, name).numpy(),
                                          np.asarray(getattr(jnew, name)))
        np.testing.assert_allclose(tnew.energy.numpy(), np.asarray(jnew.energy),
                                   atol=ATOL, rtol=0)
        assert (tnew.n_stale.numpy() <= np.minimum(stale_cap, k_cap)).all()
        jcache = jnew                             # teacher forcing
    assert flips <= MAX_FLIP_ROWS


def test_gated_frontend_errors():
    _, tc = _cfgs()
    params = {"a_rgb": torch.zeros(32, 768), "bias": torch.zeros(32)}
    rgb = torch.zeros((1, 64, 64, 3))
    with pytest.raises(ValueError, match="stale_cap"):
        t_fe.apply_frontend(params, rgb, tc, mode="compact", stale_cap=torch.tensor([1]))
    with pytest.raises(ValueError, match="k_cap"):
        t_fe.apply_frontend(params, rgb, tc, mode="compact",
                            mask=torch.ones((1, 16), dtype=torch.bool), k_cap=torch.tensor([2]))
    bad = t_tm.init_feature_cache(tc, (1,), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        t_fe.apply_frontend(params, rgb, tc, mode="compact", cache=bad)
