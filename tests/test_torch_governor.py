"""Port parity: the power governor (``serve/governor.py``) and the meter's
governor-facing prices against the JAX package, same numpy inputs.

``j_cap`` and ``tier`` are exact; floats (budgets, eps, milliwatts) within
1e-6 relative. The budgets are placed on both sides of the affordable
allocation's floor boundaries, where a reciprocal multiply in place of the
reference's division would move ``j_cap`` by one.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import power as j_pw
from repro.serve import governor as j_gov
from repro_torch.core import power as t_pw
from repro_torch.serve import governor as t_gov

# the serving path's frontend: 256x256 frames, 32x32 patches, M = 192, k = 16, j = 8
N_PIXELS, PPP, M, K, J_MAX, HZ = 65536.0, 1024, 192, 16, 8, 30.0


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _specs(**kw):
    return j_gov.GovernorSpec(**kw), t_gov.GovernorSpec(**kw)


def _controls(rng, s):
    j_cap = rng.integers(1, J_MAX + 1, s).astype(np.int32)
    tier = rng.integers(0, 4, s).astype(np.int32)
    eps = np.where(rng.random(s) < 0.5, 1e-3, 0.0).astype(np.float32)
    return j_cap, tier, eps


def test_meter_prices_match_reference():
    jm, tm = j_pw.EnergyMeter(), t_pw.EnergyMeter()
    assert tm.slot_recompute_power_w(PPP, M, HZ) == jm.slot_recompute_power_w(PPP, M, HZ)
    n = np.array([0.0, 3.0, 16.0], np.float32)
    kw = dict(j_embed=_t(n), j_qkv=[_t(n), _t(n / 2)], q_attn=[_t(n), _t(n)],
              n_keys=_t(n), computed=1.0)
    jkw = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
               else [jnp.asarray(x.numpy()) for x in v] if isinstance(v, list) else v)
           for k, v in kw.items()}
    np.testing.assert_array_equal(t_pw.backend_frame_macs(M, 256, 1024, 4, **kw).numpy(),
                                  np.asarray(j_pw.backend_frame_macs(M, 256, 1024, 4, **jkw)))
    assert t_pw.dense_backend_macs(16, 6, M, 256, 1024, 4) == \
        j_pw.dense_backend_macs(16, 6, M, 256, 1024, 4)


@pytest.mark.parametrize("backend_eps", [0.0, 1e-3])
def test_control_update_across_floor_boundaries(backend_eps):
    js, ts = _specs(budget_mw=100.0, backend_eps=backend_eps)
    # no DAC, CDS or dump energy: the fixed power is 0, so a budget's own
    # float32 steps reach the quotient's, and n·slot_mw lands on n exactly
    const = dict(e_dac_j=0.0, cap_f=0.0, e_pixel_dump_j=0.0)
    jm = j_pw.EnergyMeter(j_pw.EnergyConstants(**const))
    tm = t_pw.EnergyMeter(t_pw.EnergyConstants(**const))
    rng = np.random.default_rng(0)
    s = 9 * 11
    j_cap, tier, eps = _controls(rng, s)
    k_eff = np.asarray(j_gov.tier_k_eff(js, jnp.asarray(tier), K))
    slot_mw = np.float32(1e3 * jm.slot_recompute_power_w(PPP, M, HZ))
    # budgets within 4 float32 steps of n·slot_mw, n = 1 .. 11
    n = np.repeat(np.arange(1, 12), 9)
    budget = (n * np.float64(slot_mw)).astype(np.float32)
    for i, step in enumerate(np.tile(np.arange(-4, 5), 11)):
        for _ in range(abs(step)):
            budget[i] = np.nextafter(budget[i], np.float32(np.sign(step) * np.inf))
    # the test tells a true division from a multiply by the reciprocal
    assert (np.floor(budget / slot_mw)
            != np.floor(budget * (np.float32(1.0) / slot_mw))).any()
    n_stale = rng.integers(0, J_MAX + 1, s).astype(np.float32)
    active = rng.random(s) < 0.85
    ev = j_pw.frontend_frame_events(N_PIXELS, PPP, M, n_selected_patches=jnp.asarray(
        k_eff.astype(np.float32)), n_converted_patches=jnp.asarray(n_stale))
    ev = ev._replace(backend_macs=jnp.asarray(rng.uniform(0, 8e7, s).astype(np.float32)))
    ev = j_pw.EventCounts(*(e * jnp.asarray(active, jnp.float32) for e in ev))
    jc = j_gov.GovernorControls(jnp.asarray(j_cap), jnp.asarray(tier), jnp.asarray(budget),
                                jnp.asarray(eps))
    tc = t_gov.GovernorControls(_t(j_cap), _t(tier), _t(budget), _t(eps))
    t_ev = t_pw.EventCounts(*(_t(e) for e in ev))
    backend_mw = 2.5
    for _ in range(4):     # a few ticks, each fed the reference's new controls
        jn = j_gov.control_update(js, jc, ev, jnp.asarray(active), jm, HZ, N_PIXELS, PPP, M,
                                  J_MAX, K, backend_mw=backend_mw)
        tn = t_gov.control_update(ts, tc, t_ev, _t(active), tm, HZ, N_PIXELS, PPP, M,
                                  J_MAX, K, backend_mw=backend_mw)
        np.testing.assert_array_equal(tn.j_cap.numpy(), np.asarray(jn.j_cap))
        np.testing.assert_array_equal(tn.tier.numpy(), np.asarray(jn.tier))
        np.testing.assert_array_equal(tn.budget_mw.numpy(), np.asarray(jn.budget_mw))
        np.testing.assert_allclose(tn.eps.numpy(), np.asarray(jn.eps), rtol=1e-6, atol=0)
        assert tn.j_cap.dtype == tn.tier.dtype == torch.int32
        jc, tc = jn, t_gov.GovernorControls(*(_t(x) for x in jn))
    assert len(set(np.asarray(jn.j_cap).tolist())) > 2, "the caps never spread"


def test_tiers_budgets_and_resets():
    js, ts = _specs(budget_mw=10.0)
    tier = np.array([0, 1, 2, 3, 3, 0], np.int32)
    np.testing.assert_array_equal(t_gov.tier_k_eff(ts, _t(tier), K).numpy(),
                                  np.asarray(j_gov.tier_k_eff(js, jnp.asarray(tier), K)))
    assert not t_gov.tier_is_sign(ts, _t(tier)).any()
    assert ts.tier_tokens(K) == js.tier_tokens(K)
    prio = np.array([1.0, 0.0, 4.0, 0.25, 0.0, 2.0])
    np.testing.assert_array_equal(t_gov.allocate_budgets(ts, prio),
                                  j_gov.allocate_budgets(js, prio))
    np.testing.assert_array_equal(t_gov.allocate_budgets(ts, prio, total_mw=3.0),
                                  j_gov.allocate_budgets(js, prio, total_mw=3.0))
    assert not t_gov.allocate_budgets(ts, np.zeros(3)).any()
    rng = np.random.default_rng(1)
    j_cap, tier, eps = _controls(rng, 6)
    budget = rng.uniform(0, 5, 6).astype(np.float32)
    hit = np.array([True, False, True, False, False, True])
    jr = j_gov.reset_rows(j_gov.GovernorControls(*map(jnp.asarray, (j_cap, tier, budget, eps))),
                          jnp.asarray(hit), J_MAX)
    tr = t_gov.reset_rows(t_gov.GovernorControls(*map(_t, (j_cap, tier, budget, eps))),
                          _t(hit), J_MAX)
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(t_gov.init_controls(5, J_MAX, device="cpu"),
                    j_gov.init_controls(5, J_MAX)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fixed_power_mw_by_keyword_matches_reference():
    """Both packages take ``fixed_power_mw``'s arguments by the reference's
    names, ``spec_meter`` first."""
    k_eff = np.array([2, 4, 8], np.int32)
    kw = dict(n_pixels=N_PIXELS, pixels_per_patch=PPP, n_vectors=M, frame_hz=HZ)
    want = np.asarray(j_gov.fixed_power_mw(spec_meter=j_pw.EnergyMeter(),
                                           k_eff=jnp.asarray(k_eff), **kw))
    got = t_gov.fixed_power_mw(spec_meter=t_pw.EnergyMeter(), k_eff=_t(k_eff), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_spec_validation_and_sign_tier():
    for bad in (dict(budget_mw=0.0), dict(budget_mw=1.0, floor=0),
                dict(budget_mw=1.0, backend_eps=-1.0),
                dict(budget_mw=1.0, k_tiers=(0.5, 1.0)),
                dict(budget_mw=1.0, k_tiers=(1.0, 0.25, 0.5))):
        with pytest.raises(ValueError):
            t_gov.GovernorSpec(**bad)
    assert [f.name for f in dataclasses.fields(t_gov.GovernorSpec)] == \
        [f.name for f in dataclasses.fields(j_gov.GovernorSpec)]
    js, ts = _specs(budget_mw=1.0, sign_tier=True)
    tier = np.array([0, 1, 2, 3, 4, 4, 3], np.int32)
    np.testing.assert_array_equal(t_gov.tier_is_sign(ts, _t(tier)).numpy(),
                                  np.asarray(j_gov.tier_is_sign(js, jnp.asarray(tier))))
    assert t_gov.tier_is_sign(ts, _t(tier)).sum() == 2
    np.testing.assert_array_equal(t_gov.tier_k_eff(ts, _t(tier), K).numpy(),
                                  np.asarray(j_gov.tier_k_eff(js, jnp.asarray(tier), K)))


def test_control_update_sign_tier_across_its_floor():
    """The sign rung (3b) with ``sign_tier=True``: budgets within a few
    float32 steps of the finest tier's floor (where a slot enters the sign
    tier) and of floor / (1 - deadband) (where it may leave it), over ticks
    that step every slot down into the sign tier and back up; tier exact,
    j_cap exact, eps within 1e-6 relative."""
    js, ts = _specs(budget_mw=1.0, sign_tier=True, backend_eps=1e-3)
    jm, tm = j_pw.EnergyMeter(), t_pw.EnergyMeter()
    slot_mw = 1e3 * jm.slot_recompute_power_w(PPP, M, HZ)
    k_min = js.tier_tokens(K)[-1]
    fixed_min = float(np.asarray(j_gov.fixed_power_mw(
        jm, N_PIXELS, PPP, M, jnp.full((1,), k_min, jnp.int32), HZ))[0])
    floor_mw = fixed_min + js.floor * slot_mw
    edges = (floor_mw, floor_mw / (1.0 - js.deadband))
    budget = []
    for edge in edges:
        b0 = np.float32(edge)
        for step in range(-3, 4):
            b = b0
            for _ in range(abs(step)):
                b = np.nextafter(b, np.float32(np.sign(step) * np.inf))
            budget.append(b)
    budget = np.array(budget + [np.float32(floor_mw * 0.5), np.float32(floor_mw * 3.0)],
                      np.float32)
    s = budget.shape[0]
    rng = np.random.default_rng(3)
    j_cap = rng.integers(1, J_MAX + 1, s).astype(np.int32)
    tier = rng.integers(0, 5, s).astype(np.int32)
    eps = np.zeros(s, np.float32)
    active = np.ones(s, bool)
    active[1] = False
    jc = j_gov.GovernorControls(*map(jnp.asarray, (j_cap, tier, budget, eps)))
    tc = t_gov.GovernorControls(*map(_t, (j_cap, tier, budget, eps)))
    seen = set()
    for tick in range(10):
        # executed events: the finest tier's selection with j_cap converted
        k_eff = np.asarray(j_gov.tier_k_eff(js, jc.tier, K)).astype(np.float32)
        ev = j_pw.frontend_frame_events(N_PIXELS, PPP, M, n_selected_patches=jnp.asarray(
            k_eff), n_converted_patches=jnp.asarray(np.asarray(jc.j_cap, np.float32)))
        ev = j_pw.EventCounts(*(e * jnp.asarray(active, jnp.float32) for e in ev))
        jn = j_gov.control_update(js, jc, ev, jnp.asarray(active), jm, HZ, N_PIXELS, PPP,
                                  M, J_MAX, K, backend_mw=0.5)
        tn = t_gov.control_update(ts, tc, t_pw.EventCounts(*(_t(e) for e in ev)),
                                  _t(active), tm, HZ, N_PIXELS, PPP, M, J_MAX, K,
                                  backend_mw=0.5)
        np.testing.assert_array_equal(tn.tier.numpy(), np.asarray(jn.tier), f"tick {tick}")
        np.testing.assert_array_equal(tn.j_cap.numpy(), np.asarray(jn.j_cap))
        np.testing.assert_allclose(tn.eps.numpy(), np.asarray(jn.eps), rtol=1e-6, atol=0)
        seen.update(np.asarray(jn.tier).tolist())
        jc, tc = jn, t_gov.GovernorControls(*(_t(x) for x in jn))
    sign = np.asarray(j_gov.tier_is_sign(js, jc.tier))
    assert 4 in seen and sign.any() and not sign.all(), (seen, sign)
    # recovery: a slack budget climbs every slot back out, one tier a tick
    jc = jc._replace(budget_mw=jnp.full((s,), 100.0, jnp.float32))
    tc = tc._replace(budget_mw=torch.full((s,), 100.0))
    for tick in range(6):
        jn = j_gov.control_update(js, jc, ev, jnp.asarray(active), jm, HZ, N_PIXELS, PPP,
                                  M, J_MAX, K)
        tn = t_gov.control_update(ts, tc, t_pw.EventCounts(*(_t(e) for e in ev)),
                                  _t(active), tm, HZ, N_PIXELS, PPP, M, J_MAX, K)
        np.testing.assert_array_equal(tn.tier.numpy(), np.asarray(jn.tier), f"up {tick}")
        jc, tc = jn, t_gov.GovernorControls(*(_t(x) for x in jn))
    assert not np.asarray(j_gov.tier_is_sign(js, jc.tier))[active].any()


def test_control_update_at_budgets_past_the_int32_range():
    """A slack budget of 1e8 mW and more affords more than 2**31 rows: the
    reference's cast saturates there (and j_cap stays at j_max), so the
    port's must too, where PyTorch's own cast would wrap to -2**31 and drop
    j_cap to the floor."""
    js, ts = _specs(budget_mw=1e9, backend_eps=1e-3)
    jm, tm = j_pw.EnergyMeter(), t_pw.EnergyMeter()
    rng = np.random.default_rng(1)
    s = 8
    j_cap, tier, eps = _controls(rng, s)
    budget = np.array([1e6, 1e8, 1e9, 3e9, 1e12, 1e30, np.inf, 50.0], np.float32)
    active = np.ones(s, bool)
    ev = j_pw.frontend_frame_events(N_PIXELS, PPP, M, n_selected_patches=jnp.full(
        (s,), float(K)), n_converted_patches=jnp.full((s,), 4.0))
    jc = j_gov.GovernorControls(jnp.asarray(j_cap), jnp.asarray(tier), jnp.asarray(budget),
                                jnp.asarray(eps))
    tc = t_gov.GovernorControls(_t(j_cap), _t(tier), _t(budget), _t(eps))
    t_ev = t_pw.EventCounts(*(_t(np.asarray(e)) for e in ev))
    for _ in range(J_MAX):   # the slew climbs one row a tick
        jn = j_gov.control_update(js, jc, ev, jnp.asarray(active), jm, HZ, N_PIXELS, PPP, M,
                                  J_MAX, K)
        tn = t_gov.control_update(ts, tc, t_ev, _t(active), tm, HZ, N_PIXELS, PPP, M,
                                  J_MAX, K)
        np.testing.assert_array_equal(tn.j_cap.numpy(), np.asarray(jn.j_cap))
        np.testing.assert_array_equal(tn.tier.numpy(), np.asarray(jn.tier))
        jc, tc = jn, t_gov.GovernorControls(*(_t(np.asarray(x)) for x in jn))
    # the finite budgets climb to j_max; at inf the deadband holds j_cap
    assert (np.asarray(jn.j_cap)[:6] == J_MAX).all()


def test_to_int32_saturates_like_jax():
    from repro_torch._arith import to_int32

    x = np.array([0.0, -0.5, 2.9, -2.9, 2147483520.0, 2147483648.0, 3e10, -3e10,
                  -2147483648.0, np.inf, -np.inf, np.nan], np.float32)
    got = to_int32(_t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(x).astype(jnp.int32)))
