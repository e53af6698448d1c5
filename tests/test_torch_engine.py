"""Port parity: ``SaccadeEngine`` against the JAX engine, on an admit /
evict / partial-fed schedule: plain mode on both kernel routes, and the
gated engine (temporal gate, power governor, delta-gated backend).

Per tick: logits at atol 1e-5 (backend fp32 sum order), next gaze and
energy events exact, held slots bitwise frozen in the port. Free-running
runs the port on its own selections; the seed is one on which no ADC code
moves (the flip count is asserted 0 every tick), so the two trajectories
must stay identical. Teacher-forced runs copy the reference's selection
into the port before every tick.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontend as j_fe
from repro.core.power import EnergyMeter
from repro.core import projection as j_proj
from repro.core import switched_cap as j_sc
from repro.core import temporal as j_tm
from repro.kernels import ops as j_ops
from repro.models import vit as j_vit
from repro.serve import governor as j_gov
from repro.serve import serve_step as j_ss
from repro.serve.engine import SaccadeEngine as JEngine
from repro_torch.convert import params_from_numpy
from repro_torch.core import frontend as t_fe
from repro_torch.core import projection as t_proj
from repro_torch.core import switched_cap as t_sc
from repro_torch.core import temporal as t_tm
from repro_torch.data.pipeline import SceneStream
from repro_torch.kernels import ops as t_ops
from repro_torch.models import vit as t_vit
from repro_torch.serve import governor as t_gov
from repro_torch.serve.engine import SaccadeEngine as TEngine

ATOL = 1e-5
# (admits, evicts, fed) per tick; evicts run before admits
SCHEDULE = [
    (["a", "b"], [], ["a", "b"]),
    (["c"], [], ["a", "c"]),            # b holds
    (["d"], ["a"], ["b", "c", "d"]),    # d recycles a's slot
    ([], [], ["d"]),                    # b and c hold
    (["e"], ["b"], ["c", "d"]),         # e admitted, never fed
]


def _cfgs(fused):
    kw = dict(image_h=64, image_w=64, active_fraction=0.25)
    jc = j_vit.ViTConfig(
        frontend=j_fe.FrontendConfig(patch=j_proj.PatchSpec(16, 16, n_vectors=32), **kw),
        n_layers=2, d_model=64, n_heads=4, d_ff=128, quant_embed=True, fused_embed=fused)
    tc = t_vit.ViTConfig(
        frontend=t_fe.FrontendConfig(patch=t_proj.PatchSpec(16, 16, n_vectors=32), **kw),
        n_layers=2, d_model=64, n_heads=4, d_ff=128, quant_embed=True, fused_embed=fused)
    return jc, tc


@pytest.fixture(scope="module")
def params():
    jc, _ = _cfgs(False)
    jp = j_vit.prepare_quant_embed(j_vit.init_vit(jax.random.PRNGKey(0), jc))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _flips(jc, tc, jp, tp, rgb, idx):
    """ADC codes that differ between the two packages for these patches."""
    jcf = j_fe.apply_frontend(
        jp["ip2"], jnp.asarray(rgb), jc.frontend, mode="compact", indices=jnp.asarray(idx),
        project_fn=j_ops.ip2_codes_fn(jc.frontend.patch, jc.frontend.adc))
    tcf = t_fe.apply_frontend(
        tp["ip2"], torch.from_numpy(rgb), tc.frontend, mode="compact",
        indices=torch.from_numpy(idx),
        project_fn=t_ops.ip2_codes_fn(tc.frontend.patch, tc.frontend.adc))
    return int((tcf.features.numpy() != np.asarray(jcf.features)).sum())


@pytest.mark.parametrize("fused,teacher", [(False, False), (False, True), (True, False)])
def test_engine_schedule_matches_reference(params, fused, teacher):
    jc, tc = _cfgs(fused)
    jp, tp = params
    kw_j = {} if fused else {"project_fn": j_ops.ip2_codes_fn(jc.frontend.patch, jc.frontend.adc)}
    kw_t = {} if fused else {"project_fn": t_ops.ip2_codes_fn(tc.frontend.patch, tc.frontend.adc)}
    jeng = JEngine(jc, jp, capacity=3, **kw_j)
    teng = TEngine(tc, tp, capacity=3, device="cpu", **kw_t)
    boot = j_ss.make_bootstrap_indices(jc)
    stream = SceneStream(seed=11, image=64)
    for t, (admits, evicts, fed) in enumerate(SCHEDULE):
        for sid in evicts:
            jeng.evict(sid)
            teng.evict(sid)
        for sid in admits:
            assert jeng.admit(sid) == teng.admit(sid)
        assert teng.stream_ids == jeng.stream_ids
        assert teng.free_slots == jeng.free_slots
        rgb, _ = stream.batch(t, len(fed))
        frames = {sid: rgb[i] for i, sid in enumerate(fed)}
        if teacher:
            teng._state = teng.state._replace(
                indices=torch.from_numpy(np.array(jeng.state.indices)))
        # the selection each fed stream uses this tick: gaze, or bootstrap
        used = np.stack([np.asarray(jeng.gaze(s)) if int(jeng.state.frame_age[
            jeng.slot_of(s)]) else np.asarray(boot(jp, jnp.asarray(rgb[i:i + 1])))[0]
            for i, s in enumerate(fed)])
        assert _flips(jc, tc, jp, tp, rgb, used) == 0, f"tick {t}: a code moved"
        before = teng.state
        held = [teng.slot_of(s) for s in teng.stream_ids if s not in frames]
        jout = jeng.step(frames)
        tout = teng.step(frames)
        assert tout.keys() == jout.keys()
        for sid in fed:
            np.testing.assert_allclose(tout[sid], jout[sid], atol=ATOL, rtol=0,
                                       err_msg=f"tick {t} stream {sid}")
            np.testing.assert_array_equal(teng.gaze(sid), np.asarray(jeng.gaze(sid)))
            for a, b in zip(teng.events(sid, "mean"), jeng.events(sid, "mean")):
                assert a == b
            assert teng.power_mw(sid) == pytest.approx(jeng.power_mw(sid), rel=1e-6)
        after = teng.state
        for s in held:
            for name in ("indices", "ema", "frame_age"):
                assert torch.equal(getattr(after, name)[s], getattr(before, name)[s])
            for a, b in zip(after.events_last + after.events_mean,
                            before.events_last + before.events_mean):
                assert torch.equal(a[s], b[s])
        assert teng.fleet_power_mw() == pytest.approx(jeng.fleet_power_mw(), rel=1e-6)
    np.testing.assert_array_equal(teng.state.frame_age.numpy(),
                                  np.asarray(jeng.state.frame_age))
    np.testing.assert_array_equal(teng.state.active.numpy(), np.asarray(jeng.state.active))


def _gated_cfgs(delta_kernel=True):
    """The gated serving configuration at test size: droop-free summer,
    temporal gate with j = 2 of k = 4, delta backend on the last layer's
    saliency."""
    kw = dict(image_h=64, image_w=64, active_fraction=0.25)
    vit = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, quant_embed=True,
               saliency_layers="last", delta_kernel=delta_kernel)
    jc = j_vit.ViTConfig(frontend=j_fe.FrontendConfig(
        patch=j_proj.PatchSpec(16, 16, n_vectors=32,
                               summer=j_sc.SummerSpec(mode="passive", hold_time_s=0.0)),
        temporal=j_tm.TemporalSpec(delta_threshold=1e-3, recompute_budget=2), **kw), **vit)
    tc = t_vit.ViTConfig(frontend=t_fe.FrontendConfig(
        patch=t_proj.PatchSpec(16, 16, n_vectors=32,
                               summer=t_sc.SummerSpec(mode="passive", hold_time_s=0.0)),
        temporal=t_tm.TemporalSpec(delta_threshold=1e-3, recompute_budget=2), **kw), **vit)
    return jc, tc


# with 3 streams admitted a share barely covers one recompute slot over the
# fixed power, with 2 it covers all: the caps, tiers and eps move with churn
GOVERNOR = dict(budget_mw=0.4, backend_eps=1e-3, refresh_horizon=2)
SCENE = {"a": 0, "b": 1, "c": 2, "d": 3, "e": 4}


def _state_rows(state, slot):
    """Every leaf of a StreamState row, flattened (for the hold check)."""
    out = []
    for leaf in state:
        if leaf is None:
            continue
        if isinstance(leaf, torch.Tensor):
            out.append(leaf[slot])
        else:
            out.extend(x[slot] for x in leaf)
    return out


def test_gated_engine_matches_reference(params):
    """The temporal + governed + delta-backend engine (both kernel routes'
    plain versions here) against the JAX engine, free-running on the churn
    and partial-fed schedule; scenes hold for two ticks so the caches
    reuse. The codes never differ on this seed (cache codes equal each
    tick), so the trajectories are the same: logits at atol 1e-5; gaze,
    n_stale, j_cap, tier, eps, backend_cached and events exact; held slots
    bitwise frozen in the port."""
    moved, _ = _run_gated(params, GOVERNOR)
    assert len(moved) > 2, f"the governor never moved: {moved}"


def test_sign_tier_engine_matches_reference(params):
    """The same engine with the governor's sign tier, its budget set so a
    share covers the finest tier's floor with two streams admitted but not
    with three: slots enter the sign tier and leave it as the schedule
    churns, tick for tick with the reference (sign_readout exact, and the
    rest as above)."""
    jc, _ = _gated_cfgs()
    meter = EnergyMeter()
    fcfg = jc.frontend
    spec = j_gov.GovernorSpec(budget_mw=1.0, sign_tier=True)
    k_min = spec.tier_tokens(fcfg.n_active)[-1]
    fixed_min = float(np.asarray(j_gov.fixed_power_mw(
        meter, float(fcfg.image_h * fcfg.image_w), fcfg.patch.pixels_per_patch,
        fcfg.patch.n_vectors, jnp.full((1,), k_min, jnp.int32), 30.0))[0])
    floor_mw = fixed_min + 1e3 * meter.slot_recompute_power_w(
        fcfg.patch.pixels_per_patch, fcfg.patch.n_vectors, 30.0)
    gov = dict(budget_mw=2.5 * floor_mw, sign_tier=True, backend_eps=1e-3,
               refresh_horizon=2)
    _, signs = _run_gated(params, gov)
    assert True in signs and False in signs, signs


def _run_gated(params, governor):
    """The gated engine in both packages over the schedule, twice through;
    returns the (j_cap, k tier, eps) triples seen and each fed stream's
    sign_readout per tick."""
    jc, tc = _gated_cfgs()
    jp, tp = params
    jgov, tgov = j_gov.GovernorSpec(**governor), t_gov.GovernorSpec(**governor)
    jeng = JEngine(jc, jp, capacity=3, temporal=True, governor=jgov, backend_delta=True,
                   project_fn=j_ops.ip2_codes_fn(jc.frontend.patch, jc.frontend.adc))
    teng = TEngine(tc, tp, capacity=3, temporal=True, governor=tgov, backend_delta=True,
                   project_fn=t_ops.ip2_codes_fn(tc.frontend.patch, tc.frontend.adc),
                   device="cpu")
    pool, _ = SceneStream(seed=11, image=64).batch(0, 6)
    moved, signs = set(), []
    for t, (admits, evicts, fed) in enumerate(SCHEDULE * 2):
        for sid in evicts:
            if sid in teng.stream_ids:
                jeng.evict(sid)
                teng.evict(sid)
        for sid in admits:
            if sid not in teng.stream_ids and teng.free_slots:
                assert jeng.admit(sid) == teng.admit(sid)
        fed = [s for s in fed if s in teng.stream_ids]
        frames = {s: pool[(SCENE[s] + t // 2) % 6] for s in fed}
        before = teng.state
        held = [teng.slot_of(s) for s in teng.stream_ids if s not in frames]
        jout = jeng.step(frames)
        tout = teng.step(frames)
        assert tout.keys() == jout.keys()
        js, ts = jeng.state, teng.state
        np.testing.assert_array_equal(ts.cache.features.numpy(), np.asarray(js.cache.features),
                                      err_msg=f"tick {t}: a code moved")
        for name in ("age", "valid", "n_stale"):
            np.testing.assert_array_equal(getattr(ts.cache, name).numpy(),
                                          np.asarray(getattr(js.cache, name)))
        for name in ("j_cap", "tier", "eps", "budget_mw"):
            np.testing.assert_array_equal(getattr(ts.controls, name).numpy(),
                                          np.asarray(getattr(js.controls, name)))
        for sid in fed:
            np.testing.assert_allclose(tout[sid], jout[sid], atol=ATOL, rtol=0,
                                       err_msg=f"tick {t} stream {sid}")
            np.testing.assert_array_equal(teng.gaze(sid), np.asarray(jeng.gaze(sid)))
            assert teng.backend_cached(sid) == jeng.backend_cached(sid)
            assert teng.recompute_cap(sid) == jeng.recompute_cap(sid)
            assert teng.k_tier(sid) == jeng.k_tier(sid)
            assert teng.sign_readout(sid) == jeng.sign_readout(sid)
            assert teng.backend_eps(sid) == jeng.backend_eps(sid)
            assert teng.recompute_fraction(sid) == jeng.recompute_fraction(sid)
            for a, b in zip(teng.events(sid), jeng.events(sid)):
                assert a == b
            moved.add((teng.recompute_cap(sid), teng.k_tier(sid), teng.backend_eps(sid)))
            signs.append(teng.sign_readout(sid))
        for s in held:
            for a, b in zip(_state_rows(ts, s), _state_rows(before, s)):
                assert torch.equal(a, b)
        assert teng.fleet_power_mw() == pytest.approx(jeng.fleet_power_mw(), rel=1e-6)
    return moved, signs


def test_slack_budget_is_a_bitwise_noop():
    """Inside the port, a governed engine whose budget never binds serves
    bitwise what the ungoverned temporal + delta-backend engine serves."""
    _, tc = _gated_cfgs()
    tp = t_vit.prepare_quant_embed(t_vit.init_vit(tc, torch.Generator().manual_seed(0),
                                                  device="cpu"))
    pf = t_ops.ip2_codes_fn(tc.frontend.patch, tc.frontend.adc)
    engs = [TEngine(tc, tp, capacity=2, temporal=True, backend_delta=True, project_fn=pf,
                    device="cpu", governor=g)
            for g in (None, t_gov.GovernorSpec(budget_mw=1e6, backend_eps=1e-3))]
    pool, _ = SceneStream(seed=2, image=64).batch(0, 3)
    for e in engs:
        e.admit("a")
        e.admit("b")
    for t in range(5):
        frames = {"a": pool[t // 2 % 3], "b": pool[(t + 1) // 2 % 3]}
        outs = [e.step(frames) for e in engs]
        for sid in frames:
            assert np.array_equal(outs[0][sid], outs[1][sid])
        for name in ("indices", "ema", "frame_age"):
            assert torch.equal(getattr(engs[0].state, name), getattr(engs[1].state, name))
        for a, b in zip(engs[0].state.cache + engs[0].state.bcache,
                        engs[1].state.cache + engs[1].state.bcache):
            assert torch.equal(a, b)
    assert engs[1].recompute_cap("a") == 2 and engs[1].backend_eps("a") == 0.0


def test_gated_engine_errors():
    _, tc = _gated_cfgs()
    tp = t_vit.init_vit(tc, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="temporal"):
        TEngine(tc, tp, governor=t_gov.GovernorSpec(budget_mw=1.0), device="cpu")
    with pytest.raises(ValueError, match="backend_delta"):
        TEngine(tc, tp, temporal=True, device="cpu",
                governor=t_gov.GovernorSpec(budget_mw=1.0, backend_eps=0.1))
    signed = TEngine(tc, tp, temporal=True, device="cpu",
                     governor=t_gov.GovernorSpec(budget_mw=1.0, sign_tier=True))
    signed.admit("a")
    assert signed.sign_readout("a") is False
    eng = TEngine(tc, tp, capacity=1, device="cpu")
    eng.admit("a")
    for accessor in (eng.recompute_fraction, eng.recompute_cap, eng.k_tier,
                     eng.backend_eps, eng.backend_cached, eng.sign_readout):
        with pytest.raises(RuntimeError):
            accessor("a")
    with pytest.raises(RuntimeError):
        eng.set_budget_mw(1.0)
    with pytest.raises(ValueError):
        eng.admit("b", priority=0.0)


def test_engine_bookkeeping_errors():
    _, tc = _cfgs(False)
    tp = t_vit.init_vit(tc, torch.Generator().manual_seed(0), device="cpu")
    eng = TEngine(tc, tp, capacity=1, device="cpu")
    eng.admit("a")
    with pytest.raises(ValueError):
        eng.admit("a")
    with pytest.raises(RuntimeError):
        eng.admit("b")
    with pytest.raises(RuntimeError):
        eng.gaze("a")
    with pytest.raises(ValueError):
        eng.step({"zz": np.zeros((64, 64, 3), np.float32)})
    assert eng.step({}) == {}
    eng.evict("a")
    assert eng.free_slots == 1 and eng.stream_ids == []
    with pytest.raises(KeyError):
        eng.slot_of("a")
