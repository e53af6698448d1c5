"""Port parity: device rollouts and the async engine surface
(``SaccadeEngine.step_rollout``, ``step(block=False)``, the handles), on
the small configuration of the reference's rollout tests.

* In every engine mode of the reference's rollout suite (``MODES``), the
  port's ``step_rollout`` equals the port's own per-tick ``step()`` loop
  bitwise, in logits and every state leaf, on the partial-fed schedule and
  again on warm state.
* The same modes against the reference's ``step_rollout``: logits at atol
  1e-5 (fp32 sum order); gaze, frame age, n_stale, j_cap, tier, eps, the
  sign and backend-cached flags, cached codes and the event meters exact.
  Free-running (the port on its own selections), and teacher-forced (the
  reference's state copied into the port at every rollout boundary).
* Handles: lazy, idempotent, one fetch each, valid across later calls.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.frontend import FrontendConfig as JFrontend
from repro.core.projection import PatchSpec as JPatch
from repro.core.temporal import TemporalSpec as JTemporal
from repro.models.vit import ViTConfig as JViT, init_vit as j_init_vit
from repro.serve.engine import SaccadeEngine as JEngine
from repro.serve.governor import GovernorSpec as JGov
from repro_torch.convert import params_from_numpy
from repro_torch.core.frontend import FrontendConfig
from repro_torch.core.projection import PatchSpec
from repro_torch.core.temporal import TemporalSpec
from repro_torch.models.vit import ViTConfig
from repro_torch.serve.engine import RolloutHandle, SaccadeEngine, StepHandle
from repro_torch.serve.governor import GovernorSpec
from repro_torch.serve.serve_step import make_rollout

ATOL = 1e-5


def _cfgs(temporal=False):
    kw = dict(image_h=64, image_w=64, active_fraction=0.25)
    jt = dict(temporal=JTemporal(delta_threshold=1e-4)) if temporal else {}
    tt = dict(temporal=TemporalSpec(delta_threshold=1e-4)) if temporal else {}
    vit = dict(n_layers=1, d_model=32, n_heads=2, d_ff=64)
    return (JViT(frontend=JFrontend(patch=JPatch(16, 16, n_vectors=32), **kw, **jt), **vit),
            ViTConfig(frontend=FrontendConfig(patch=PatchSpec(16, 16, n_vectors=32), **kw,
                                              **tt), **vit))


J_CFG, T_CFG = _cfgs()
J_CFG_T, T_CFG_T = _cfgs(temporal=True)
J_PARAMS = j_init_vit(jax.random.PRNGKey(0), J_CFG)
J_PARAMS_T = j_init_vit(jax.random.PRNGKey(0), J_CFG_T)
T_PARAMS = params_from_numpy(jax.tree.map(np.asarray, J_PARAMS), device="cpu")
T_PARAMS_T = params_from_numpy(jax.tree.map(np.asarray, J_PARAMS_T), device="cpu")
FRAMES = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (16, 64, 64, 3)))

# the reference's MODES (tests/test_rollout.py): tight governed budgets, so
# the in-loop control law moves during the rollout
MODES = {
    "plain": (False, {}),
    "temporal": (True, dict(temporal=True)),
    "backend_delta": (False, dict(backend_delta=True)),
    "temporal_governed": (True, dict(temporal=True, governor=dict(budget_mw=0.05))),
    "sign_tier_governed": (True, dict(temporal=True,
                                      governor=dict(budget_mw=0.02, sign_tier=True))),
    "temporal_backend_governed": (True, dict(temporal=True, backend_delta=True,
                                             governor=dict(budget_mw=0.05,
                                                           backend_eps=1e-3))),
}

# a T = 5 schedule with partial-fed ticks and frame-rate skew: "a" every
# tick, "b" every other, "c" once, tick 3 feeds nobody
SCHED = [
    {"a": FRAMES[0], "b": FRAMES[1]},
    {"a": FRAMES[2]},
    {"a": FRAMES[3], "b": FRAMES[4], "c": FRAMES[5]},
    {},
    {"a": FRAMES[6], "b": FRAMES[7]},
]
SCHED2 = [{"a": FRAMES[8], "c": FRAMES[9]}, {"b": FRAMES[10]},
          {"a": FRAMES[11], "b": FRAMES[12], "c": FRAMES[13]}]


def _engine(mode, pkg="torch", capacity=4):
    temporal, kw = MODES[mode]
    kw = dict(kw)
    if pkg == "jax":
        if "governor" in kw:
            kw["governor"] = JGov(**kw["governor"])
        cfg, params = (J_CFG_T, J_PARAMS_T) if temporal else (J_CFG, J_PARAMS)
        return JEngine(cfg, params, capacity=capacity, **kw)
    if "governor" in kw:
        kw["governor"] = GovernorSpec(**kw["governor"])
    cfg, params = (T_CFG_T, T_PARAMS_T) if temporal else (T_CFG, T_PARAMS)
    return SaccadeEngine(cfg, params, capacity=capacity, device="cpu", **kw)


def _leaves(state):
    """Every tensor of a StreamState, flattened in field order."""
    out = []
    for leaf in state:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif leaf is not None:
            out.extend(x for x in leaf if isinstance(x, torch.Tensor))
    return out


def _assert_states_bitwise(a, b, msg):
    la, lb = _leaves(a.state), _leaves(b.state)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{msg}: state leaf {i} diverged"


def _assert_rollout_matches_steps(eng_seq, eng_roll, sched, msg):
    seq = [eng_seq.step(fr) for fr in sched]
    roll = eng_roll.step_rollout(sched)
    assert len(roll) == len(seq)
    for t, (want, got) in enumerate(zip(seq, roll)):
        assert set(want) == set(got), f"{msg} tick {t}: fed cover differs"
        for sid in want:
            np.testing.assert_array_equal(got[sid], want[sid],
                                          err_msg=f"{msg} tick {t} stream {sid}")
    _assert_states_bitwise(eng_seq, eng_roll, msg)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_rollout_matches_steps_bitwise(mode):
    """step_rollout(T) == T x step(), bitwise, then again on warm state
    (caches, meters and governor knobs round-trip through the loop)."""
    eng_seq, eng_roll = _engine(mode), _engine(mode)
    for e in (eng_seq, eng_roll):
        for sid in ("a", "b", "c"):
            e.admit(sid)
    _assert_rollout_matches_steps(eng_seq, eng_roll, SCHED, mode)
    _assert_rollout_matches_steps(eng_seq, eng_roll, SCHED2, mode + " (warm)")
    # churn between rollouts lands at the boundary
    for e in (eng_seq, eng_roll):
        e.evict("b")
        e.admit("d")
    _assert_rollout_matches_steps(eng_seq, eng_roll,
                                  [{"d": FRAMES[14], "a": FRAMES[15]}, {"c": FRAMES[0]}],
                                  mode + " (churn)")


def _set_state_from(teng, jeng):
    """Teacher forcing: the reference's whole state, copied into the port."""
    js = jeng.state

    def conv(x):
        return torch.from_numpy(np.array(x, copy=True))

    st = teng.state
    fields = {}
    for name, leaf in zip(st._fields, st):
        jleaf = getattr(js, name)
        if leaf is None:
            fields[name] = None
        elif isinstance(leaf, torch.Tensor):
            fields[name] = conv(jleaf)
        else:
            fields[name] = type(leaf)(*(conv(x) for x in jleaf))
    teng._state = type(st)(**fields)


def _compare_to_reference(teng, jeng, tout, jout, msg):
    assert len(tout) == len(jout)
    for t, (tt, jt) in enumerate(zip(tout, jout)):
        assert tt.keys() == jt.keys(), f"{msg} tick {t}"
        for sid in jt:
            np.testing.assert_allclose(tt[sid], jt[sid], atol=ATOL, rtol=0,
                                       err_msg=f"{msg} tick {t} stream {sid}")
    ts, js = teng.state, jeng.state
    for name in ("indices", "frame_age", "active"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=f"{msg} {name}")
    for a, b in zip(ts.events_last + ts.events_mean, js.events_last + js.events_mean):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{msg} events")
    if ts.cache is not None:
        for name in ("features", "age", "valid", "n_stale"):
            np.testing.assert_array_equal(getattr(ts.cache, name).numpy(),
                                          np.asarray(getattr(js.cache, name)),
                                          err_msg=f"{msg} cache.{name}")
    if ts.controls is not None:
        for name in ("j_cap", "tier", "eps", "budget_mw"):
            np.testing.assert_array_equal(getattr(ts.controls, name).numpy(),
                                          np.asarray(getattr(js.controls, name)),
                                          err_msg=f"{msg} controls.{name}")
    if ts.bcache is not None:
        np.testing.assert_array_equal(ts.bcache.valid.numpy(), np.asarray(js.bcache.valid))
    for sid in teng.stream_ids:
        if int(ts.frame_age[teng.slot_of(sid)]) == 0:
            continue
        np.testing.assert_array_equal(teng.gaze(sid), np.asarray(jeng.gaze(sid)))
        if teng.governor is not None:
            assert teng.sign_readout(sid) == jeng.sign_readout(sid), f"{msg} {sid}"
            assert teng.k_tier(sid) == jeng.k_tier(sid)
        if teng.backend:
            assert teng.backend_cached(sid) == jeng.backend_cached(sid)
        for a, b in zip(teng.energy_report(sid).values(), jeng.energy_report(sid).values()):
            assert a == pytest.approx(float(b), rel=1e-6)


@pytest.mark.parametrize("teacher", [False, True], ids=["free", "teacher"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_rollout_matches_reference(mode, teacher):
    teng, jeng = _engine(mode), _engine(mode, pkg="jax")
    for e in (teng, jeng):
        for sid in ("a", "b", "c"):
            e.admit(sid)
    for i, sched in enumerate((SCHED, SCHED2, SCHED[::-1])):
        if teacher:
            _set_state_from(teng, jeng)
        tout, jout = teng.step_rollout(sched), jeng.step_rollout(sched)
        _compare_to_reference(teng, jeng, tout, jout, f"{mode} rollout {i}")


def test_sign_tier_rollout_reaches_the_sign_tier():
    """Guard the guard: the sign-tier mode's budget drives a slot into the
    sign tier within the rollout, in both packages."""
    teng, jeng = _engine("sign_tier_governed", capacity=2), \
        _engine("sign_tier_governed", pkg="jax", capacity=2)
    seen = []
    for e in (teng, jeng):
        e.admit("a")
    for t in range(4):
        sched = [{"a": FRAMES[2 * t]}, {"a": FRAMES[2 * t + 1]}]
        _compare_to_reference(teng, jeng, teng.step_rollout(sched), jeng.step_rollout(sched),
                              f"rollout {t}")
        seen.append(teng.sign_readout("a"))
    assert any(seen), seen
    assert teng.k_tier("a") < T_CFG_T.frontend.n_active


def test_slack_budget_rollout_is_bitwise_noop():
    """With a slack budget the governed rollout is bitwise the ungoverned
    temporal rollout: the in-loop control law holds every knob at its
    no-op value."""
    plain = SaccadeEngine(T_CFG_T, T_PARAMS_T, capacity=2, temporal=True, device="cpu")
    gvd = SaccadeEngine(T_CFG_T, T_PARAMS_T, capacity=2, temporal=True, device="cpu",
                        governor=GovernorSpec(budget_mw=100.0))
    plain.admit("a")
    gvd.admit("a")
    sched = [{"a": FRAMES[0 if t != 3 else 5]} for t in range(6)]
    out_p, out_g = plain.step_rollout(sched), gvd.step_rollout(sched)
    for t in range(len(sched)):
        np.testing.assert_array_equal(out_p[t]["a"], out_g[t]["a"])
    assert torch.equal(plain.state.cache.features, gvd.state.cache.features)
    assert torch.equal(plain.state.indices, gvd.state.indices)
    k = T_CFG_T.frontend.n_active
    assert gvd.recompute_cap("a") == k and gvd.k_tier("a") == k


def test_make_rollout_is_the_step_loop():
    """make_rollout over a recording step: each tick's rows land in the
    frame buffer before its step, the state threads through, all-hold
    ticks run too, and the logits stack in tick order."""
    seen = []

    def step(params, frames, fed, state):
        seen.append((frames.clone(), fed.clone(), state))
        return frames[:, 0, 0, :1] * 0 + state, state + 1

    frames = torch.zeros((3, 2, 2, 3))
    rows = torch.arange(1, 4, dtype=torch.float32)[:, None, None, None].expand(3, 2, 2, 3)
    slots = torch.tensor([2, 0, 1])
    fed = torch.tensor([[False, False, True], [False, False, False], [True, True, False]])
    logits, state = make_rollout(step)(None, frames, rows.contiguous(), slots, fed,
                                       [1, 0, 2], torch.tensor(10.0))
    assert float(state) == 13.0 and logits.shape == (3, 3, 1)
    assert [float(s) for _, _, s in seen] == [10.0, 11.0, 12.0]
    assert seen[0][0][2, 0, 0, 0] == 1 and seen[0][0][0, 0, 0, 0] == 0
    assert torch.equal(seen[1][0], seen[0][0])          # all-hold: no rows
    assert seen[2][0][0, 0, 0, 0] == 2 and seen[2][0][1, 0, 0, 0] == 3
    assert torch.equal(frames[:, 0, 0, 0], torch.tensor([2.0, 3.0, 1.0]))


class TestAsyncHandles:
    def test_step_handle_is_lazy_and_idempotent(self):
        eng = _engine("plain", capacity=2)
        eng.admit("a")
        eng.admit("b")
        h = eng.step({"a": FRAMES[0]}, block=False)
        assert isinstance(h, StepHandle)
        out = h.result()
        assert set(out) == {"a"}
        assert h.result() is out and h._logits is None   # cached, device ref dropped
        h0 = eng.step({}, block=False)
        assert h0.result() == {}

    def test_rollout_handle_one_fetch_many_ticks(self):
        eng = _engine("plain", capacity=2)
        eng.admit("a")
        eng.admit("b")
        h = eng.step_rollout([{"a": FRAMES[0]}, {}, {"a": FRAMES[1], "b": FRAMES[2]}],
                             block=False)
        assert isinstance(h, RolloutHandle)
        out = h.result()
        assert [set(d) for d in out] == [{"a"}, set(), {"a", "b"}]
        assert h.result() is out
        assert eng.step_rollout([]) == []
        assert eng.step_rollout([], block=False).result() == []

    def test_dispatch_overlaps_across_engines(self):
        """A second engine's step is issued before the first's result is
        fetched, and both handles resolve to the serial results."""
        e1, e2 = _engine("plain", capacity=1), _engine("plain", capacity=1)
        e1.admit("x")
        e2.admit("y")
        h1 = e1.step({"x": FRAMES[0]}, block=False)
        h2 = e2.step({"y": FRAMES[0]}, block=False)
        o1, o2 = h1.result(), h2.result()
        np.testing.assert_array_equal(o1["x"], o2["y"])

    def test_handles_stay_valid_across_later_calls(self):
        """Handles left unfetched over later steps and rollouts (which reuse
        the staging buffers) resolve to what a blocking twin served."""
        eng, twin = _engine("temporal"), _engine("temporal")
        for e in (eng, twin):
            e.admit("a")
            e.admit("b")
        handles = [eng.step({"a": FRAMES[t], "b": FRAMES[t + 1]}, block=False)
                   for t in range(3)]
        sched = [{"a": FRAMES[8]}, {"a": FRAMES[4], "b": FRAMES[9]}]
        roll = eng.step_rollout(sched, block=False)
        handles.append(eng.step({"b": FRAMES[5]}, block=False))
        want = [twin.step({"a": FRAMES[t], "b": FRAMES[t + 1]}) for t in range(3)]
        want_roll = [twin.step(fr) for fr in sched]
        want.append(twin.step({"b": FRAMES[5]}))
        for h, w in zip(handles, want):
            got = h.result()
            assert got.keys() == w.keys()
            for sid in w:
                np.testing.assert_array_equal(got[sid], w[sid])
        for got, w in zip(roll.result(), want_roll):
            assert got.keys() == w.keys()
            for sid in w:
                np.testing.assert_array_equal(got[sid], w[sid])

    def test_rollout_unknown_stream_raises_with_tick(self):
        eng = _engine("plain", capacity=1)
        eng.admit("a")
        with pytest.raises(ValueError, match="tick 1.*unknown"):
            eng.step_rollout([{"a": FRAMES[0]}, {"zzz": FRAMES[1]}])
        with pytest.raises(ValueError, match="unknown"):
            eng.step({"zzz": FRAMES[1]}, block=False)
