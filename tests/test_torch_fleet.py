"""Port parity: ``SaccadeFleet`` against the reference's fleet on the CPU,
on ``tests/test_fleet.py``'s small ViT (64² frames, 16-px patches, M 32,
one layer).

Admission order, validation messages, cancel, placement, ``free_slots`` and
``queued`` are exact; logits within 1e-5 of the JAX fleet on the same
seed-0 weights (carried by ``params_from_numpy``), gaze and events exact;
budget shares within rel 1e-5 of the reference's. The fleet adds routing,
never semantics: every stream matches its dedicated loop (atol 1e-5), a
fleet rollout is bitwise its steps, and a slack fleet budget is bitwise an
ungoverned fleet of the same shape.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.frontend import FrontendConfig as JFrontendConfig
from repro.core.projection import PatchSpec as JPatchSpec
from repro.core.temporal import TemporalSpec as JTemporalSpec
from repro.models.vit import ViTConfig as JViTConfig
from repro.models.vit import init_vit as j_init_vit
from repro.serve.fleet import SaccadeFleet as JFleet
from repro.serve.governor import GovernorSpec as JGovernorSpec
from repro_torch.convert import params_from_numpy
from repro_torch.core.frontend import FrontendConfig
from repro_torch.core.projection import PatchSpec
from repro_torch.core.temporal import TemporalSpec
from repro_torch.data.pipeline import SceneStream
from repro_torch.models.vit import ViTConfig
from repro_torch.serve.engine import RolloutHandle, SaccadeEngine, StepHandle
from repro_torch.serve.fleet import PRIORITY_CLASSES, FleetHandle, SaccadeFleet
from repro_torch.serve.governor import GovernorSpec
from repro_torch.serve.serve_step import make_bootstrap_indices, make_saccade_step

ATOL = 1e-5


def _cfgs(temporal=False):
    kw = dict(image_h=64, image_w=64, active_fraction=0.25)
    jt = JTemporalSpec(delta_threshold=1e-4) if temporal else JTemporalSpec()
    tt = TemporalSpec(delta_threshold=1e-4) if temporal else TemporalSpec()
    jc = JViTConfig(frontend=JFrontendConfig(
        patch=JPatchSpec(patch_h=16, patch_w=16, n_vectors=32), temporal=jt, **kw),
        n_layers=1, d_model=32, n_heads=2, d_ff=64)
    tc = ViTConfig(frontend=FrontendConfig(
        patch=PatchSpec(patch_h=16, patch_w=16, n_vectors=32), temporal=tt, **kw),
        n_layers=1, d_model=32, n_heads=2, d_ff=64)
    return jc, tc


@pytest.fixture(scope="module")
def served():
    jc, tc = _cfgs()
    jp = j_init_vit(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def served_temporal():
    jc, tc = _cfgs(temporal=True)
    jp = j_init_vit(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _fleet(tc, tp, n_hosts, capacity, **kw):
    return SaccadeFleet(tc, tp, n_hosts=n_hosts, capacity=capacity,
                        devices=["cpu"] * n_hosts, **kw)


def _frames(t, n, image=64):
    rgb, _ = SceneStream(image=image).batch(t, n)
    return rgb


# ---- admission ---------------------------------------------------------

def test_priority_classes_drain_highest_first(served):
    """Fewer free slots than queued requests: realtime before standard
    before background, FIFO within a class, as the reference drains."""
    jc, tc, jp, tp = served
    got = []
    for fl in (JFleet(jc, jp, n_hosts=1, capacity=2), _fleet(tc, tp, 1, 2)):
        fl.submit("bg", "background")
        fl.submit("rt", "realtime")
        fl.submit("std", "standard")
        fl.submit("rt2", "realtime")
        first = fl.drain()
        q1 = fl.queued
        fl.evict("rt")
        second = fl.drain()
        fl.evict("std")
        third = fl.drain()
        got.append((first, q1, second, third, fl.queued, fl.free_slots, fl.stream_ids))
    assert got[1] == got[0]
    assert got[1][0] == ["rt", "rt2"]


def _raised(fn):
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value), str(e.value)


def test_submit_validation_and_cancel_match_reference(served):
    jc, tc, jp, tp = served
    fls = (JFleet(jc, jp, n_hosts=1, capacity=2), _fleet(tc, tp, 1, 2))
    for fl in fls:
        fl.submit("a")
    for call in (lambda f: f.submit("a"),
                 lambda f: f.submit("b", "vip")):
        assert _raised(lambda: call(fls[1])) == _raised(lambda: call(fls[0]))
    for fl in fls:
        fl.evict("a")                          # cancels the queued request
        assert fl.queued == 0
    assert _raised(lambda: fls[1].evict("a")) == _raised(lambda: fls[0].evict("a"))
    assert _raised(lambda: fls[1].host_of("zz")) == _raised(lambda: fls[0].host_of("zz"))
    # constructor validation
    assert _raised(lambda: SaccadeFleet(tc, tp, n_hosts=0)) \
        == _raised(lambda: JFleet(jc, jp, n_hosts=0))
    assert _raised(lambda: SaccadeFleet(tc, tp, n_hosts=1, priority_classes={"x": 0.0},
                                        devices=["cpu"])) \
        == _raised(lambda: JFleet(jc, jp, n_hosts=1, priority_classes={"x": 0.0}))
    with pytest.raises(ValueError, match="got 1 devices for 2 hosts"):
        SaccadeFleet(tc, tp, n_hosts=2, devices=["cpu"])
    assert PRIORITY_CLASSES == {"realtime": 4.0, "interactive": 2.0,
                                "standard": 1.0, "background": 0.25}


def test_placement_free_slots_and_queued_match_reference(served):
    """A churn sequence of submits, drains, evicts and cancels: every chosen
    host, ``free_slots``, ``queued``, ``stream_ids`` and ``host_of`` equal
    the reference's (least loaded, lowest host on ties)."""
    jc, tc, jp, tp = served
    ops = ([("submit", f"s{i}", cls) for i, cls in
            enumerate(["standard", "realtime", "background", "standard", "interactive"])]
           + [("drain",), ("evict", "s1"), ("submit", "s5", "realtime"),
              ("submit", "s6", "background"), ("submit", "s7", "standard"),
              ("evict", "s6"), ("drain",), ("evict", "s0"), ("evict", "s3"),
              ("submit", "s8", "interactive"), ("drain",)])
    logs = []
    for fl in (JFleet(jc, jp, n_hosts=3, capacity=2), _fleet(tc, tp, 3, 2)):
        log = []
        for op in ops:
            if op[0] == "submit":
                log.append(fl.submit(op[1], op[2]))
            elif op[0] == "drain":
                log.append(fl.drain())
            else:
                fl.evict(op[1])
            log.append((fl.free_slots, fl.queued, fl.stream_ids,
                        {s: fl.host_of(s) for s in fl.stream_ids}))
        logs.append(log)
    assert logs[1] == logs[0]
    assert sorted(logs[1][0:10:2]) == [0, 0, 1, 1, 2]   # spread, not piled


# ---- serving -----------------------------------------------------------

def test_streams_match_dedicated_loops_across_hosts(served):
    """Every stream, whatever host it landed on and whatever rate it is fed
    at, matches its own dedicated batch-1 loop (atol 1e-5, as the
    reference's test)."""
    _, tc, _, tp = served
    fl = _fleet(tc, tp, 2, 2)
    for i in range(3):
        fl.submit(f"s{i}")
    boot = make_bootstrap_indices(tc)
    step1 = make_saccade_step(tc)
    refs = {f"s{i}": None for i in range(3)}
    for t in range(4):
        rgb = _frames(t, 3)
        frames = {f"s{i}": rgb[i] for i in range(3) if (t + i) % 2 == 0}
        out = fl.step(frames)
        assert set(out) == set(frames)
        for sid in frames:
            r = torch.from_numpy(rgb[int(sid[1:]):int(sid[1:]) + 1])
            if refs[sid] is None:
                refs[sid] = boot(tp, r)
            logits, refs[sid], _ = step1(tp, r, refs[sid])
            np.testing.assert_allclose(out[sid], logits[0].numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["step", "rollout"])
def test_fleet_matches_reference_fleet(served, mode):
    """The same churn and mixed-rate feeds through the JAX fleet and the
    port's: logits within 1e-5, gaze, events and placement exact."""
    jc, tc, jp, tp = served
    jf = JFleet(jc, jp, n_hosts=2, capacity=2)
    tf = _fleet(tc, tp, 2, 2)
    for fl in (jf, tf):
        for i, cls in enumerate(["standard", "realtime", "background", "standard", "interactive"]):
            fl.submit(f"s{i}", cls)
    sched = []
    for t in range(6):
        rgb = _frames(t, 5)
        sched.append({f"s{i}": rgb[i] for i in range(5) if (t + i) % (1 + i % 3) == 0})
    for chunk_i, chunk in enumerate((sched[:3], sched[3:])):
        if chunk_i == 1:
            for fl in (jf, tf):
                fl.evict("s1")
                fl.drain()
        admitted = set(tf.stream_ids)
        chunk = [{s: f for s, f in fr.items() if s in admitted} for fr in chunk]
        if mode == "step":
            jouts = [jf.step(fr) for fr in chunk]
            touts = [tf.step(fr) for fr in chunk]
        else:
            jouts = jf.step_rollout(chunk)
            touts = tf.step_rollout(chunk)
        assert tf.stream_ids == jf.stream_ids
        for jo, to in zip(jouts, touts):
            assert set(to) == set(jo)
            for sid in jo:
                np.testing.assert_allclose(to[sid], jo[sid], atol=ATOL, rtol=0)
        for sid in tf.stream_ids:
            assert tf.host_of(sid) == jf.host_of(sid)
            he, je = tf.engines[tf.host_of(sid)], jf.engines[jf.host_of(sid)]
            if int(he.state.frame_age[he.slot_of(sid)]) == 0:
                continue
            np.testing.assert_array_equal(he.gaze(sid), np.asarray(je.gaze(sid)))
            assert tuple(tf.events(sid)) == tuple(float(e) for e in jf.events(sid))
            assert tf.power_mw(sid) == pytest.approx(jf.power_mw(sid), rel=1e-6)
    assert tf.fleet_power_mw() == pytest.approx(jf.fleet_power_mw(), rel=1e-6)


def _spy(fleet, events):
    """Wrap each engine's step / step_rollout to record dispatches and the
    handles' fetches."""
    class Traced:
        def __init__(self, handle, h):
            self._handle, self._h = handle, h

        def result(self):
            events.append(("fetch", self._h))
            return self._handle.result()

    for h_i, eng in enumerate(fleet.engines):
        for name in ("step", "step_rollout"):
            inner = getattr(eng, name)

            def spy(frames, block=True, _h=h_i, _inner=inner):
                events.append(("dispatch", _h))
                assert block is False, "fleet must dispatch non-blocking"
                return Traced(_inner(frames, block=False), _h)

            setattr(eng, name, spy)


def test_only_fed_hosts_dispatch(served):
    _, tc, _, tp = served
    fl = _fleet(tc, tp, 2, 1)
    fl.submit("a")
    fl.submit("b")
    fl.drain()
    ha, hb = fl.host_of("a"), fl.host_of("b")
    assert ha != hb
    events = []
    _spy(fl, events)
    rgb = _frames(0, 1)
    fl.step({"a": rgb[0]})                   # only a's host runs
    assert events == [("dispatch", ha), ("fetch", ha)]
    events.clear()
    fl.step_rollout([{"b": rgb[0]}, {}])
    assert events == [("dispatch", hb), ("fetch", hb)]
    events.clear()
    assert fl.step({}) == {}                 # nothing fed: nothing dispatched
    assert events == []


@pytest.mark.parametrize("mode", ["step", "rollout"])
def test_fleet_dispatch_before_fetch(served, mode):
    _, tc, _, tp = served
    fl = _fleet(tc, tp, 2, 1)
    fl.submit("a")
    fl.submit("b")
    fl.drain()
    events = []
    _spy(fl, events)
    rgb = _frames(0, 2)
    frames = {"a": rgb[0], "b": rgb[1]}
    out = fl.step(frames) if mode == "step" else fl.step_rollout([frames])[0]
    assert set(out) == {"a", "b"}
    kinds = [k for k, _ in events]
    assert kinds == ["dispatch", "dispatch", "fetch", "fetch"], events


def test_fleet_handles(served):
    """``block=False`` returns a FleetHandle over the engines' handles: one
    merged dict for a tick, T for a rollout; idempotent."""
    _, tc, _, tp = served
    fl = _fleet(tc, tp, 2, 1)
    fl.submit("a")
    fl.submit("b")
    rgb = _frames(0, 3)
    h = fl.step({"a": rgb[0], "b": rgb[1]}, block=False)
    assert isinstance(h, FleetHandle)
    assert all(isinstance(x, StepHandle) for x in h._handles)
    out = h.result()
    assert set(out) == {"a", "b"} and h.result() is out
    hr = fl.step_rollout([{"a": rgb[2]}, {}, {"a": rgb[0], "b": rgb[1]}], block=False)
    assert all(isinstance(x, RolloutHandle) for x in hr._handles)
    roll = hr.result()
    assert [set(d) for d in roll] == [{"a"}, set(), {"a", "b"}]
    assert hr.result() is roll
    assert fl.step_rollout([]) == []


def test_fleet_rollout_matches_fleet_steps_bitwise(served):
    _, tc, _, tp = served
    f_seq, f_roll = _fleet(tc, tp, 2, 2), _fleet(tc, tp, 2, 2)
    for f in (f_seq, f_roll):
        for sid in ("a", "b", "c"):
            f.submit(sid)
        f.drain()
    rgb = _frames(1, 6)
    sched = [{"a": rgb[0], "c": rgb[1]}, {"b": rgb[2]},
             {"a": rgb[3], "b": rgb[4], "c": rgb[5]}, {}]
    seq = [f_seq.step(fr) for fr in sched]
    roll = f_roll.step_rollout(sched)
    for t in range(len(sched)):
        assert set(seq[t]) == set(roll[t])
        for sid in seq[t]:
            np.testing.assert_array_equal(seq[t][sid], roll[t][sid])


# ---- budget hierarchy ----------------------------------------------------

def test_fleet_budget_splits_host_then_slot_like_reference(served_temporal):
    """fleet -> host by admitted priority mass, host -> slot by stream
    priority: each host's budget and slot shares within rel 1e-5 of the
    reference's; slot shares sum to the host share, host shares to the
    fleet budget."""
    jc, tc, jp, tp = served_temporal
    jf = JFleet(jc, jp, n_hosts=2, capacity=2, temporal=True,
                governor=JGovernorSpec(budget_mw=1.0))
    tf = _fleet(tc, tp, 2, 2, temporal=True, governor=GovernorSpec(budget_mw=1.0))
    for fl in (jf, tf):
        fl.submit("rt", "realtime")
        fl.submit("bg", "background")
        fl.submit("std", "standard")
        fl.drain()
    for churn in (None, "bg"):
        if churn:
            for fl in (jf, tf):
                fl.evict(churn)
                fl.submit("int", "interactive")
                fl.drain()
        host_sum = 0.0
        for te, je in zip(tf.engines, jf.engines):
            tb = te.state.controls.budget_mw.numpy()
            jb = np.asarray(je.state.controls.budget_mw)
            assert te.budget_mw == pytest.approx(je.budget_mw, rel=1e-5)
            np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=0)
            assert tb.sum() == pytest.approx(te.budget_mw, rel=1e-5)
            host_sum += tb.sum()
        assert host_sum == pytest.approx(1.0, rel=1e-5)


def test_ungoverned_fleet_keeps_engine_budgets(served):
    _, tc, _, tp = served
    fl = _fleet(tc, tp, 2, 1)
    fl.submit("a", "realtime")
    fl.drain()
    assert all(e.budget_mw is None for e in fl.engines)


def test_slack_fleet_budget_is_a_noop(served_temporal):
    """A slack fleet budget leaves every stream bitwise an ungoverned fleet
    of the same shape (each host's slack share is itself slack), and
    within 1e-6 of one capacity-2 engine.

    The second comparison changes the batch shape (two hosts of one slot
    against one engine of two), and float32 sums then round differently:
    the reference's own bitwise version of it
    (``test_slack_fleet_budget_is_bitwise_noop``) differs by up to 1.49e-7
    on 3 of 4 logits in JAX on the CPU, whatever the governor does."""
    _, tc, _, tp = served_temporal
    gov = _fleet(tc, tp, 2, 1, temporal=True, governor=GovernorSpec(budget_mw=1e4))
    ungov = _fleet(tc, tp, 2, 1, temporal=True)
    plain = SaccadeEngine(tc, tp, capacity=2, temporal=True, device="cpu")
    for fl in (gov, ungov):
        fl.submit("a", "realtime")
        fl.submit("b", "background")
    plain.admit("a")
    plain.admit("b")
    for t in range(4):
        rgb = _frames(t % 2, 2)
        frames = {"a": rgb[0], "b": rgb[1]}
        og, ou, op = gov.step(frames), ungov.step(frames), plain.step(frames)
        for sid in frames:
            np.testing.assert_array_equal(og[sid], ou[sid])
            np.testing.assert_allclose(og[sid], op[sid], atol=1e-6, rtol=0)
