"""The slot-sharded engine and fleet: the port's ``SaccadeEngine(mesh=)``
on a ``LocalMesh`` of 4 CPU entries against the reference's sharded
engines on an ``Auto`` 4-device mesh (``jax.sharding.Mesh``; the
reference's own tests build ``Explicit`` meshes with ``jax.make_mesh``,
under which its ``shard_map`` engine does not run), and against the port's
unsharded engine.

The cases are the reference's ``tests/test_distributed.py:209`` (plain,
capacity 8, with churn), ``:278`` (temporal) and ``:329`` (governed),
capacity 5 on 4 devices (which runs unsharded), and a fleet of 2 hosts
over ``make_fleet_meshes`` with 2 devices each. One JAX subprocess
(``--xla_force_host_platform_device_count=4``) runs every reference case
and writes its outputs to an ``.npz``. Integer outputs (gaze, events,
``n_stale``, caps, tiers, placement) match exactly; logits within 1e-5,
the reference's bound.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.frontend import FrontendConfig as JFrontendConfig
from repro.core.projection import PatchSpec as JPatchSpec
from repro.core.temporal import TemporalSpec as JTemporalSpec
from repro.models.vit import ViTConfig as JViTConfig
from repro.models.vit import init_vit as j_init_vit
from repro_torch.convert import params_from_numpy
from repro_torch.core.frontend import FrontendConfig
from repro_torch.core.projection import PatchSpec
from repro_torch.core.temporal import TemporalSpec
from repro_torch.launch.mesh import LocalMesh
from repro_torch.models.vit import ViTConfig
from repro_torch.serve.engine import SaccadeEngine
from repro_torch.serve.fleet import SaccadeFleet, make_fleet_meshes
from repro_torch.serve.governor import GovernorSpec

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
ATOL = 1e-5
CPU4 = [torch.device("cpu")] * 4

# (frontend kwargs, patch, vectors, temporal threshold) per case
CASES = {
    "plain": dict(patch=16, vectors=32, threshold=None, aa=True),
    "temporal": dict(patch=16, vectors=32, threshold=1e-5, aa=True),
    "governed": dict(patch=8, vectors=64, threshold=1e-4, aa=False),
}


def _cfg(pkg, case):
    c = CASES[case]
    if pkg == "jax":
        fc, ps, ts, vc = JFrontendConfig, JPatchSpec, JTemporalSpec, JViTConfig
    else:
        fc, ps, ts, vc = FrontendConfig, PatchSpec, TemporalSpec, ViTConfig
    kw = dict(image_h=64, image_w=64, active_fraction=0.25,
              patch=ps(patch_h=c["patch"], patch_w=c["patch"], n_vectors=c["vectors"]))
    if not c["aa"]:
        kw["aa_cutoff"] = None
    if c["threshold"] is not None:
        kw["temporal"] = ts(delta_threshold=c["threshold"])
    return vc(frontend=fc(**kw), n_layers=1, d_model=32, n_heads=2, d_ff=64)


_REF = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
sys.path.insert(0, sys.argv[2])
import test_torch_engine_sharded as t
from repro.data.pipeline import SceneStream
from repro.models.vit import init_vit
from repro.serve.engine import SaccadeEngine
from repro.serve.fleet import SaccadeFleet, make_fleet_meshes
from repro.serve.governor import GovernorSpec

out = {}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(4, 1), ("data", "model"))
stream = SceneStream(image=64)

def logits(o, sids):
    return np.stack([o[s] for s in sids])

# plain (test_distributed.py:209)
cfg = t._cfg("jax", "plain")
params = init_vit(jax.random.PRNGKey(0), cfg)
e = SaccadeEngine(cfg, params, capacity=8, mesh=mesh)
for s in range(5):
    e.admit(s)
for step in range(3):
    rgb, _ = stream.batch(step, 5)
    out[f"plain_frames_{step}"] = rgb
    out[f"plain_logits_{step}"] = logits(e.step({i: rgb[i] for i in range(5)}), range(5))
    out[f"plain_gaze_{step}"] = np.stack([e.gaze(s) for s in range(5)])
e.evict(0); e.admit(99)
rgb, _ = stream.batch(7, 5)
out["plain_frames_churn"] = rgb
fr = {99: rgb[0], **{i: rgb[i] for i in range(1, 5)}}
out["plain_logits_churn"] = logits(e.step(fr), [99, 1, 2, 3, 4])
out["plain_gaze_churn"] = np.stack([e.gaze(s) for s in [99, 1, 2, 3, 4]])
out["plain_state_devices"] = len(e.state.ema.sharding.device_set)
e5 = SaccadeEngine(cfg, params, capacity=5, mesh=mesh)
for s in range(3):
    e5.admit(s)
rgb, _ = stream.batch(2, 3)
out["odd_frames"] = rgb
out["odd_logits"] = logits(e5.step({i: rgb[i] for i in range(3)}), range(3))
out["odd_sharded"] = e5._slot_spec != jax.sharding.PartitionSpec()

# temporal (:278)
cfg = t._cfg("jax", "temporal")
params = init_vit(jax.random.PRNGKey(0), cfg)
e = SaccadeEngine(cfg, params, capacity=4, mesh=mesh, temporal=True)
for s in range(3):
    e.admit(s)
frame0 = stream.batch(0, 3)[0]
out["temporal_frames"] = frame0
for step in range(4):
    out[f"temporal_logits_{step}"] = logits(e.step({i: frame0[i] for i in range(3)}), range(3))
    out[f"temporal_fraction_{step}"] = np.array([e.recompute_fraction(s) for s in range(3)])
    out[f"temporal_n_stale_{step}"] = np.asarray(e.state.cache.n_stale)
    out[f"temporal_gaze_{step}"] = np.stack([e.gaze(s) for s in range(3)])

# governed (:329)
cfg = t._cfg("jax", "governed")
params = init_vit(jax.random.PRNGKey(0), cfg)
gov = GovernorSpec(budget_mw=0.30)
scenes = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (12, 64, 64, 3)))
out["governed_scenes"] = scenes
e = SaccadeEngine(cfg, params, capacity=4, mesh=mesh, temporal=True, governor=gov)
for s in range(4):
    e.admit(s)
for step in range(10):
    o = e.step({s: scenes[(step + s) % 12] for s in range(4)})
    out[f"governed_logits_{step}"] = logits(o, range(4))
    out[f"governed_caps_{step}"] = np.array([e.recompute_cap(s) for s in range(4)])
    out[f"governed_tiers_{step}"] = np.asarray(e.state.controls.tier)
    out[f"governed_events_{step}"] = np.array([list(e.events(s)) for s in range(4)])
    out[f"governed_mw_{step}"] = np.array([e.power_mw(s) for s in range(4)])

# a fleet of 2 hosts x 2 devices
cfg = t._cfg("jax", "plain")
params = init_vit(jax.random.PRNGKey(0), cfg)
f = SaccadeFleet(cfg, params, n_hosts=2, capacity=4, meshes=make_fleet_meshes(2))
for s in range(6):
    f.submit(s)
f.drain()
out["fleet_hosts"] = np.array([f.host_of(s) for s in range(6)])
for step in range(3):
    rgb, _ = stream.batch(10 + step, 6)
    out[f"fleet_frames_{step}"] = rgb
    out[f"fleet_logits_{step}"] = logits(f.step({i: rgb[i] for i in range(6)}), range(6))
    out[f"fleet_gaze_{step}"] = np.stack([f.engines[f.host_of(s)].gaze(s) for s in range(6)])
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
print("ok")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("engine_sharded") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    # no FMA in the compiled reference (AVX without FMA), so its jitted
    # engine rounds as its op-by-op functions do: with FMA, XLA contracts
    # the frontend's float sums, and on the capacity-5 case one ADC code
    # moves in the reference's jitted engine alone (its eager
    # ``vit_forward_compact`` and the port agree to 3e-7 there)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4 --xla_cpu_max_isa=AVX"
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _REF, path, HERE], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


def _params(case):
    jp = j_init_vit(jax.random.PRNGKey(0), _cfg("jax", case))
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _mesh():
    return LocalMesh(CPU4, ("data", "model"))


def _logits(o, sids):
    return np.stack([o[s] for s in sids])


def _run_plain(engine, ref):
    """The plain case's ticks and churn on ``engine``: (logits, gaze) lists."""
    lg, gz = [], []
    for s in range(5):
        engine.admit(s)
    for step in range(3):
        rgb = ref[f"plain_frames_{step}"]
        lg.append(_logits(engine.step({i: rgb[i] for i in range(5)}), range(5)))
        gz.append(np.stack([engine.gaze(s) for s in range(5)]))
    engine.evict(0)
    engine.admit(99)
    rgb = ref["plain_frames_churn"]
    sids = [99, 1, 2, 3, 4]
    lg.append(_logits(engine.step({99: rgb[0], **{i: rgb[i] for i in range(1, 5)}}), sids))
    gz.append(np.stack([engine.gaze(s) for s in sids]))
    return lg, gz


@pytest.fixture(scope="module")
def plain(ref):
    tc, tp = _cfg("torch", "plain"), _params("plain")
    sharded = SaccadeEngine(tc, tp, capacity=8, mesh=_mesh())
    runs = {"sharded": _run_plain(sharded, ref),
            "unsharded": _run_plain(SaccadeEngine(tc, tp, capacity=8, device="cpu"), ref)}
    return runs, sharded


def test_plain_sharded_engine_matches_reference(ref, plain):
    lg, gz = plain[0]["sharded"]
    want_l = [ref[f"plain_logits_{s}"] for s in range(3)] + [ref["plain_logits_churn"]]
    want_g = [ref[f"plain_gaze_{s}"] for s in range(3)] + [ref["plain_gaze_churn"]]
    for t, (a, b) in enumerate(zip(lg, want_l)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=f"tick {t}")
    for t, (a, b) in enumerate(zip(gz, want_g)):
        np.testing.assert_array_equal(a, b, err_msg=f"tick {t}")


def test_plain_sharded_engine_matches_unsharded(plain):
    (lg, gz), (lu, gu) = plain[0]["sharded"], plain[0]["unsharded"]
    for a, b in zip(lg, lu):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    for a, b in zip(gz, gu):
        np.testing.assert_array_equal(a, b)


def test_sharded_state_lives_on_the_shards(ref, plain):
    """The slot axis is really split: 4 shards of 2 slots, each with its own
    state (the reference's state spans 4 devices); the merged state is the
    shards in slot order."""
    eng = plain[1]
    assert int(ref["plain_state_devices"]) == 4
    assert eng.n_shards == 4
    states = eng.shard_states
    assert [s.ema.shape[0] for s in states] == [2] * 4
    assert torch.equal(torch.cat([s.indices for s in states]), eng.state.indices)
    assert torch.equal(torch.cat([s.active for s in states]), eng.state.active)


def test_indivisible_capacity_runs_unsharded(ref):
    tc, tp = _cfg("torch", "plain"), _params("plain")
    eng = SaccadeEngine(tc, tp, capacity=5, mesh=_mesh())
    assert eng.n_shards == 1 and not bool(ref["odd_sharded"])
    for s in range(3):
        eng.admit(s)
    rgb = ref["odd_frames"]
    got = _logits(eng.step({i: rgb[i] for i in range(3)}), range(3))
    np.testing.assert_allclose(got, ref["odd_logits"], atol=ATOL, rtol=0)


def test_second_mesh_axis_keeps_one_shard(ref):
    """A ``LocalMesh`` puts every device on its first axis: slots split
    along the other ("model", size 1) stay in one shard, bitwise the
    unsharded engine."""
    tc, tp = _cfg("torch", "plain"), _params("plain")
    eng = SaccadeEngine(tc, tp, capacity=8, mesh=_mesh(), axis="model")
    one = SaccadeEngine(tc, tp, capacity=8, device="cpu")
    assert eng.n_shards == 1
    rgb = ref["odd_frames"]
    for e in (eng, one):
        for s in range(3):
            e.admit(s)
    for _ in range(2):
        got, want = (_logits(e.step({i: rgb[i] for i in range(3)}), range(3)) for e in (eng, one))
        assert np.array_equal(got, want)


def _run_temporal(engine, ref):
    for s in range(3):
        engine.admit(s)
    frame0 = ref["temporal_frames"]
    rows = []
    for _ in range(4):
        o = engine.step({i: frame0[i] for i in range(3)})
        rows.append((_logits(o, range(3)), [engine.recompute_fraction(s) for s in range(3)],
                     engine.state.cache.n_stale.numpy(),
                     np.stack([engine.gaze(s) for s in range(3)])))
    return rows


@pytest.mark.parametrize("against", ["reference", "unsharded"])
def test_temporal_sharded_engine(ref, against):
    tc, tp = _cfg("torch", "temporal"), _params("temporal")
    eng = SaccadeEngine(tc, tp, capacity=4, mesh=_mesh(), temporal=True)
    got = _run_temporal(eng, ref)
    assert eng.n_shards == 4
    if against == "reference":
        want = [(ref[f"temporal_logits_{s}"], list(ref[f"temporal_fraction_{s}"]),
                 ref[f"temporal_n_stale_{s}"], ref[f"temporal_gaze_{s}"]) for s in range(4)]
    else:
        want = _run_temporal(SaccadeEngine(tc, tp, capacity=4, device="cpu", temporal=True),
                             ref)
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g[0], w[0], atol=ATOL, rtol=0, err_msg=f"tick {t}")
        assert g[1] == w[1], t
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3], w[3])
    assert got[-1][1] == [0.0, 0.0, 0.0]      # static scene: all reused


def _run_governed(engine, ref):
    scenes = ref["governed_scenes"]
    for s in range(4):
        engine.admit(s)
    rows = []
    for step in range(10):
        o = engine.step({s: scenes[(step + s) % 12] for s in range(4)})
        rows.append((_logits(o, range(4)), [engine.recompute_cap(s) for s in range(4)],
                     engine.state.controls.tier.numpy(),
                     np.array([list(engine.events(s)) for s in range(4)]),
                     np.array([engine.power_mw(s) for s in range(4)])))
    return rows


@pytest.mark.parametrize("against", ["reference", "unsharded"])
def test_governed_sharded_engine(ref, against):
    tc, tp = _cfg("torch", "governed"), _params("governed")
    gov = GovernorSpec(budget_mw=0.30)
    eng = SaccadeEngine(tc, tp, capacity=4, mesh=_mesh(), temporal=True, governor=gov)
    got = _run_governed(eng, ref)
    assert eng.n_shards == 4
    if against == "reference":
        want = [(ref[f"governed_logits_{s}"], list(ref[f"governed_caps_{s}"]),
                 ref[f"governed_tiers_{s}"], ref[f"governed_events_{s}"],
                 ref[f"governed_mw_{s}"]) for s in range(10)]
    else:
        want = _run_governed(SaccadeEngine(tc, tp, capacity=4, device="cpu", temporal=True,
                                           governor=gov), ref)
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g[0], w[0], atol=ATOL, rtol=0, err_msg=f"tick {t}")
        assert g[1] == list(w[1]), t
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3], w[3])
        np.testing.assert_allclose(g[4], w[4], rtol=1e-9, atol=0)
    assert len({tuple(r[1]) for r in got}) > 1     # the governor bites


def test_fleet_on_fleet_meshes_matches_reference(ref):
    tc, tp = _cfg("torch", "plain"), _params("plain")
    meshes = make_fleet_meshes(2, devices=CPU4)
    assert [m.devices for m in meshes] == [CPU4[:2], CPU4[2:]]
    fleet = SaccadeFleet(tc, tp, n_hosts=2, capacity=4, meshes=meshes)
    assert [e.n_shards for e in fleet.engines] == [2, 2]
    for s in range(6):
        fleet.submit(s)
    fleet.drain()
    np.testing.assert_array_equal([fleet.host_of(s) for s in range(6)], ref["fleet_hosts"])
    for step in range(3):
        rgb = ref[f"fleet_frames_{step}"]
        got = _logits(fleet.step({i: rgb[i] for i in range(6)}), range(6))
        np.testing.assert_allclose(got, ref[f"fleet_logits_{step}"], atol=ATOL, rtol=0)
        gaze = np.stack([fleet.engines[fleet.host_of(s)].gaze(s) for s in range(6)])
        np.testing.assert_array_equal(gaze, ref[f"fleet_gaze_{step}"])


def test_sharded_rollout_is_bitwise_its_steps(ref):
    tc, tp = _cfg("torch", "plain"), _params("plain")
    a = SaccadeEngine(tc, tp, capacity=8, mesh=_mesh())
    b = SaccadeEngine(tc, tp, capacity=8, mesh=_mesh())
    for s in range(5):
        a.admit(s)
        b.admit(s)
    ticks = [{i: ref[f"plain_frames_{t}"][i] for i in range(5) if (i + t) % 3} for t in range(3)]
    rolled = a.step_rollout(ticks)
    stepped = [b.step(fr) for fr in ticks]
    for r, s in zip(rolled, stepped):
        assert r.keys() == s.keys()
        for k in r:
            np.testing.assert_array_equal(r[k], s[k])
    assert torch.equal(a.state.indices, b.state.indices)


def test_fleet_meshes_validate():
    with pytest.raises(ValueError, match="split"):
        make_fleet_meshes(3, devices=CPU4)
    with pytest.raises(ValueError, match="meshes or devices"):
        SaccadeFleet(_cfg("torch", "plain"), {}, n_hosts=2, capacity=2,
                     devices=["cpu", "cpu"], meshes=make_fleet_meshes(2, devices=CPU4))
    with pytest.raises(ValueError, match="mesh or device"):
        SaccadeEngine(_cfg("torch", "plain"), {}, capacity=4, mesh=_mesh(), device="cpu")
