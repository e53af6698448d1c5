"""Port parity: ``SaccadeEngine`` in plain mode against the JAX engine, on
an admit / evict / partial-fed schedule, both kernel routes.

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
from repro.core import projection as j_proj
from repro.kernels import ops as j_ops
from repro.models import vit as j_vit
from repro.serve import serve_step as j_ss
from repro.serve.engine import SaccadeEngine as JEngine
from repro_torch.convert import params_from_numpy
from repro_torch.core import frontend as t_fe
from repro_torch.core import projection as t_proj
from repro_torch.data.pipeline import SceneStream
from repro_torch.kernels import ops as t_ops
from repro_torch.models import vit as t_vit
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
