"""Port parity: the four forms of ``serve_step.make_saccade_step`` (plain,
temporal, backend, temporal + backend) against the reference's, frame by
frame over a six-frame clip, with ``project_fn=None`` and with the codes
adapter (the reference's Pallas kernels in interpret mode, the port's plain
versions on the CPU).

Each form runs free-running (each package carries its own gaze and
caches) and teacher-forced (every frame starts the port from the
reference's indices and caches). Exact: next indices, ``aux["indices"]``,
``valid``, ``n_stale``, the energy events and the caches' integer leaves.
Within atol 1e-5 (fp32 sum order): logits, saliency, the caches' float
leaves. ADC codes may flip by 1 LSB where an fp32 sum lands on a rounding
boundary: such rows are counted and bounded, and a slot whose codes moved
is excluded from the float comparisons of that frame (its logits follow
the moved code); its integers must still agree.
"""

import dataclasses

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
from repro.models import backend_delta as j_bd
from repro.models import vit as j_vit
from repro.serve import serve_step as j_ss
from repro_torch.convert import params_from_numpy
from repro_torch.core import frontend as t_fe
from repro_torch.core import projection as t_proj
from repro_torch.core import switched_cap as t_sc
from repro_torch.core import temporal as t_tm
from repro_torch.data.pipeline import SceneStream
from repro_torch.kernels import ops as t_ops
from repro_torch.models import backend_delta as t_bd
from repro_torch.models import vit as t_vit
from repro_torch.serve import serve_step as t_ss

ATOL = 1e-5
B = 3
FRAMES = 6
MAX_FLIP_ROWS = 2   # rows of one clip whose codes moved by 1 LSB


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _cfgs():
    base = dict(image_h=64, image_w=64, active_fraction=0.25)
    summer = dict(mode="passive", hold_time_s=0.0)
    jf = j_fe.FrontendConfig(
        patch=j_proj.PatchSpec(16, 16, n_vectors=32, summer=j_sc.SummerSpec(**summer)),
        temporal=j_tm.TemporalSpec(delta_threshold=1e-3, recompute_budget=2), **base)
    tf = t_fe.FrontendConfig(
        patch=t_proj.PatchSpec(16, 16, n_vectors=32, summer=t_sc.SummerSpec(**summer)),
        temporal=t_tm.TemporalSpec(delta_threshold=1e-3, recompute_budget=2), **base)
    vit = dict(n_layers=2, d_model=32, n_heads=2, d_ff=64, quant_embed=True,
               saliency_layers="last", delta_kernel=True)
    return j_vit.ViTConfig(frontend=jf, **vit), t_vit.ViTConfig(frontend=tf, **vit)


@pytest.fixture(scope="module")
def served():
    jc, tc = _cfgs()
    jp = j_vit.prepare_quant_embed(j_vit.init_vit(jax.random.PRNGKey(0), jc))
    imgs, _ = SceneStream(seed=3, image=64).batch(0, B)
    # a pan, a cut to other scenes, then a held frame: the gate and the
    # backend see full, partial and no recomputation
    other, _ = SceneStream(seed=4, image=64).batch(0, B)
    clip = [np.roll(imgs, t, axis=2) for t in range(3)] + [other, other, np.roll(other, 1, 2)]
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), clip


def _routes(jc, tc, route):
    if route == "plain":
        return None, None
    return (j_ops.ip2_codes_fn(jc.frontend.patch, jc.frontend.adc),
            t_ops.ip2_codes_fn(tc.frontend.patch, tc.frontend.adc))


def _state_to_torch(state):
    """The reference's caches as the port's (FeatureCache / BackendCache)."""
    if isinstance(state, j_tm.FeatureCache):
        return t_tm.FeatureCache(*(_t(x) for x in state))
    return t_bd.BackendCache(*(_t(x) for x in state))


def _flipped_slots(got, want):
    """Slots whose code rows differ, after holding every difference to
    1 LSB; returns (slot mask (B,), rows moved)."""
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max(initial=0) <= 1, f"codes differ by {d.max()} LSB"
    rows = d.reshape(d.shape[0], -1, d.shape[-1]).max(-1) > 0
    return rows.any(-1), int(rows.sum())


FORMS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("mode", ["free", "teacher"])
@pytest.mark.parametrize("route", ["plain", "codes"])
@pytest.mark.parametrize("temporal,backend", FORMS,
                         ids=["step", "temporal", "backend", "temporal_backend"])
def test_saccade_step_forms_match_reference(served, temporal, backend, route, mode):
    jc, tc, jp, tp, clip = served
    pf_j, pf_t = _routes(jc, tc, route)
    jstep = jax.jit(j_ss.make_saccade_step(jc, project_fn=pf_j, temporal=temporal,
                                           backend=backend))
    tstep = t_ss.make_saccade_step(tc, project_fn=pf_t, temporal=temporal, backend=backend)
    k = jc.frontend.n_active
    eps = np.full((B,), 1e-3 if mode == "teacher" else 0.0, np.float32)
    j_idx = j_ss.make_bootstrap_indices(jc)(jp, jnp.asarray(clip[0]))
    t_idx = t_ss.make_bootstrap_indices(tc)(tp, _t(clip[0]))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    j_states, t_states = [], []
    if temporal:
        j_states.append(j_tm.init_feature_cache(jc.frontend, (B,)))
        t_states.append(t_tm.init_feature_cache(tc.frontend, (B,), device="cpu"))
    if backend:
        j_states.append(j_bd.init_backend_cache(jc, k, (B,), dtype=jnp.int8))
        t_states.append(t_bd.init_backend_cache(tc, k, (B,), dtype=torch.int8, device="cpu"))
    moved = np.zeros(B, bool)
    flips, compared = 0, 0
    for f, rgb in enumerate(clip):
        if mode == "teacher":
            t_idx, t_states = _t(j_idx), [_state_to_torch(s) for s in j_states]
        jkw = {"eps": jnp.asarray(eps)} if backend else {}
        tkw = {"eps": _t(eps)} if backend else {}
        jout = jstep(jp, jnp.asarray(rgb), j_idx, *j_states, **jkw)
        tout = tstep(tp, _t(rgb), t_idx, *t_states, **tkw)
        assert len(tout) == len(jout) == 3 + temporal + backend
        jl, jn, ja, *j_states = jout
        tl, tn, ta, *t_states = tout
        assert "cache" not in ta and "backend_cache" not in ta
        assert ("n_stale" in ta) == temporal == ("n_stale" in ja)
        # integers exact on every slot
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn), err_msg=f"frame {f}")
        for name in ("indices", "valid") + (("n_stale",) if temporal else ()):
            np.testing.assert_array_equal(ta[name].numpy(), np.asarray(ja[name]),
                                          err_msg=f"frame {f} {name}")
        for a, b in zip(ta["events"], ja["events"]):
            np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b),
                                          err_msg=f"frame {f} events")
        # codes: 1-LSB flips counted; their slots leave the float checks
        if temporal:
            slots, rows = _flipped_slots(t_states[0].features.numpy(),
                                         np.asarray(j_states[0].features))
            moved |= slots
            flips += rows
            for name in ("age", "valid", "n_stale"):
                np.testing.assert_array_equal(getattr(t_states[0], name).numpy(),
                                              np.asarray(getattr(j_states[0], name)))
        if backend:
            tb, jb = t_states[-1], j_states[-1]
            slots, rows = _flipped_slots(tb.feats.numpy(), np.asarray(jb.feats))
            moved |= slots
            flips += rows if not temporal else 0
            for name in ("indices", "tvalid", "valid"):
                np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                              np.asarray(getattr(jb, name)))
        ok = ~moved
        np.testing.assert_allclose(tl.numpy()[ok], np.asarray(jl)[ok], atol=ATOL, rtol=0,
                                   err_msg=f"frame {f} logits")
        np.testing.assert_allclose(ta["saliency"].numpy()[ok], np.asarray(ja["saliency"])[ok],
                                   atol=ATOL, rtol=0, err_msg=f"frame {f} saliency")
        np.testing.assert_allclose(ta["energy"].numpy(), np.asarray(ja["energy"]),
                                   atol=1e-6, rtol=0)
        if backend:
            for name in ("gain", "x_out", "logits", "received"):
                np.testing.assert_allclose(getattr(t_states[-1], name).numpy()[ok],
                                           np.asarray(getattr(j_states[-1], name))[ok],
                                           atol=ATOL, rtol=0, err_msg=f"frame {f} {name}")
        compared += int(ok.sum())
        if mode == "teacher":
            moved[:] = False          # the next frame starts from the reference's state
        j_idx, t_idx = jn, tn
    assert flips <= MAX_FLIP_ROWS, f"{flips} code rows moved by 1 LSB"
    assert compared >= FRAMES * B - 2, f"only {compared} slot-frames compared"


def test_fused_plain_form_matches_reference_and_refuses_caches(served):
    """``cfg.fused_embed=True`` (kernel 4's route, its plain version here)
    in the plain form: the reference's trajectory; the gated forms refuse
    the fused route in both packages."""
    jc, tc, jp, tp, clip = served
    jc, tc = (dataclasses.replace(c, fused_embed=True) for c in (jc, tc))
    jstep = jax.jit(j_ss.make_saccade_step(jc))
    tstep = t_ss.make_saccade_step(tc)
    j_idx = j_ss.make_bootstrap_indices(jc)(jp, jnp.asarray(clip[0]))
    t_idx = _t(j_idx)
    for rgb in clip:
        jl, j_idx, ja = jstep(jp, jnp.asarray(rgb), j_idx)
        tl, t_idx, ta = tstep(tp, _t(rgb), t_idx)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    k = tc.frontend.n_active
    cache = t_tm.init_feature_cache(tc.frontend, (B,), device="cpu")
    bcache = t_bd.init_backend_cache(tc, k, (B,), dtype=torch.int8, device="cpu")
    rgb = _t(clip[0])
    with pytest.raises(ValueError, match="fused_embed"):
        t_ss.make_saccade_step(tc, temporal=True)(tp, rgb, t_idx, cache)
    with pytest.raises(ValueError, match="fused_embed"):
        t_ss.make_saccade_step(tc, backend=True)(tp, rgb, t_idx, bcache)
    with pytest.raises(ValueError, match="fused_embed"):
        j_ss.make_saccade_step(jc, temporal=True)(
            jp, jnp.asarray(clip[0]), j_idx, j_tm.init_feature_cache(jc.frontend, (B,)))


def test_codes_adapter_reaches_the_ragged_projection(served, monkeypatch):
    """The temporal form hands the codes adapter ``row_counts=n_stale``
    (kernel 2's route on the card); the plain form calls it without counts
    (kernel 6's). Recorded on the CPU through the adapter's projection."""
    _, tc, _, tp, clip = served
    seen = []
    real = t_ops.ip2_project_sparse

    def spy(*a, row_counts=None, **kw):
        seen.append(row_counts is not None)
        return real(*a, row_counts=row_counts, **kw)

    monkeypatch.setattr(t_ops, "ip2_project_sparse", spy)
    pf = t_ops.ip2_codes_fn(tc.frontend.patch, tc.frontend.adc)
    idx = t_ss.make_bootstrap_indices(tc)(tp, _t(clip[0]))
    cache = t_tm.init_feature_cache(tc.frontend, (B,), device="cpu")
    t_ss.make_saccade_step(tc, project_fn=pf, temporal=True)(tp, _t(clip[0]), idx, cache)
    assert seen and all(seen), seen
