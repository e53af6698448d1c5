"""Port parity: ``vit_forward_compact`` on both kernel routes (staged codes
adapter + w8a8 embed, and the fused kernel) against the JAX package, with
the reference's own parameters carried across by ``params_from_numpy``.

Tolerance: logits and saliency at atol 1e-5 (XLA and PyTorch order the
backend's fp32 sums differently; the reference's loop-equivalence tests
use the same bound). Codes are compared first: the teacher-forced check
feeds the reference's codes into the port's backend, so it holds whatever
the projection's rounding does; the end-to-end check asserts on its seed
that no code moved.
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
from repro_torch.convert import params_from_numpy
from repro_torch.core import frontend as t_fe
from repro_torch.core import projection as t_proj
from repro_torch.kernels import ops as t_ops
from repro_torch.models import vit as t_vit

ATOL = 1e-5


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
def setup():
    jc, tc = _cfgs(False)
    jp = j_vit.prepare_quant_embed(j_vit.init_vit(jax.random.PRNGKey(3), jc))
    np_tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(np_tree, device="cpu")
    rgb = np.random.default_rng(4).uniform(size=(3, 64, 64, 3)).astype(np.float32)
    idx = np.stack([np.random.default_rng(5 + b).permutation(16)[:4]
                    for b in range(3)]).astype(np.int32)
    return jc, tc, jp, tp, rgb, idx


def _codes(setup):
    jc, tc, jp, tp, rgb, idx = setup
    jcf = j_fe.apply_frontend(
        jp["ip2"], jnp.asarray(rgb), jc.frontend, mode="compact", indices=jnp.asarray(idx),
        project_fn=j_ops.ip2_codes_fn(jc.frontend.patch, jc.frontend.adc))
    tcf = t_fe.apply_frontend(
        tp["ip2"], torch.from_numpy(rgb), tc.frontend, mode="compact",
        indices=torch.from_numpy(idx),
        project_fn=t_ops.ip2_codes_fn(tc.frontend.patch, tc.frontend.adc))
    return jcf, tcf


def test_params_carried_across(setup):
    _, _, jp, tp, _, _ = setup
    np.testing.assert_array_equal(tp["layers"][1]["attn"]["wo"].numpy(),
                                  np.asarray(jp["layers"][1]["attn"]["wo"]))
    assert tp["embed_q"][0].dtype == torch.int8
    np.testing.assert_array_equal(tp["embed_q"][0].numpy(), np.asarray(jp["embed_q"][0]))


def test_teacher_forced_backend_same_codes(setup):
    """Same codes in (the reference's), backend outputs within ATOL."""
    jc, tc, jp, tp, rgb, idx = setup
    jcf, tcf = _codes(setup)
    forced = tcf._replace(features=torch.from_numpy(np.array(jcf.features)))
    x = t_vit._embed_tokens(tp, forced, tc) + tp["pos"][forced.indices.long()]
    tl, tr = t_vit._encoder(tp, x, tc, forced.valid)
    jx = j_vit._embed_tokens(jp, jcf, jc) + jp["pos"][jcf.indices]
    jl, jr = j_vit._encoder(jp, jx, jc, jcf.valid)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_forward_compact_end_to_end(setup, fused):
    jc0, tc0, jp, tp, rgb, idx = setup
    jc, tc = _cfgs(fused)
    jcf, tcf = _codes(setup)
    flips = int((tcf.features.numpy() != np.asarray(jcf.features)).sum())
    assert flips == 0, "this seed is chosen so that no code moves"
    kw_j = {} if fused else {"project_fn": j_ops.ip2_codes_fn(jc.frontend.patch, jc.frontend.adc)}
    kw_t = {} if fused else {"project_fn": t_ops.ip2_codes_fn(tc.frontend.patch, tc.frontend.adc)}
    jl, ja = j_vit.vit_forward_compact(jp, jnp.asarray(rgb), jc, indices=jnp.asarray(idx), **kw_j)
    tl, ta = t_vit.vit_forward_compact(tp, torch.from_numpy(rgb), tc,
                                       indices=torch.from_numpy(idx), **kw_t)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ta["saliency"].numpy(), np.asarray(ja["saliency"]),
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ta["indices"].numpy(), np.asarray(ja["indices"]))
    for a, b in zip(ta["events"], ja["events"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # unobserved patches score exactly 0 in both
    np.testing.assert_array_equal(ta["saliency"].numpy() == 0, np.asarray(ja["saliency"]) == 0)


def test_fused_equals_staged_in_port(setup):
    """On CPU the two routes run the same plain arithmetic: bitwise."""
    _, _, _, tp, rgb, _ = setup
    (_, ts), (_, tf) = _cfgs(False), _cfgs(True)
    ls, as_ = t_vit.vit_forward_compact(
        tp, torch.from_numpy(rgb), ts,
        project_fn=t_ops.ip2_codes_fn(ts.frontend.patch, ts.frontend.adc))
    lf, af = t_vit.vit_forward_compact(tp, torch.from_numpy(rgb), tf)
    assert torch.equal(ls, lf) and torch.equal(as_["saliency"], af["saliency"])
    assert torch.equal(as_["indices"], af["indices"])


def test_saccade_step_loop(setup):
    """Bootstrap indices, then two closed-loop steps on the staged route:
    selections exact, logits within ATOL."""
    from repro.serve import serve_step as j_ss
    from repro_torch.serve import serve_step as t_ss

    jc, tc, jp, tp, rgb, _ = setup
    j_idx = j_ss.make_bootstrap_indices(jc)(jp, jnp.asarray(rgb))
    t_idx = t_ss.make_bootstrap_indices(tc)(tp, torch.from_numpy(rgb))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    j_step = j_ss.make_saccade_step(
        jc, project_fn=j_ops.ip2_codes_fn(jc.frontend.patch, jc.frontend.adc))
    t_step = t_ss.make_saccade_step(
        tc, project_fn=t_ops.ip2_codes_fn(tc.frontend.patch, tc.frontend.adc))
    for t in range(2):
        frame = np.random.default_rng(20 + t).uniform(size=rgb.shape).astype(np.float32)
        jl, j_idx, _ = j_step(jp, jnp.asarray(frame), j_idx)
        tl, t_idx, _ = t_step(tp, torch.from_numpy(frame), t_idx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


def test_forward_compact_sign_mode(setup):
    """The governor's sign tier on the staged route: flagged rows serve the
    sign view of their codes (the sign code points), conversions move to
    sign comparisons; codes and events exact, logits and saliency within
    ATOL; unflagged rows are the plain forward's."""
    jc, tc, jp, tp, rgb, idx = setup
    sign = np.array([True, False, True])
    kw_j = {"project_fn": j_ops.ip2_codes_fn(jc.frontend.patch, jc.frontend.adc)}
    kw_t = {"project_fn": t_ops.ip2_codes_fn(tc.frontend.patch, tc.frontend.adc)}
    jl, ja = j_vit.vit_forward_compact(jp, jnp.asarray(rgb), jc, indices=jnp.asarray(idx),
                                       sign_mode=jnp.asarray(sign), **kw_j)
    tl, ta = t_vit.vit_forward_compact(tp, torch.from_numpy(rgb), tc,
                                       indices=torch.from_numpy(idx),
                                       sign_mode=torch.from_numpy(sign), **kw_t)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ta["saliency"].numpy(), np.asarray(ja["saliency"]),
                               atol=ATOL, rtol=0)
    for a, b in zip(ta["events"], ja["events"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (ta["events"].adc_conversions.numpy()[sign] == 0).all()
    assert (ta["events"].sign_comparisons.numpy()[sign] > 0).all()
    # the served codes: the same sign points as the reference's
    jcf, tcf = _codes(setup)
    c_thresh, c_pos, c_neg = j_vit.adc_mod.sign_code_points(
        jc.frontend.patch.summer.v_ref, jc.frontend.adc)
    want = np.where(np.asarray(jcf.features) >= c_thresh, c_pos, c_neg)
    got = torch.where(tcf.features >= c_thresh, c_pos, c_neg).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) == 2
    plain, _ = t_vit.vit_forward_compact(tp, torch.from_numpy(rgb), tc,
                                         indices=torch.from_numpy(idx), **kw_t)
    assert torch.equal(tl[~torch.from_numpy(sign)], plain[~torch.from_numpy(sign)])
    assert not torch.equal(tl[torch.from_numpy(sign)], plain[torch.from_numpy(sign)])
