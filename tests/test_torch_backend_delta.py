"""Port parity: the delta-gated backend (``models/backend_delta.py``) and
its ragged attention kernel's plain version against the JAX package.

* ``delta_attention``'s plain version vs ``delta_attention_pallas``
  (interpret mode) at atol 1e-6, the reference's own bound; rows past the
  counts are exact zeros. ``ops.delta_attention`` vs the encoder's dense
  attention on the covered prefix at atol 1e-5.
* ``delta_forward`` teacher-forced over a clip of the temporal frontend
  (same wire, same cache in): the exact regime (eps = 0), the budgeted one
  (eps > 0) and the fully cached one. Logits, saliency and cached layer
  outputs within atol 1e-5 (fp32 sum order); the reuse key and MAC counts
  exact; a cached frame serves the cache's logits bitwise with 0 MACs.
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
from repro.kernels.vit_delta_attention import delta_attention_pallas
from repro.models import backend_delta as j_bd
from repro.models import vit as j_vit
from repro.serve.serve_step import make_bootstrap_indices
from repro_torch.convert import params_from_numpy
from repro_torch.core import frontend as t_fe
from repro_torch.core import projection as t_proj
from repro_torch.core import switched_cap as t_sc
from repro_torch.core import temporal as t_tm
from repro_torch.core.power import EventCounts
from repro_torch.data.pipeline import SceneStream
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import backend_delta as t_bd
from repro_torch.models import vit as t_vit

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _cf_to_torch(jcf):
    """The reference's CompactFeatures as the port's."""
    return t_fe.CompactFeatures(*(_t(v) for v in jcf[:-1]),
                                EventCounts(*(_t(e) for e in jcf.events)))


def _cfgs(**kw):
    base = dict(image_h=64, image_w=64, active_fraction=0.25)
    jf = j_fe.FrontendConfig(
        patch=j_proj.PatchSpec(16, 16, n_vectors=32,
                               summer=j_sc.SummerSpec(mode="passive", hold_time_s=0.0)),
        temporal=j_tm.TemporalSpec(delta_threshold=1e-3), **base)
    tf = t_fe.FrontendConfig(
        patch=t_proj.PatchSpec(16, 16, n_vectors=32,
                               summer=t_sc.SummerSpec(mode="passive", hold_time_s=0.0)),
        temporal=t_tm.TemporalSpec(delta_threshold=1e-3), **base)
    vit = dict(n_layers=2, d_model=32, n_heads=2, d_ff=64, quant_embed=True,
               saliency_layers="last", delta_kernel=True)
    vit.update(kw)
    return j_vit.ViTConfig(frontend=jf, **vit), t_vit.ViTConfig(frontend=tf, **vit)


@pytest.fixture(scope="module")
def served():
    jc, tc = _cfgs()
    jp = j_vit.prepare_quant_embed(j_vit.init_vit(jax.random.PRNGKey(0), jc))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


# ---- kernel 3's plain version --------------------------------------------

@pytest.mark.parametrize("s,dh", [(8, 16), (13, 24)])
@pytest.mark.parametrize("seed", [0, 1])
def test_delta_attention_plain_matches_pallas(seed, s, dh):
    """Counts empty, ragged and full, below 0 (act as 0) and above S (act
    as S); the last slot has no valid key and softmaxes uniformly over
    its S scores of -1e30, as the reference's dense encoder attention
    does. The Pallas kernel pads S up to a multiple of ``block_q`` with
    invalid zero keys, which join that uniform softmax: at S 13 its
    all-invalid slot is sum(v) / 16, where the dense arithmetic (and the
    port) give the mean over the 13 keys. Every other slot agrees with
    the Pallas kernel at atol 1e-6."""
    rng = np.random.default_rng(seed)
    b, h, block_q = 6, 2, 4
    q, k, v = (rng.normal(size=(b, s, h, dh)).astype(np.float32) for _ in range(3))
    mask = rng.random((b, s)) < 0.8
    mask[:, 0] = True
    mask[-1] = False
    counts = np.array([0, 3, s, -2, s + 5, s // 2], np.int32)
    want = np.asarray(delta_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.asarray(counts), block_q=block_q, interpret=True))
    got = t_ref.delta_attention_ref(_t(q), _t(k), _t(v), _t(mask), _t(counts)).numpy()
    np.testing.assert_allclose(got[:-1], want[:-1], atol=1e-6, rtol=1e-6)
    live = np.arange(s)[None, :] < np.clip(counts, 0, s)[:, None]
    assert (got[~live] == 0).all() and (want[~live] == 0).all()
    # the dense arithmetic of the reference's encoder attention, every slot
    sc = jnp.einsum("bqhk,bshk->bhqs", q, k) / jnp.sqrt(jnp.asarray(dh, jnp.float32))
    sc = jnp.where(jnp.asarray(mask)[:, None, None, :], sc, j_vit.NEG_INF)
    dense = np.asarray(jnp.einsum("bhqs,bshk->bqhk", jax.nn.softmax(sc, axis=-1), v))
    np.testing.assert_allclose(got[live], dense[live], atol=1e-6, rtol=1e-6)
    n, s_p = s // 2, -(-s // block_q) * block_q
    np.testing.assert_allclose(got[-1, :n], np.broadcast_to(v[-1].mean(0), (n, h, dh)),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(want[-1, :n],
                               np.broadcast_to(v[-1].sum(0) / s_p, (n, h, dh)),
                               atol=1e-6, rtol=1e-6)


def test_ops_delta_attention_matches_encoder_attention(served):
    jc, tc, jp, tp = served
    lp = tp["layers"][0]
    rng = np.random.default_rng(0)
    b, s, d = 3, tc.frontend.n_active, tc.d_model
    h = _t(rng.normal(size=(b, s, d)).astype(np.float32))
    valid = _t(np.array([[1, 1, 1, 1], [1, 1, 0, 1], [1, 0, 0, 0]], bool))
    counts = _t(np.array([4, 2, 0], np.int32))
    t_ops.reset_launches()
    out = t_ops.delta_attention(lp["attn"], h, valid, counts, tc.n_heads)
    assert t_ops.LAUNCHES["delta_attention"] == 0          # CPU: the plain version
    dense, _ = t_vit._encoder_attention(lp, h, tc, valid, need_probs=False)
    live = (torch.arange(s)[None, :] < counts[:, None])
    torch.testing.assert_close(out[live], dense[live], atol=ATOL, rtol=0)
    assert not out[~live].any()
    jout = np.asarray(j_ops.delta_attention(jp["layers"][0]["attn"], jnp.asarray(h.numpy()),
                                            jnp.asarray(valid.numpy()),
                                            jnp.asarray(counts.numpy()), jc.n_heads,
                                            block_q=4, interpret=True))
    np.testing.assert_allclose(out.numpy(), jout, atol=ATOL, rtol=0)


def test_stale_prefix_counts_and_wipe(served):
    jc, tc, _, _ = served
    q = np.array([[0, 0, 0, 0], [1, 0, 0, 0], [0, 1, 0, 1], [1, 1, 1, 1]], bool)
    np.testing.assert_array_equal(t_bd._stale_prefix_counts(_t(q)).numpy(),
                                  np.asarray(j_bd._stale_prefix_counts(jnp.asarray(q))))
    bc = t_bd.BackendCache(*(torch.ones_like(leaf) for leaf in t_bd.init_backend_cache(
        tc, tc.frontend.n_active, (3,), device="cpu")))
    hit = torch.tensor([True, False, True])
    wiped = t_bd.wipe_rows(bc, hit)
    for before, after in zip(bc, wiped):
        assert after.dtype == before.dtype
        assert not after[0].any() and not after[2].any()
        assert torch.equal(after[1], before[1])
    for a, b in zip(t_bd.init_backend_cache(tc, 4, (2,), device="cpu"),
                    j_bd.init_backend_cache(jc, 4, (2,))):
        assert tuple(a.shape) == b.shape and a.dtype == _t(b).dtype


# ---- delta_forward over a clip ---------------------------------------------

def _clip(jc, jp, frames):
    """The reference's gated frontend over ``frames`` (B, H, W, 3) each,
    with a fixed gaze: yields each frame's wire block."""
    pf = j_ops.ip2_codes_fn(jc.frontend.patch, jc.frontend.adc)
    frontend = jax.jit(lambda rgb, idx, cache: j_fe.apply_frontend(
        jp["ip2"], rgb, jc.frontend, mode="compact", indices=idx, cache=cache,
        project_fn=pf))
    idx = make_bootstrap_indices(jc)(jp, jnp.asarray(frames[0]))
    cache = j_tm.init_feature_cache(jc.frontend, (frames[0].shape[0],))
    for rgb in frames:
        cf, cache = frontend(jnp.asarray(rgb), idx, cache)
        yield cf


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_delta_forward_teacher_forced(served, eps):
    jc, tc, jp, tp = served
    imgs, _ = SceneStream(image=64).batch(0, 2)
    # panning, then a frozen frame: compute, partial reuse, fully cached
    frames = [np.roll(imgs, t, axis=2) for t in range(3)] + [np.roll(imgs, 2, axis=2)] * 2
    k = jc.frontend.n_active
    jbc = j_bd.init_backend_cache(jc, k, (2,), dtype=jnp.int8)
    jeps = jnp.full((2,), eps, jnp.float32)
    delta = jax.jit(lambda cf, bc, e: j_bd.delta_forward(
        jp, jc, cf, lambda: j_vit._embed_tokens(jp, cf, jc) + jp["pos"][cf.indices], bc, e))
    macs_seen = []
    for t, jcf in enumerate(_clip(jc, jp, frames)):
        tcf = _cf_to_torch(jcf)
        tbc = t_bd.BackendCache(*(_t(x) for x in jbc))
        jl, jr, jnew, jm = delta(jcf, jbc, jeps)
        tl, tr, tnew, tm = t_bd.delta_forward(
            tp, tc, tcf, lambda: t_vit._embed_tokens(tp, tcf, tc) + tp["pos"][tcf.indices.long()],
            tbc, _t(jeps))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0,
                                   err_msg=f"frame {t}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(np.asarray(tm, np.float32), np.asarray(jm))
        for name in ("feats", "gain", "indices", "tvalid", "valid"):
            np.testing.assert_array_equal(getattr(tnew, name).numpy(),
                                          np.asarray(getattr(jnew, name)))
        np.testing.assert_allclose(tnew.x_out.numpy(), np.asarray(jnew.x_out), atol=ATOL, rtol=0)
        if float(np.max(np.asarray(jm))) == 0.0:
            # the cached regime serves the cache bitwise, and keeps it
            assert torch.equal(tl, tbc.logits) and torch.equal(tr, tbc.received)
            assert all(torch.equal(a, b) for a, b in zip(tnew, tbc))
        macs_seen.append(np.asarray(jm))
        jbc = jnew
    # the clip runs all three regimes: cold (dense work), partial, cached
    macs_seen = np.stack(macs_seen)
    full = macs_seen[0].max()
    assert full > 0 and (macs_seen[-1] == 0.0).all(), macs_seen
    assert ((macs_seen > 0) & (macs_seen < full)).any(), macs_seen


def test_vit_forward_compact_validation(served):
    """The compact forward refuses what the reference refuses (its result
    with both caches is held against the reference in test_torch_engine)."""
    _, tc, _, tp = served
    k = tc.frontend.n_active
    rgb = torch.zeros((1, 64, 64, 3))
    with pytest.raises(ValueError, match="backend_eps"):
        t_vit.vit_forward_compact(tp, rgb, tc, backend_eps=torch.zeros(1))
    with pytest.raises(ValueError, match="dtype"):
        t_vit.vit_forward_compact(tp, rgb, tc, backend_cache=t_bd.init_backend_cache(
            tc, k, (1,), dtype=torch.float32, device="cpu"))
    with pytest.raises(ValueError, match="rows"):
        t_vit.vit_forward_compact(tp, rgb, tc, backend_cache=t_bd.init_backend_cache(
            tc, k + 1, (1,), device="cpu"))
    fused = dataclasses.replace(tc, fused_embed=True)
    with pytest.raises(ValueError, match="fused_embed"):
        t_vit.vit_forward_compact(tp, rgb, fused,
                                  backend_cache=t_bd.init_backend_cache(tc, k, (1,), device="cpu"))
    with pytest.raises(ValueError, match="fused_embed"):
        t_vit.vit_forward_compact(tp, rgb, fused,
                                  cache=t_tm.init_feature_cache(tc.frontend, (1,), device="cpu"))
    with pytest.raises(ValueError, match="fused_embed"):
        t_vit.vit_forward_compact(tp, rgb, fused, sign_mode=torch.zeros(1, dtype=torch.bool))


def test_delta_forward_device_select_both_branches(served):
    """The skip is a device-side select (the reference's ``lax.cond``):
    a frame with no changed row (the same scene again) and one with
    changed rows (the scene panned), each against the reference's
    delta_forward; the cached one serves the cache bitwise with 0 MACs, and
    neither reads a value back to the host (no ``aten._local_scalar_dense``,
    which ``bool(tensor)`` calls)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    jc, tc, jp, tp = served
    imgs, _ = SceneStream(seed=5, image=64).batch(0, 2)
    frames = [imgs, imgs, np.roll(imgs, 3, axis=2)]
    k = jc.frontend.n_active
    jbc = j_bd.init_backend_cache(jc, k, (2,), dtype=jnp.int8)
    jeps = jnp.zeros((2,), jnp.float32)
    regimes = []
    for t, jcf in enumerate(_clip(jc, jp, frames)):
        tcf = _cf_to_torch(jcf)
        tbc = t_bd.BackendCache(*(_t(x) for x in jbc))
        jl, jr, jnew, jm = j_bd.delta_forward(
            jp, jc, jcf, lambda: j_vit._embed_tokens(jp, jcf, jc) + jp["pos"][jcf.indices],
            jbc, jeps)
        with Ops() as rec:
            tl, tr, tnew, tm = t_bd.delta_forward(
                tp, tc, tcf,
                lambda: t_vit._embed_tokens(tp, tcf, tc) + tp["pos"][tcf.indices.long()],
                tbc, _t(jeps))
        assert "aten._local_scalar_dense.default" not in rec.names
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=ATOL, rtol=0)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        for name in ("feats", "gain", "indices", "tvalid", "valid"):
            np.testing.assert_array_equal(getattr(tnew, name).numpy(),
                                          np.asarray(getattr(jnew, name)))
        cached = float(np.max(np.asarray(jm))) == 0.0
        if cached:
            assert torch.equal(tl, tbc.logits) and torch.equal(tr, tbc.received)
            assert all(torch.equal(a, b) for a, b in zip(tnew, tbc))
        regimes.append(cached)
        jbc = jnew
    assert regimes == [False, True, False], regimes
