"""The serving path's constants are filled on the device, and an engine
tick makes no host round-trip.

On CUDA, ``torch.tensor(python_number, device=cuda)`` is a pageable
host-to-device copy followed by a stream synchronise. Each such site on
the step path now fills its constant on the device (``torch.full``) or
reads a cached device vector (``_arith.const_vector``). Here, on the CPU,
each new constant is held bitwise against the expression it replaced (both
round the Python double to float32 once), and a dispatch-level trace of
whole engine ticks shows no ``torch.tensor`` (``aten.lift_fresh``) and no
device-to-host scalar read (``aten._local_scalar_dense``, what ``bool()``,
``int()`` and ``.item()`` call, and what syncs on the card).
"""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._arith import const_vector, div
from repro_torch.convert import tree_to
from repro_torch.core import adc as adc_mod
from repro_torch.core import bayer as bayer_mod
from repro_torch.core import temporal as temporal_mod
from repro_torch.core.frontend import FrontendConfig
from repro_torch.core.projection import PatchSpec
from repro_torch.core.switched_cap import SummerSpec
from repro_torch.core.temporal import TemporalSpec
from repro_torch.kernels import ops
from repro_torch.models import vit as vit_mod
from repro_torch.serve import governor as gov_mod
from repro_torch.serve.engine import SaccadeEngine

VALUES = (0.1, 1.0 / 3.0, 63.0, 2.0 / 255.0, 2.0 / 1023.0, 0.9993, 1e-30, -1e30, 7.0)


class _Ops(TorchDispatchMode):
    """Records every aten op, and the divisors of ``aten.div``."""

    def __init__(self):
        super().__init__()
        self.names, self.divisors = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        if func is torch.ops.aten.div.Tensor:
            self.divisors.append(args[1])
        return func(*args, **(kwargs or {}))


def _bitwise(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("c", VALUES)
def test_div_is_the_tensor_division(c):
    """_arith.div: bitwise the division by a ``torch.tensor`` divisor, and
    still a division by a 0-dim tensor (a Python scalar would bring back
    PyTorch's reciprocal multiply on CUDA), with no host copy."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=257).astype(np.float32))
    with _Ops() as rec:
        got = div(x, c)
    assert _bitwise(got, x / torch.tensor(c, dtype=torch.float32))
    assert len(rec.divisors) == 1
    d = rec.divisors[0]
    assert isinstance(d, torch.Tensor) and d.dim() == 0 and d.dtype == torch.float32
    assert "aten.lift_fresh.default" not in rec.names


@pytest.mark.parametrize("bits", [8, 10, 16, 24])
@pytest.mark.parametrize("v_ref", [0.0, 0.25])
def test_readout_scale_zero_constants(bits, v_ref):
    spec = adc_mod.ADCSpec(bits=bits)
    half = spec.levels // 2
    for bias in (0.0, 0.037, torch.linspace(-0.1, 0.1, 7)):
        scale, zero = adc_mod.readout_scale_zero(v_ref, bias, spec)
        old_scale = torch.tensor(spec.lsb, dtype=torch.float32)
        old_zero = (torch.tensor(spec.v_min + half * spec.lsb - v_ref, dtype=torch.float32)
                    + torch.as_tensor(bias, dtype=torch.float32))
        assert _bitwise(scale, old_scale) and _bitwise(zero, old_zero)


def test_bayer_channel_map():
    cell = torch.tensor(((0, 1), (1, 2)), dtype=torch.int64)
    for h, w in ((2, 2), (7, 10), (32, 32)):
        rows = torch.arange(h)[:, None] % 2
        cols = torch.arange(w)[None, :] % 2
        assert _bitwise(bayer_mod.bayer_channel_map(h, w), cell[rows, cols])


@pytest.mark.parametrize("hold", [0.0, 0.01, 1.0])
def test_held_gain_droop(hold):
    fcfg = FrontendConfig(image_h=64, image_w=64, patch=PatchSpec(
        16, 16, n_vectors=8, summer=SummerSpec(mode="passive", hold_time_s=hold)))
    rng = np.random.default_rng(1)
    cache = temporal_mod.init_feature_cache(fcfg, (3,), device="cpu")
    cache = cache._replace(age=torch.from_numpy(rng.integers(0, 40, (3, 16)).astype(np.int32)),
                           valid=torch.from_numpy(rng.random((3, 16)) < 0.7))
    idx = torch.from_numpy(rng.integers(0, 16, (3, 4)).astype(np.int32))
    got = temporal_mod.held_gain(cache, idx, fcfg.patch.summer)
    age = temporal_mod.take_rows(cache.age, idx).to(torch.float32)
    d = torch.tensor(fcfg.patch.summer.droop_factor(), dtype=torch.float32)
    want = torch.pow(d, age) * temporal_mod.take_rows(cache.valid, idx).to(torch.float32)
    assert _bitwise(got, want)


@pytest.mark.parametrize("dh", [8, 16, 24, 64])
def test_attention_constants(dh):
    """The scores' 1/sqrt(dh) and the -1e30 mask, through the encoder's
    attention, against the expressions they replaced."""
    g = torch.Generator().manual_seed(dh)
    d, heads = dh * 2, 2
    lp = {"attn": {"wq": torch.randn((d, heads, dh), generator=g),
                   "wk": torch.randn((d, heads, dh), generator=g),
                   "wv": torch.randn((d, heads, dh), generator=g),
                   "bq": torch.randn((heads, dh), generator=g),
                   "bk": torch.randn((heads, dh), generator=g),
                   "bv": torch.randn((heads, dh), generator=g),
                   "wo": torch.randn((heads, dh, d), generator=g)}}
    cfg = vit_mod.ViTConfig(d_model=d, n_heads=heads)
    h = torch.randn((2, 5, d), generator=g)
    valid = torch.tensor([[True, True, False, True, True], [True] * 5])
    out, probs = vit_mod._encoder_attention(lp, h, cfg, valid)
    a = lp["attn"]
    q = torch.einsum("bsd,dhk->bshk", h, a["wq"]) + a["bq"]
    k = torch.einsum("bsd,dhk->bshk", h, a["wk"]) + a["bk"]
    v = torch.einsum("bsd,dhk->bshk", h, a["wv"]) + a["bv"]
    sc = torch.einsum("bqhk,bshk->bhqs", q, k) / torch.sqrt(torch.tensor(dh, dtype=h.dtype))
    sc = torch.where(valid[:, None, None, :], sc, torch.tensor(vit_mod.NEG_INF,
                                                               dtype=sc.dtype))
    want_p = torch.softmax(sc, dim=-1)
    assert _bitwise(probs, want_p)
    assert _bitwise(out, torch.einsum("bshk,hkd->bsd",
                                      torch.einsum("bhqs,bshk->bqhk", want_p, v), a["wo"]))


@pytest.mark.parametrize("eps", [0.0, 1e-3, 0.1])
def test_backend_eps_constant(eps):
    """A Python backend_eps is filled as the reference's float32 (the
    engine hands a tensor, which passes through)."""
    got = torch.full((3,), eps, dtype=torch.float32)
    assert _bitwise(got, torch.broadcast_to(torch.as_tensor(eps, dtype=torch.float32), (3,)))


@pytest.mark.parametrize("k", [4, 16, 37])
def test_tier_token_vector(k):
    spec = gov_mod.GovernorSpec(budget_mw=1.0, k_tiers=(1.0, 0.75, 0.5, 0.25, 0.1))
    got = const_vector(spec.tier_tokens(k), torch.int32, "cpu")
    assert _bitwise(got, torch.tensor(spec.tier_tokens(k), dtype=torch.int32))
    assert const_vector(spec.tier_tokens(k), torch.int32, "cpu") is got      # cached
    tier = torch.tensor([0, 1, 2, 3, 4, 6], dtype=torch.int32)
    want = torch.tensor(spec.tier_tokens(k), dtype=torch.int32)[tier.clamp_max(4).long()]
    assert _bitwise(gov_mod.tier_k_eff(spec, tier, k), want)
    with torch.inference_mode():
        inside = const_vector((1.5, 2.5, math.pi), torch.float32, "cpu")
    assert not inside.is_inference()          # usable outside inference mode too


def _gated_engine(sign_tier, capacity=4):
    fcfg = FrontendConfig(image_h=64, image_w=64, active_fraction=0.25,
                          patch=PatchSpec(16, 16, n_vectors=32, summer=SummerSpec(
                              mode="passive", hold_time_s=0.0)),
                          temporal=TemporalSpec(delta_threshold=1e-3, recompute_budget=2))
    cfg = vit_mod.ViTConfig(frontend=fcfg, n_layers=2, d_model=32, n_heads=2, d_ff=64,
                            quant_embed=True, saliency_layers="last", delta_kernel=True)
    params = vit_mod.prepare_quant_embed(
        vit_mod.init_vit(cfg, torch.Generator().manual_seed(0), device="cpu"))
    gov = gov_mod.GovernorSpec(budget_mw=0.05, sign_tier=sign_tier,
                               backend_eps=1e-3, refresh_horizon=2)
    eng = SaccadeEngine(cfg, tree_to(params, "cpu"), capacity=capacity, device="cpu",
                        temporal=True, governor=gov, backend_delta=True,
                        project_fn=ops.ip2_codes_fn(fcfg.patch, fcfg.adc))
    for i in range(capacity - 1):
        eng.admit(f"s{i}")
    return eng


@pytest.mark.parametrize("sign_tier", [False, True])
def test_engine_ticks_make_no_host_round_trip(sign_tier):
    """Whole ticks of the gated engine (temporal gate, governor, delta
    backend, staged kernel route's plain versions), issued with
    block=False and as a rollout, dispatch no ``torch.tensor`` and no
    device-to-host scalar read. With the sign tier the schedule reaches a
    fully cached tick (a held scene) besides computed ones, so both sides
    of the delta backend's device-side select run."""
    eng = _gated_engine(sign_tier)
    pool = np.random.default_rng(2).uniform(size=(3, 64, 64, 3)).astype(np.float32)
    eng.step({s: pool[0] for s in eng.stream_ids})          # admits flushed
    ticks = [{s: pool[0] for s in eng.stream_ids}] * 7 + [{"s0": pool[1]}, {"s0": pool[2]}]
    names, cached, handles = [], [], []
    for fr in ticks:
        with _Ops() as rec:
            handles.append(eng.step(fr, block=False))
        names += rec.names
        cached.append(eng.backend_cached("s0"))
    with _Ops() as rec:
        roll = eng.step_rollout(ticks[::-1], block=False)
    names += rec.names
    for bad in ("aten.lift_fresh.default", "aten._local_scalar_dense.default",
                "aten.nonzero.default"):
        assert bad not in names, bad
    assert False in cached, cached
    if sign_tier:
        # this engine's gaze settles on the held scene, which its backend
        # then serves from the cache; the other keeps moving its gaze
        assert True in cached, cached
    assert [set(h.result()) for h in handles] == [set(fr) for fr in ticks]
    assert len(roll.result()) == len(ticks)
