"""Port parity: the analog core (pwm, adc, bayer, projection, saliency,
power, frontend) against the JAX package on the same numpy inputs.

Integer outputs (codes, indices, masks, event counts) must match exactly;
float outputs that pass through a reduction (einsum, mean, convolution)
are held to atol 1e-6 because XLA and PyTorch sum in different orders.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as j_adc
from repro.core import bayer as j_bayer
from repro.core import frontend as j_fe
from repro.core import power as j_power
from repro.core import projection as j_proj
from repro.core import pwm as j_pwm
from repro.core import saliency as j_sal
from repro_torch.core import adc as t_adc
from repro_torch.core import bayer as t_bayer
from repro_torch.core import frontend as t_fe
from repro_torch.core import power as t_power
from repro_torch.core import projection as t_proj
from repro_torch.core import pwm as t_pwm
from repro_torch.core import saliency as t_sal

RNG = np.random.default_rng(0)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _specs(spec):
    """The port's twin of a reference dataclass instance (same fields)."""
    mapping = {
        j_pwm.QuantSpec: t_pwm.QuantSpec, j_adc.ADCSpec: t_adc.ADCSpec,
        j_proj.PatchSpec: t_proj.PatchSpec,
    }
    kw = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        kw[f.name] = _specs(v) if type(v) in mapping else v
    if type(spec) is j_proj.PatchSpec:
        from repro_torch.core.analog_nl import AnalogNLSpec
        from repro_torch.core.switched_cap import SummerSpec
        kw["summer"] = SummerSpec(**dataclasses.asdict(spec.summer))
        kw["nl"] = AnalogNLSpec(**dataclasses.asdict(spec.nl))
    return mapping[type(spec)](**kw)


def _pixels(shape):
    x = RNG.uniform(-0.2, 1.2, size=shape).astype(np.float32)
    # exact PWM rounding boundaries (k + 0.5)/63 exercise half-to-even
    flat = x.reshape(-1)
    flat[: 64] = ((np.arange(64) + 0.5) / 63).astype(np.float32)
    return x


class TestPWM:
    @pytest.mark.parametrize("bits", [4, 6])
    def test_pwm_quantize_exact(self, bits):
        x = _pixels((37, 53))
        js, ts = j_pwm.QuantSpec(pwm_bits=bits), t_pwm.QuantSpec(pwm_bits=bits)
        np.testing.assert_array_equal(
            _n(t_pwm.pwm_quantize(_t(x), ts)),
            np.asarray(j_pwm.pwm_quantize(jnp.asarray(x), js)))

    def test_quantize_weights_exact(self):
        w = RNG.normal(size=(24, 64)).astype(np.float32) * 3.0
        jq, js = j_pwm.quantize_weights(jnp.asarray(w))
        tq, ts = t_pwm.quantize_weights(_t(w))
        np.testing.assert_array_equal(_n(tq), np.asarray(jq))
        np.testing.assert_array_equal(_n(ts), np.asarray(js))


class TestADC:
    @pytest.mark.parametrize("bits", [6, 8, 10, 16, 24])
    def test_encode_and_readout_exact(self, bits):
        v = RNG.uniform(-1.3, 1.3, size=(400,)).astype(np.float32)
        js, ts = j_adc.ADCSpec(bits=bits), t_adc.ADCSpec(bits=bits)
        # exact code boundaries
        v[:50] = (np.arange(50) * js.lsb + js.lsb / 2 - 1.0).astype(np.float32)
        jc, tc = j_adc.encode(jnp.asarray(v), js), t_adc.encode(_t(v), ts)
        assert str(tc.dtype).split(".")[-1] == str(jc.dtype)
        np.testing.assert_array_equal(_n(tc), np.asarray(jc))
        bias = RNG.normal(size=(400,)).astype(np.float32) * 0.1
        np.testing.assert_array_equal(
            _n(t_adc.digital_readout(_t(v), 0.1, _t(bias), ts)),
            np.asarray(j_adc.digital_readout(jnp.asarray(v), 0.1,
                                             jnp.asarray(bias), js)))
        for a, b in zip(t_adc.readout_scale_zero(0.1, _t(bias), ts),
                        j_adc.readout_scale_zero(0.1, jnp.asarray(bias), js)):
            np.testing.assert_array_equal(_n(a), np.asarray(b))


class TestBayerProjection:
    def test_mosaic_strike_extract_exact(self):
        rgb = RNG.uniform(size=(2, 32, 48, 3)).astype(np.float32)
        np.testing.assert_array_equal(_n(t_bayer.mosaic(_t(rgb))),
                                      np.asarray(j_bayer.mosaic(jnp.asarray(rgb))))
        a = RNG.normal(size=(5, 16 * 8 * 3)).astype(np.float32)
        np.testing.assert_array_equal(
            _n(t_bayer.strike_columns(_t(a), 16, 8)),
            np.asarray(j_bayer.strike_columns(jnp.asarray(a), 16, 8)))
        frame = rgb[..., 0]
        np.testing.assert_array_equal(
            _n(t_proj.extract_patches(_t(frame), 16, 8)),
            np.asarray(j_proj.extract_patches(jnp.asarray(frame), 16, 8)))

    @pytest.mark.parametrize("cutoff", [0.5, 0.25])
    def test_antialias_close(self, cutoff):
        np.testing.assert_allclose(
            _n(t_bayer.gaussian_kernel_1d(cutoff)),
            np.asarray(j_bayer.gaussian_kernel_1d(cutoff)), atol=0, rtol=1e-6)  # exp: ulps
        x = RNG.uniform(size=(2, 24, 40)).astype(np.float32)
        np.testing.assert_allclose(
            _n(t_bayer.antialias(_t(x), cutoff)),
            np.asarray(j_bayer.antialias(jnp.asarray(x), cutoff)), atol=1e-6, rtol=0)

    def test_analog_project_patches_close(self):
        spec = j_proj.PatchSpec(patch_h=16, patch_w=16, n_vectors=24)
        p = RNG.uniform(size=(3, 5, 256)).astype(np.float32)
        w = RNG.normal(size=(24, 256)).astype(np.float32) * 6.0
        np.testing.assert_allclose(
            _n(t_proj.analog_project_patches(_t(p), _t(w), _specs(spec))),
            np.asarray(j_proj.analog_project_patches(jnp.asarray(p), jnp.asarray(w), spec)),
            atol=1e-6, rtol=0)


class TestSaliency:
    def test_topk_ties_lowest_index_first(self):
        s = np.array([[0.5, 1.0, 1.0, 0.2, 1.0, 0.5, 0.5, 0.0],
                      [0.0] * 8,
                      [3.0, 1.0, 3.0, 1.0, 3.0, 1.0, 3.0, 1.0]], np.float32)
        for k in (1, 3, 5, 8):
            np.testing.assert_array_equal(
                _n(t_sal.topk_patch_indices(_t(s), k)),
                np.asarray(j_sal.topk_patch_indices(jnp.asarray(s), k)))

    def test_topk_random_and_gather_exact(self):
        s = RNG.integers(0, 6, size=(4, 64)).astype(np.float32)  # many ties
        ti = t_sal.topk_patch_indices(_t(s), 16)
        ji = j_sal.topk_patch_indices(jnp.asarray(s), 16)
        np.testing.assert_array_equal(_n(ti), np.asarray(ji))
        assert ti.dtype == torch.int32
        p = RNG.uniform(size=(4, 64, 7)).astype(np.float32)
        np.testing.assert_array_equal(
            _n(t_sal.gather_patches(_t(p), ti)),
            np.asarray(j_sal.gather_patches(jnp.asarray(p), ji)))
        np.testing.assert_array_equal(
            _n(t_sal.mask_from_indices(ti, 64)),
            np.asarray(j_sal.mask_from_indices(ji, 64)))

    def test_indices_from_mask_exact(self):
        m = RNG.uniform(size=(3, 20)) < 0.3
        m[1] = False
        for a, b in zip(t_sal.indices_from_mask(_t(m), 6),
                        j_sal.indices_from_mask(jnp.asarray(m), 6)):
            np.testing.assert_array_equal(_n(a), np.asarray(b))

    def test_patch_energy_close(self):
        p = RNG.uniform(size=(3, 16, 256)).astype(np.float32)
        np.testing.assert_allclose(
            _n(t_sal.patch_energy(_t(p))),
            np.asarray(j_sal.patch_energy(jnp.asarray(p))), atol=1e-7, rtol=1e-5)


class TestPowerFrontend:
    def test_frame_events_and_meter(self):
        n_sel = np.array([16.0, 3.0, 0.0], np.float32)
        te = t_power.frontend_frame_events(65536.0, 1024, 192, _t(n_sel), _t(n_sel))
        je = j_power.frontend_frame_events(65536.0, 1024, 192, jnp.asarray(n_sel),
                                           jnp.asarray(n_sel))
        assert te._fields == je._fields
        for a, b in zip(te, je):
            np.testing.assert_array_equal(_n(a), np.asarray(b))
        ev = j_power.EventCounts(*(float(np.asarray(e)[0]) for e in je))
        assert t_power.EnergyMeter().power_mw(t_power.EventCounts(*ev), 30.0) == \
            j_power.EnergyMeter().power_mw(ev, 30.0)

    def test_compact_frontend_codes(self):
        """Sensor stage + energy top-k + plain projection + ADC codes: indices
        exact, codes within the counted 1-LSB rule."""
        jcfg = j_fe.FrontendConfig(
            image_h=64, image_w=64,
            patch=j_proj.PatchSpec(patch_h=16, patch_w=16, n_vectors=32),
            active_fraction=0.25)
        tcfg = t_fe.FrontendConfig(
            image_h=64, image_w=64,
            patch=t_proj.PatchSpec(patch_h=16, patch_w=16, n_vectors=32),
            active_fraction=0.25)
        a = (RNG.normal(size=(32, 256 * 3)) * 6.4).astype(np.float32)
        bias = (RNG.normal(size=(32,)) * 0.05).astype(np.float32)
        rgb = RNG.uniform(size=(3, 64, 64, 3)).astype(np.float32)
        jp = {"a_rgb": jnp.asarray(a), "bias": jnp.asarray(bias)}
        tp = {"a_rgb": _t(a), "bias": _t(bias)}
        (jpat, jw), (tpat, tw) = (j_fe.sensor_patches(jp, jnp.asarray(rgb), jcfg),
                                  t_fe.sensor_patches(tp, _t(rgb), tcfg))
        np.testing.assert_allclose(_n(tpat), np.asarray(jpat), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(_n(tw), np.asarray(jw))
        jcf = j_fe.apply_frontend(jp, jnp.asarray(rgb), jcfg, mode="compact")
        tcf = t_fe.apply_frontend(tp, _t(rgb), tcfg, mode="compact")
        np.testing.assert_array_equal(_n(tcf.indices), np.asarray(jcf.indices))
        np.testing.assert_array_equal(_n(tcf.valid), np.asarray(jcf.valid))
        np.testing.assert_array_equal(_n(tcf.zero), np.asarray(jcf.zero))
        dc = _n(tcf.features).astype(int) - np.asarray(jcf.features).astype(int)
        assert np.abs(dc).max() <= 1
        assert (np.abs(dc).max(-1) > 0).sum() <= 1, "1-LSB rows over bound"
        for a_, b_ in zip(tcf.events, jcf.events):
            np.testing.assert_array_equal(_n(a_), np.asarray(b_))
        np.testing.assert_allclose(
            _n(t_fe.dequantize_features(tcf)),
            np.asarray(j_fe.dequantize_features(jcf)), atol=float(jcfg.adc.lsb) + 1e-6)


@pytest.mark.parametrize("bits", [8, 10, 16])
@pytest.mark.parametrize("v_ref", [0.0, 0.3, -1.5])
def test_sign_code_points(bits, v_ref):
    """The sign tier's code points: exact against the reference (V_R
    inside and outside the ADC range)."""
    assert t_adc.SIGN_V_MAG == j_adc.SIGN_V_MAG
    got = t_adc.sign_code_points(v_ref, t_adc.ADCSpec(bits=bits))
    want = j_adc.sign_code_points(v_ref, j_adc.ADCSpec(bits=bits))
    assert got == want and all(isinstance(c, int) for c in got)
    assert got[1] >= got[2]
