"""Port parity: the paper's accounting (Table 1 area, the §2.1.3 power
report and data reduction, the Fig. 3 throughput model), the §2.1.2
switched-capacitor helpers and the pwm, adc and bayer leaf helpers,
against the JAX package on the same seeded numpy inputs.

Tolerances. The power, data-reduction and throughput models are Python
float64 arithmetic in both packages: rtol 1e-12. Float32 arrays are
compared bitwise, except two whose arithmetic differs between XLA and
PyTorch: ``charge_share_sum`` on random charges (the fp32 mean sums in
another order: atol 5e-7 on 1536 charges in [-1, 1], measured up to
1.2e-7; bitwise on the paper's 768 + 768 datum) and
``passive_droop_trace`` (the two float32 ``exp`` implementations differ
by up to 2 ulp: rtol 3e-7). The assertions of
``tests/test_paper_claims.py`` are repeated on the port's own numbers.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as j_adc
from repro.core import bayer as j_bayer
from repro.core import power as j_pw
from repro.core import pwm as j_pwm
from repro.core import switched_cap as j_sc
from repro.core import throughput as j_tp
from repro_torch.core import adc as t_adc
from repro_torch.core import bayer as t_bayer
from repro_torch.core import power as t_pw
from repro_torch.core import pwm as t_pwm
from repro_torch.core import switched_cap as t_sc
from repro_torch.core import throughput as t_tp

RTOL = 1e-12


def _rng(seed):
    return np.random.default_rng(seed)


def _same(t, j):
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# switched capacitors (paper §2.1.2)
# ---------------------------------------------------------------------------

def test_leak_constants_equal_reference():
    assert t_sc.TAU_LEAK_65NM_S == j_sc.TAU_LEAK_65NM_S
    assert t_sc.TAU_LEAK_22NM_FDX_S == j_sc.TAU_LEAK_22NM_FDX_S


@pytest.mark.parametrize("mode", ["passive", "opamp"])
@pytest.mark.parametrize("tau", [j_sc.TAU_LEAK_65NM_S, j_sc.TAU_LEAK_22NM_FDX_S])
def test_charge_share_sum(mode, tau):
    kw = dict(mode=mode, tau_leak_s=tau, v_ref=0.125)
    datum = np.concatenate([np.ones(768), np.zeros(768)]).astype(np.float32)
    _same(t_sc.charge_share_sum(torch.from_numpy(datum), t_sc.SummerSpec(**kw)),
          j_sc.charge_share_sum(jnp.asarray(datum), j_sc.SummerSpec(**kw)))
    v = _rng(1).uniform(-1, 1, size=(3, 5, 1536)).astype(np.float32)
    for axis in (-1, 1):
        got = t_sc.charge_share_sum(torch.from_numpy(v), t_sc.SummerSpec(**kw), axis=axis)
        want = j_sc.charge_share_sum(jnp.asarray(v), j_sc.SummerSpec(**kw), axis=axis)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-7, rtol=0)


@pytest.mark.parametrize("tau", [j_sc.TAU_LEAK_65NM_S, j_sc.TAU_LEAK_22NM_FDX_S])
def test_passive_droop_trace(tau):
    rng = _rng(2)
    v0 = rng.uniform(0, 1, size=(64, 1)).astype(np.float32)
    times = rng.uniform(0, 1e-3, size=(50,)).astype(np.float32)
    got = t_sc.passive_droop_trace(torch.from_numpy(v0), torch.from_numpy(times), tau)
    want = j_sc.passive_droop_trace(jnp.asarray(v0), jnp.asarray(times), tau)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-7, atol=0)


@pytest.mark.parametrize("n_extra", [0, 1, 3, 7])
def test_capacitor_divider_and_series_add(n_extra):
    rng = _rng(3 + n_extra)
    a, b = (rng.uniform(-1, 1, size=(16, 9)).astype(np.float32) for _ in range(2))
    _same(t_sc.capacitor_divider(torch.from_numpy(a), n_extra),
          j_sc.capacitor_divider(jnp.asarray(a), n_extra))
    for sub in (False, True):
        _same(t_sc.series_add(torch.from_numpy(a), torch.from_numpy(b), subtract=sub),
              j_sc.series_add(jnp.asarray(a), jnp.asarray(b), subtract=sub))


# ---------------------------------------------------------------------------
# pwm, adc and bayer leaf helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [(6, 6), (4, 8), (8, 4)])
def test_pwm_helpers(bits):
    pb, wb = bits
    jspec, tspec = j_pwm.QuantSpec(pb, wb), t_pwm.QuantSpec(pb, wb)
    rng = _rng(pb * 10 + wb)
    px = rng.uniform(-0.2, 1.2, size=(7, 64)).astype(np.float32)
    w = (rng.normal(size=(12, 64)) * 3.0).astype(np.float32)
    _same(t_pwm.pwm_codes(torch.from_numpy(px), tspec), j_pwm.pwm_codes(jnp.asarray(px), jspec))
    for per in (True, False):
        tc, ts = t_pwm.weight_codes(torch.from_numpy(w), tspec, per_output_scale=per)
        jc, js = j_pwm.weight_codes(jnp.asarray(w), jspec, per_output_scale=per)
        _same(tc, jc)
        _same(ts, js)
    _same(t_pwm.analog_multiply(torch.from_numpy(px[:, None, :]), torch.from_numpy(w), tspec),
          j_pwm.analog_multiply(jnp.asarray(px[:, None, :]), jnp.asarray(w), jspec))


@pytest.mark.parametrize("bits", [4, 8, 10])
@pytest.mark.parametrize("ste", [True, False])
def test_adc_helpers(bits, ste):
    jspec = j_adc.ADCSpec(bits=bits, v_min=-0.75, v_max=1.25, ste=ste)
    tspec = t_adc.ADCSpec(bits=bits, v_min=-0.75, v_max=1.25, ste=ste)
    rng = _rng(bits)
    v = rng.uniform(-1.2, 1.6, size=(9, 24)).astype(np.float32)
    bias = (rng.normal(size=(24,)) * 0.1).astype(np.float32)
    _same(t_adc.adc_quantize(torch.from_numpy(v), tspec), j_adc.adc_quantize(jnp.asarray(v), jspec))
    tc = t_adc.digital_codes(torch.from_numpy(v), 0.25, torch.from_numpy(bias), tspec)
    jc = j_adc.digital_codes(jnp.asarray(v), 0.25, jnp.asarray(bias), jspec)
    assert isinstance(tc, t_adc.ADCCodes) and type(tc)._fields == type(jc)._fields
    for a, b in zip(tc, jc):
        _same(a, b)
    # the wire contract: dequantised codes are the float readout
    assert torch.equal(t_adc.dequantize(*tc),
                       t_adc.digital_readout(torch.from_numpy(v), 0.25,
                                             torch.from_numpy(bias), tspec))


def test_adc_quantize_passes_gradients_inside_the_rails():
    v = torch.tensor([-2.0, -0.5, 0.0, 0.3, 2.0], requires_grad=True)
    t_adc.adc_quantize(v, t_adc.ADCSpec()).sum().backward()
    assert v.grad.tolist() == [0.0, 1.0, 1.0, 1.0, 0.0]


def test_downsample2():
    x = _rng(5).uniform(size=(2, 3, 10, 13)).astype(np.float32)
    _same(t_bayer.downsample2(torch.from_numpy(x)), j_bayer.downsample2(jnp.asarray(x)))


# ---------------------------------------------------------------------------
# Table 1 area, §2.1.3 power, data reduction, Fig. 3 throughput
# ---------------------------------------------------------------------------

def test_area_budget_equals_reference():
    assert t_pw.TABLE1_ROWS == j_pw.TABLE1_ROWS
    assert t_pw.AreaBudget().totals() == j_pw.AreaBudget().totals()
    rows = j_pw.TABLE1_ROWS[:3]
    assert t_pw.AreaBudget(rows).totals() == j_pw.AreaBudget(rows).totals()


SENSORS = [dict(), dict(active_fraction=1.0), dict(active_fraction=0.125),
           dict(n_pixels=0.92e6, frame_hz=90.0, patch_h=16, patch_w=16, n_vectors=192),
           dict(patch_h=8, patch_w=8, n_vectors=48, active_fraction=0.4)]


def _close(a, b):
    assert a == pytest.approx(b, rel=RTOL, abs=0.0)


@pytest.mark.parametrize("kw", SENSORS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in
                                                                  kw.items()) or "default")
def test_power_and_reduction_equal_reference(kw):
    tcfg, jcfg = t_pw.SensorConfig(**kw), j_pw.SensorConfig(**kw)
    for readout in ("adc", "sign"):
        te = t_pw.steady_state_events(tcfg, readout)
        je = j_pw.steady_state_events(jcfg, readout)
        assert te._fields == je._fields
        for a, b in zip(te, je):
            _close(a, b)
    consts = [j_pw.EnergyConstants(), j_pw.EnergyConstants(e_adc_j=1e-9, compute_duty=0.25)]
    for k in consts:
        tk = t_pw.EnergyConstants(**dataclasses.asdict(k))
        tr, jr = t_pw.power_report(tcfg, tk), j_pw.power_report(jcfg, k)
        assert isinstance(tr, t_pw.PowerReport)
        assert list(tr.components) == list(jr.components)
        for name in jr.components:
            _close(tr.components[name], jr.components[name])
        _close(tr.total_w, jr.total_w)
        _close(tr.mw_per_mpix, jr.mw_per_mpix)
        for name, v in jr.share().items():
            _close(tr.share()[name], v)
        assert tr.dominant == jr.dominant and tr.adc_dominated == jr.adc_dominated
    for vs_rgb in (False, True):
        _close(t_pw.data_reduction(tcfg, vs_rgb), j_pw.data_reduction(jcfg, vs_rgb))


def test_event_counts_add_and_zeros():
    a = t_pw.steady_state_events(t_pw.SensorConfig())
    b = t_pw.conv_frame_events(4096.0, 64, 16, 225.0, reprogram=True)
    ja = j_pw.steady_state_events(j_pw.SensorConfig())
    jb = j_pw.conv_frame_events(4096.0, 64, 16, 225.0, reprogram=True)
    assert tuple(a.add(b)) == tuple(ja.add(jb))
    assert tuple(t_pw.EventCounts.zeros()) == tuple(j_pw.EventCounts.zeros())
    assert tuple(a.add(t_pw.EventCounts.zeros())) == tuple(a)


def test_throughput_equals_reference():
    assert t_tp.SENSOR_FORMATS == j_tp.SENSOR_FORMATS
    assert (t_tp.T_LOAD_S, t_tp.T_PWM_S) == (j_tp.T_LOAD_S, j_tp.T_PWM_S)
    for rows in (8, 16, 24, 32):
        for c in (1, 2, 3, 4, 8):
            _close(t_tp.vector_time(rows, c), j_tp.vector_time(rows, c))
            _close(t_tp.vector_time(rows, c, 2e-6, 5e-6), j_tp.vector_time(rows, c, 2e-6, 5e-6))
            for nv in (48, 192, 400, 768):
                _close(t_tp.frame_rate(rows, nv, c), j_tp.frame_rate(rows, nv, c))
    for fmt in ("720p", "1080p"):
        tp_, jp_ = t_tp.rate_point(fmt, 2, 32, 400), j_tp.rate_point(fmt, 2, 32, 400)
        assert dataclasses.astuple(tp_)[:4] == dataclasses.astuple(jp_)[:4]
        for a, b in zip(dataclasses.astuple(tp_)[4:], dataclasses.astuple(jp_)[4:]):
            _close(a, b)
    ts, js = t_tp.figure3_sweep(), j_tp.figure3_sweep()
    assert len(ts) == len(js) == 16
    for a, b in zip(ts, js):
        assert dataclasses.astuple(a)[:4] == dataclasses.astuple(b)[:4]
        for x, y in zip(dataclasses.astuple(a)[4:], dataclasses.astuple(b)[4:]):
            _close(x, y)


# ---------------------------------------------------------------------------
# tests/test_paper_claims.py, on the port's numbers
# ---------------------------------------------------------------------------

class TestPortTable1Area:
    def test_total_and_pitch(self):
        totals = t_pw.AreaBudget().totals()
        assert totals["Total"]["total_um2"] == 485.0
        assert totals["Total"]["pitch_um"] == pytest.approx(22.0, abs=0.05)

    def test_row_inventory(self):
        totals = t_pw.AreaBudget().totals()
        assert totals["Cap 30 fF"]["count"] == 3
        assert totals["Transistors"]["count"] == 41
        assert totals["Photo Sensor"]["total_um2"] == 64.0
        occ = sum(v["occupancy"] for k, v in totals.items() if k != "Total")
        assert occ == pytest.approx(1.0)


class TestPortPowerClaims:
    def test_2mpix_30hz_under_60mw(self):
        rep = t_pw.power_report(t_pw.SensorConfig())
        assert 20.0 < rep.total_w * 1e3 < 60.0

    def test_under_30mw_per_mpix(self):
        assert 10.0 < t_pw.power_report(t_pw.SensorConfig()).mw_per_mpix < 30.0

    def test_adc_is_majority_consumer(self):
        rep = t_pw.power_report(t_pw.SensorConfig())
        assert rep.adc_dominated and rep.dominant == "adc"
        others = {k: v for k, v in rep.components.items() if k != "adc"}
        assert rep.components["adc"] > max(others.values())

    def test_active_fraction_gates_conversion_power(self):
        assert t_pw.power_report(t_pw.SensorConfig(active_fraction=1.0)).mw_per_mpix > 30.0


class TestPortDroopClaims:
    @staticmethod
    def _datum():
        return torch.cat([torch.ones(768), torch.zeros(768)])

    def test_10us_passive_droop_datum(self):
        out = float(t_sc.charge_share_sum(self._datum(), t_sc.SummerSpec(mode="passive")))
        assert out == pytest.approx(0.45, abs=1e-3)

    def test_tau_calibration(self):
        assert math.exp(-10e-6 / t_sc.TAU_LEAK_65NM_S) == pytest.approx(0.9, rel=1e-9)
        trace = t_sc.passive_droop_trace(torch.tensor(0.5), torch.tensor([10e-6]))
        assert float(trace[0]) == pytest.approx(0.45, rel=1e-5)

    def test_opamp_holds_the_half_volt(self):
        out = float(t_sc.charge_share_sum(self._datum(), t_sc.SummerSpec(mode="opamp")))
        assert out == pytest.approx(0.5, abs=1e-3)

    def test_22nm_fdx_barely_leaks(self):
        out = float(t_sc.charge_share_sum(self._datum(), t_sc.SummerSpec(
            mode="passive", tau_leak_s=t_sc.TAU_LEAK_22NM_FDX_S)))
        assert out > 0.499


class TestPortThroughputClaims:
    def test_1080p_c2_400vec_is_90hz(self):
        assert 85.0 <= t_tp.rate_point("1080p", 2, 32, 400).frame_hz <= 95.0

    def test_8x8_192vec_exceeds_30hz(self):
        assert t_tp.frame_rate(8, 192, 2) > 30.0

    def test_more_weight_lines_is_faster(self):
        rates = [t_tp.frame_rate(32, 400, c) for c in (1, 2, 4, 8)]
        assert rates == sorted(rates) and rates[-1] > rates[0]


class TestPortDataReductionClaims:
    def test_10x_vs_bayer_raw(self):
        assert 10.0 <= t_pw.data_reduction(t_pw.SensorConfig()) < 12.0

    def test_30x_vs_interpolated_rgb(self):
        assert 30.0 <= t_pw.data_reduction(t_pw.SensorConfig(), vs_rgb=True) < 36.0

    def test_reduction_scales_with_gating(self):
        base = t_pw.data_reduction(t_pw.SensorConfig())
        half = t_pw.data_reduction(t_pw.SensorConfig(active_fraction=0.125))
        assert half == pytest.approx(2.0 * base, rel=1e-6)


def test_quickstart_on_the_cpu_matches_the_reference_report(capsys):
    """The port's quickstart with ``--device cpu``: the report lines carry
    the reference's figures, and the plain projection route agrees with
    the plain analog model."""
    from repro_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu"])
    rep = j_pw.power_report(j_pw.SensorConfig())
    _close(out["power_mw"], rep.total_w * 1e3)
    _close(out["mw_per_mpix"], rep.mw_per_mpix)
    _close(out["frame_hz"], j_tp.rate_point("1080p", 2, 32, 400).frame_hz)
    assert out["area_um2"] == 485.0
    assert out["n_active"] == 16 and out["compact_shape"] == (2, 16, 48)
    assert out["kernel_max_abs_diff"] <= 1e-5
    assert "mW/Mpix" in capsys.readouterr().out
