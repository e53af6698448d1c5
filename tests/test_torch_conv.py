"""Port parity: conv-in-pixel mode (``ConvSpec``, ``extract_windows``,
``ops.ip2_conv`` over the projection kernel's plain version, its Python-loop
oracle ``ref.ip2_conv_ref``, ``conv_frame_events``) against the JAX
package, whose ``ops.ip2_conv`` runs its Pallas kernel in interpret mode.

Tolerances: the float readout at atol 1e-5 (the reference's own conv test);
codes and sign bits by counting moved rows, at most 1 LSB on at most 2 rows
per call (an fp32 sum on an ADC or comparator boundary); window gathers,
geometry and events exact. Conv weights are a plain (C, K²) array, carried
across by ``params_from_numpy`` like the ViT's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as j_adc
from repro.core import power as j_pw
from repro.core import projection as j_proj
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro_torch.convert import params_from_numpy
from repro_torch.core import adc as t_adc
from repro_torch.core import power as t_pw
from repro_torch.core import projection as t_proj
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref

CASES = [(8, 8), (8, 4), (16, 8)]
READOUTS = ["float", "codes", "sign"]


def _inputs(kernel, seed=0, b=2, h=32, w=32):
    rng = np.random.default_rng(seed)
    frame = rng.uniform(size=(b, h, w)).astype(np.float32)
    wts = (rng.normal(size=(16, kernel * kernel)) * 3.0).astype(np.float32)
    bias = (rng.normal(size=(16,)) * 0.1).astype(np.float32)
    return frame, wts, bias


def _kw(readout, adc):
    return {"float": {}, "codes": {"adc": adc, "codes": True},
            "sign": {"readout": "sign"}}[readout]


def _moved_rows(a, b):
    """Rows of two integer payloads that differ, asserting at most 1 LSB."""
    d = np.abs(a.reshape(-1, a.shape[-1]).astype(np.int64)
               - b.reshape(-1, b.shape[-1]).astype(np.int64))
    assert d.max(initial=0) <= 1, f"a code moved by {d.max()} LSB"
    return int((d.max(-1) > 0).sum())


@pytest.mark.parametrize("kernel,stride", CASES)
@pytest.mark.parametrize("readout", READOUTS)
def test_ip2_conv_matches_reference(kernel, stride, readout):
    """ops.ip2_conv on CPU tensors (im2col + kernel 6's plain version)
    against the JAX wrapper over its Pallas kernel, in interpret mode."""
    frame, wts, bias = _inputs(kernel, seed=kernel + stride)
    tw = params_from_numpy(wts, device="cpu")
    jconv = j_proj.ConvSpec(kernel=kernel, stride=stride, n_channels=16)
    tconv = t_proj.ConvSpec(kernel=kernel, stride=stride, n_channels=16)
    jb = jnp.asarray(bias) if readout == "codes" else None
    tb = torch.from_numpy(bias) if readout == "codes" else None
    want = np.asarray(j_ops.ip2_conv(jnp.asarray(frame), jnp.asarray(wts), jconv, bias=jb,
                                     interpret=True, **_kw(readout, j_adc.ADCSpec(bits=8))))
    got = t_ops.ip2_conv(torch.from_numpy(frame), tw, tconv, bias=tb,
                         **_kw(readout, t_adc.ADCSpec(bits=8))).numpy()
    gh, gw = tconv.out_grid(32, 32)
    assert got.shape == want.shape == (2, gh * gw, 16)
    assert got.dtype == want.dtype
    if readout == "float":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert _moved_rows(got, want) <= 2


@pytest.mark.parametrize("kernel,stride", CASES)
@pytest.mark.parametrize("readout", READOUTS)
def test_ip2_conv_equals_its_python_loop_oracle(kernel, stride, readout):
    """The wrapper (``extract_windows`` + the projection) against the
    explicit window slicing of ``ref.ip2_conv_ref``, in the port and in the
    reference; unbatched frames and ``ProgrammedWeights`` too."""
    frame, wts, bias = _inputs(kernel, seed=10 + kernel + stride)
    conv = t_proj.ConvSpec(kernel=kernel, stride=stride, n_channels=16)
    adc = t_adc.ADCSpec(bits=8)
    kw = _kw(readout, adc)
    b = torch.from_numpy(bias) if readout == "codes" else None
    f, w = torch.from_numpy(frame), torch.from_numpy(wts)
    w_q = t_ops._dac_weights(w, conv.patch_spec())
    params = t_ops.kernel_params_from_spec(conv.patch_spec(), kw.get("adc"),
                                           kw.get("codes", False), kw.get("readout", "adc"))

    def oracle(x):
        out = t_ref.ip2_conv_ref(x, w_q.T, b if b is not None else torch.zeros(16), conv,
                                 params)
        return out.to(torch.bool) if readout == "sign" else out

    got = t_ops.ip2_conv(f, w, conv, bias=b, **kw)
    assert torch.equal(got, oracle(f))
    programmed = t_ops.program_weights(w, conv.patch_spec())
    assert torch.equal(t_ops.ip2_conv(f, programmed, conv, bias=b, **kw), got)
    # an unbatched frame: the same function of one frame's windows
    assert torch.equal(t_ops.ip2_conv(f[1], w, conv, bias=b, **kw), oracle(f[1]))
    # the port's oracle against the reference's on the same DAC grid
    jconv = j_proj.ConvSpec(kernel=kernel, stride=stride, n_channels=16)
    jparams = j_ops.kernel_params_from_spec(
        jconv.patch_spec(), j_adc.ADCSpec(bits=8) if readout == "codes" else None,
        readout == "codes", "sign" if readout == "sign" else "adc")
    jwant = np.asarray(j_ref.ip2_conv_ref(jnp.asarray(frame), jnp.asarray(w_q.T.numpy()),
                                          jnp.asarray(bias if b is not None else
                                                      np.zeros(16, np.float32)),
                                          jconv, jparams))
    t_oracle = t_ref.ip2_conv_ref(f, w_q.T, b if b is not None else torch.zeros(16), conv,
                                  params).numpy()
    if readout == "float":
        np.testing.assert_allclose(t_oracle, jwant, atol=1e-5, rtol=0)
    else:
        assert _moved_rows(t_oracle, jwant) <= 2


@pytest.mark.parametrize("kernel,stride,h,w", [(8, 8, 32, 32), (8, 4, 32, 48), (16, 8, 48, 32),
                                               (24, 5, 34, 44), (32, 1, 40, 35)])
def test_extract_windows_equals_reference(kernel, stride, h, w):
    frame = np.random.default_rng(kernel * stride).uniform(size=(3, h, w)).astype(np.float32)
    got = t_proj.extract_windows(torch.from_numpy(frame), kernel, stride)
    want = j_proj.extract_windows(jnp.asarray(frame), kernel, stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        t_proj.extract_windows(torch.from_numpy(frame[0]), kernel, stride).numpy(),
        np.asarray(want)[0])


@pytest.mark.parametrize("kernel", [8, 16, 24, 32])
def test_extract_windows_at_stride_k_is_the_patch_tiling(kernel):
    frame = torch.rand((2, 96, 192), generator=torch.Generator().manual_seed(kernel))
    assert torch.equal(t_proj.extract_windows(frame, kernel, kernel),
                       t_proj.extract_patches(frame, kernel, kernel))


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_conv_spec_geometry_and_rejections():
    for kw in (dict(kernel=8, stride=4), dict(kernel=16, stride=3, n_channels=8),
               dict(kernel=32, stride=1, n_channels=4)):
        t, j = t_proj.ConvSpec(**kw), j_proj.ConvSpec(**kw)
        for h, w in ((32, 32), (64, 40), (1080, 1920)):
            try:
                want = j.out_grid(h, w)
            except ValueError as e:
                assert _error(lambda: t.out_grid(h, w)) == str(e)
            else:
                assert t.out_grid(h, w) == want
        ps, pj = t.patch_spec(), j.patch_spec()
        assert (ps.patch_h, ps.patch_w, ps.n_vectors, ps.pixels_per_patch) == \
            (pj.patch_h, pj.patch_w, pj.n_vectors, pj.pixels_per_patch)
    assert t_proj.ConvSpec(kernel=8, stride=4, n_channels=16).out_grid(32, 32) == (7, 7)
    for kw in (dict(stride=0), dict(stride=-2), dict(kernel=12), dict(kernel=40),
               dict(kernel=4)):
        assert _error(lambda: t_proj.ConvSpec(**kw)) == _error(lambda: j_proj.ConvSpec(**kw))
    assert _error(lambda: t_proj.ConvSpec(kernel=8, stride=5).out_grid(32, 32)) == \
        _error(lambda: j_proj.ConvSpec(kernel=8, stride=5).out_grid(32, 32))
    assert _error(lambda: t_proj.extract_windows(torch.zeros(32, 30), 8, 4)) == \
        _error(lambda: j_proj.extract_windows(jnp.zeros((32, 30)), 8, 4))
    assert _error(lambda: t_ops.ip2_conv(torch.zeros(32, 32), torch.zeros(16, 64),
                                         t_proj.ConvSpec(), codes=True)) == \
        _error(lambda: j_ops.ip2_conv(jnp.zeros((32, 32)), jnp.zeros((16, 64)),
                                      j_proj.ConvSpec(), codes=True, interpret=True))


def test_analog_project_frame_and_grid_shape():
    rng = np.random.default_rng(3)
    frame = rng.uniform(size=(2, 64, 48)).astype(np.float32)
    wts = (rng.normal(size=(24, 256)) * 3.0).astype(np.float32)
    tspec, jspec = t_proj.PatchSpec(16, 16, n_vectors=24), j_proj.PatchSpec(16, 16, n_vectors=24)
    got = t_proj.analog_project_frame(torch.from_numpy(frame), torch.from_numpy(wts), tspec)
    want = j_proj.analog_project_frame(jnp.asarray(frame), jnp.asarray(wts), jspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert t_proj.grid_shape(64, 48, tspec) == j_proj.grid_shape(64, 48, jspec) == (4, 3)


@pytest.mark.parametrize("readout", ["adc", "sign"])
@pytest.mark.parametrize("reprogram", [False, True])
def test_conv_frame_events_equal_reference(readout, reprogram):
    """Program-once and reprogram-per-frame weight banks, ADC and sign
    readouts; scalar and per-slot window counts; the meter's mW too."""
    for n_windows, n_px in ((32400.0, 2.0736e6), (128851.0, 2.0736e6), (225.0, 4096.0)):
        t = t_pw.conv_frame_events(n_px, 64, 16, n_windows, readout=readout, reprogram=reprogram)
        j = j_pw.conv_frame_events(n_px, 64, 16, n_windows, readout=readout, reprogram=reprogram)
        assert t._fields == j._fields and tuple(t) == tuple(j)
        assert t_pw.EnergyMeter().power_mw(t, 30.0) == j_pw.EnergyMeter().power_mw(j, 30.0)
    counts = np.array([0.0, 49.0, 225.0], np.float32)
    t = t_pw.conv_frame_events(4096.0, 256, 8, torch.from_numpy(counts), readout, reprogram)
    j = j_pw.conv_frame_events(4096.0, 256, 8, jnp.asarray(counts), readout, reprogram)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    with pytest.raises(ValueError, match="unknown readout"):
        t_pw.conv_frame_events(4096.0, 64, 16, 1.0, readout="float")


def test_conv_on_cpu_never_reaches_the_cuda_build(monkeypatch):
    from repro_torch.kernels import _build

    def refuse(name):
        raise AssertionError(f"CPU call tried to load the {name} kernel")

    monkeypatch.setattr(_build, "load", refuse)
    t_ops.reset_launches()
    frame = torch.rand((2, 32, 32), generator=torch.Generator().manual_seed(0))
    w = torch.randn((16, 64), generator=torch.Generator().manual_seed(1))
    conv = t_proj.ConvSpec(kernel=8, stride=4)
    for kw in ({}, {"adc": t_adc.ADCSpec(), "codes": True}, {"readout": "sign"}):
        t_ops.ip2_conv(frame, w, conv, **kw)
    assert all(n == 0 for n in t_ops.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="device"):
        t_ops.ip2_conv(frame.to("meta"), w.to("meta"), conv)
