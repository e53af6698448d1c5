"""Port parity: the kernels' plain PyTorch versions (what the ops wrappers
run on CPU tensors) against the JAX ops wrappers, whose Pallas kernels run
in interpret mode here.

* ``quant_matmul_pre``: bitwise (integer sums, one fixed epilogue order),
  also where the reference's int32 sum wraps modulo 2^32 (16-bit codes
  at the extremes, 24-bit int32 codes).
* ``ip2_project``: an fp32 sum may land on the other side of an ADC (or
  sign) boundary when XLA and PyTorch add in different orders, so codes
  may differ by exactly 1 LSB on a counted, bounded number of rows; float
  readouts carry that LSB, and otherwise agree to atol 1e-6.
* ``ip2_fused_embed``: equal to the port's own staged pair bitwise, and to
  the JAX fused kernel on every row whose codes agree; so at 10 bits too,
  where ``quant_matmul_pre`` takes int16 codes bitwise.
* ``ip2_project_sparse`` (the sparse and the ragged kernel): codes within
  1 LSB on counted rows; rows past a slot's count exactly zero.
* 10- and 16-bit codes at the serving projection's width: within 1 LSB of
  the Pallas kernel's on a bounded share of the codes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adc as j_adc
from repro.core import projection as j_proj
from repro.core.analog_nl import AnalogNLSpec as JNL
from repro.kernels import ops as j_ops
from repro_torch.core import adc as t_adc
from repro_torch.core import projection as t_proj
from repro_torch.core.analog_nl import AnalogNLSpec as TNL
from repro_torch.kernels import ops as t_ops

RNG = np.random.default_rng(1)
MAX_FLIP_ROWS = 2   # bound on rows with a 1-LSB difference, per call


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _operands(n_rows=24, n2=256, m=32, nl="none"):
    js = j_proj.PatchSpec(patch_h=16, patch_w=16, n_vectors=m, nl=JNL(kind=nl))
    ts = t_proj.PatchSpec(patch_h=16, patch_w=16, n_vectors=m, nl=TNL(kind=nl))
    x = RNG.uniform(size=(2, n_rows // 2, n2)).astype(np.float32)
    w = (RNG.normal(size=(m, n2)) * 6.4).astype(np.float32)
    bias = (RNG.normal(size=(m,)) * 0.05).astype(np.float32)
    return js, ts, x, w, bias


def _flip_rows(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert d.max() <= 1, f"code difference {d.max()} > 1 LSB"
    rows = d.reshape(-1, d.shape[-1]).max(-1) > 0
    assert rows.sum() <= MAX_FLIP_ROWS, f"{rows.sum()} rows moved by 1 LSB"
    return rows


@pytest.mark.parametrize("nl", ["none", "relu"])
def test_ip2_project_codes(nl):
    js, ts, x, w, _ = _operands(nl=nl)
    jc = np.asarray(j_ops.ip2_project(jnp.asarray(x), jnp.asarray(w), js,
                                      adc=j_adc.ADCSpec(), codes=True))
    tc = t_ops.ip2_project(_t(x), _t(w), ts, adc=t_adc.ADCSpec(), codes=True)
    assert tc.dtype == torch.int8 and tuple(tc.shape) == jc.shape
    _flip_rows(tc.numpy(), jc)


@pytest.mark.parametrize("bits", [10, 20])
def test_ip2_project_wide_codes(bits):
    """ADCs wider than 8 bits emit int16 / int32 codes. At 10 bits they
    follow the 1-LSB rule against JAX; at 20 bits an LSB is below the fp32
    sums' order noise, so they are held instead to the ADC applied to the
    port's own analog output (V_R = 0 and no bias: the no-ADC readout)."""
    js, ts, x, w, _ = _operands()
    tadc = t_adc.ADCSpec(bits=bits)
    tc = t_ops.ip2_project(_t(x), _t(w), ts, adc=tadc, codes=True)
    jc = np.asarray(j_ops.ip2_project(jnp.asarray(x), jnp.asarray(w), js,
                                      adc=j_adc.ADCSpec(bits=bits), codes=True))
    assert tc.dtype == tadc.code_dtype and tc.numpy().dtype == jc.dtype
    assert tuple(tc.shape) == jc.shape
    if bits == 10:
        _flip_rows(tc.numpy(), jc)
    v_out = t_ops.ip2_project(_t(x), _t(w), ts)
    np.testing.assert_array_equal(tc.numpy(), t_adc.encode(v_out, tadc).numpy())


# per-slot row counts of 4 slots of 10 rows: the packing of the ragged kernel
# must get each right (the plain version is what the card holds it against)
RAGGED_COUNTS = {
    "mixed": [0, 9, 3, 10],        # 0, a partial 8-row bank, a partial slot, full
    "mostly_one": [1, 1, 2, 1],    # the gated path's kind (governor cap at 1)
    "one_full": [0, 0, 10, 0],
    "clipped": [-2, 12, 3, 10],    # outside [0, k]: clipped by both wrappers
}


@pytest.mark.parametrize("pattern", sorted(RAGGED_COUNTS))
@pytest.mark.parametrize("bits", [8, 10])
def test_ip2_project_sparse_and_ragged(bits, pattern):
    """Kernels 1 and 2: the sparse gather (``row_counts=None``) and the
    ragged one with the counts of ``pattern``, against the reference
    wrapper (codes within 1 LSB on counted rows; rows past a count exactly
    zero in both); in the port the ragged result at full counts is bitwise
    the sparse one."""
    js, ts, _, w, _ = _operands()
    x = RNG.uniform(size=(4, 16, 256)).astype(np.float32)
    idx = np.stack([RNG.permutation(16)[:10] for _ in range(4)]).astype(np.int32)
    jadc, tadc = j_adc.ADCSpec(bits=bits), t_adc.ADCSpec(bits=bits)
    args_j = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx), js)
    args_t = (_t(x), _t(w), _t(idx), ts)
    jsp = np.asarray(j_ops.ip2_project_sparse(*args_j, adc=jadc, codes=True))
    tsp = t_ops.ip2_project_sparse(*args_t, adc=tadc, codes=True)
    assert tsp.dtype == tadc.code_dtype and tuple(tsp.shape) == jsp.shape
    _flip_rows(tsp.numpy(), jsp)
    gathered = np.take_along_axis(x, idx[..., None].astype(np.int64), axis=1)
    np.testing.assert_array_equal(
        tsp.numpy(), t_ops.ip2_project(_t(gathered), _t(w), ts, adc=tadc, codes=True).numpy())
    counts = np.array(RAGGED_COUNTS[pattern], np.int32)
    jrg = np.asarray(j_ops.ip2_project_sparse(*args_j, adc=jadc, codes=True,
                                              row_counts=jnp.asarray(counts)))
    trg = t_ops.ip2_project_sparse(*args_t, adc=tadc, codes=True, row_counts=_t(counts))
    _flip_rows(trg.numpy(), jrg)
    live = np.arange(10)[None, :] < np.clip(counts, 0, 10)[:, None]
    assert not trg.numpy()[~live].any() and not jrg[~live].any()
    np.testing.assert_array_equal(trg.numpy()[live], tsp.numpy()[live])
    full = t_ops.ip2_project_sparse(*args_t, adc=tadc, codes=True,
                                    row_counts=_t(np.full(4, 10, np.int32)))
    assert torch.equal(full, tsp)


@pytest.mark.parametrize("readout", ["dequant", "sign"])
def test_ip2_project_sparse_readouts(readout):
    js, ts, _, w, bias = _operands()
    x = RNG.uniform(size=(2, 16, 256)).astype(np.float32)
    idx = np.stack([RNG.permutation(16)[:5] for _ in range(2)]).astype(np.int32)
    kw_j, kw_t = {"bias": jnp.asarray(bias)}, {"bias": _t(bias)}
    if readout == "dequant":
        kw_j["adc"], kw_t["adc"] = j_adc.ADCSpec(), t_adc.ADCSpec()
    else:
        kw_j["readout"] = kw_t["readout"] = "sign"
    cnt = np.array([5, 2], np.int32)
    jo = np.asarray(j_ops.ip2_project_sparse(jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx),
                                             js, row_counts=jnp.asarray(cnt), **kw_j))
    to = t_ops.ip2_project_sparse(_t(x), _t(w), _t(idx), ts, row_counts=_t(cnt),
                                  **kw_t).numpy()
    assert to.dtype == jo.dtype and to.shape == jo.shape
    if readout == "sign":
        _flip_rows(to, jo)
    else:
        lsb = t_adc.ADCSpec().lsb
        codes = np.rint((to - jo) / lsb)
        np.testing.assert_allclose(to - codes * lsb, jo, atol=1e-6, rtol=0)
        _flip_rows(codes.astype(np.int64), np.zeros_like(codes, np.int64))
    assert not to[1, 2:].any()


def test_program_weights_as_weights():
    """Weights programmed once give the same projection as raw weights, and
    programming is idempotent."""
    _, ts, x, w, bias = _operands()
    prog = t_ops.program_weights(_t(w), ts)
    assert t_ops.program_weights(prog, ts) is prog
    for kw in ({"adc": t_adc.ADCSpec(), "codes": True}, {"bias": _t(bias)}):
        np.testing.assert_array_equal(
            t_ops.ip2_project(_t(x), prog, ts, **kw).numpy(),
            t_ops.ip2_project(_t(x), _t(w), ts, **kw).numpy())


@pytest.mark.parametrize("readout", ["dequant", "noadc", "sign"])
def test_ip2_project_float_and_sign_readouts(readout):
    js, ts, x, w, bias = _operands()
    kw_j = {"bias": jnp.asarray(bias)}
    kw_t = {"bias": _t(bias)}
    if readout == "dequant":
        kw_j["adc"], kw_t["adc"] = j_adc.ADCSpec(), t_adc.ADCSpec()
    if readout == "sign":
        kw_j["readout"] = kw_t["readout"] = "sign"
    jo = np.asarray(j_ops.ip2_project(jnp.asarray(x), jnp.asarray(w), js, **kw_j))
    to = t_ops.ip2_project(_t(x), _t(w), ts, **kw_t).numpy()
    assert to.dtype == jo.dtype and to.shape == jo.shape
    if readout == "sign":
        _flip_rows(to, jo)
    elif readout == "noadc":
        np.testing.assert_allclose(to, jo, atol=1e-6, rtol=0)
    else:
        lsb = t_adc.ADCSpec().lsb
        codes = np.rint((to - jo) / lsb)
        np.testing.assert_allclose(to - codes * lsb, jo, atol=1e-6, rtol=0)
        _flip_rows(codes.astype(np.int64), np.zeros_like(codes, np.int64))


def test_quant_matmul_pre_bitwise():
    a8 = RNG.integers(-128, 128, size=(3, 7, 48)).astype(np.int8)
    w = (RNG.normal(size=(48, 40)) * 0.1).astype(np.float32)
    jw8, jsw = j_ops.quantize_weights_int8(jnp.asarray(w))
    tw8, tsw = t_ops.quantize_weights_int8(_t(w))
    np.testing.assert_array_equal(tw8.numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    for s_a in (np.float32(2.0 / 255), RNG.uniform(0.001, 0.1, (3, 7)).astype(np.float32)):
        jy = np.asarray(j_ops.quant_matmul_pre(jnp.asarray(a8), jnp.asarray(s_a), jw8, jsw))
        ty = t_ops.quant_matmul_pre(_t(a8), _t(s_a), tw8, tsw).numpy()
        np.testing.assert_array_equal(ty, jy)
    # extreme operands at K 1000: the largest sums (|acc| up to 1000 * 128 *
    # 128), all -128 against all -127, and mixed signs at the extremes
    k = 1000
    a_ext = np.stack([np.full(k, -128), np.full(k, 127),
                      RNG.choice([-128, 127], size=k)]).astype(np.int8)
    w_ext = np.concatenate([np.full((k, 1), -127), np.full((k, 1), 127),
                            RNG.choice([-127, 127], size=(k, 6))], axis=1).astype(np.int8)
    s_a = RNG.uniform(0.001, 0.1, (3,)).astype(np.float32)
    s_w = RNG.uniform(0.001, 0.1, (8,)).astype(np.float32)
    jy = np.asarray(j_ops.quant_matmul_pre(jnp.asarray(a_ext), jnp.asarray(s_a),
                                           jnp.asarray(w_ext), jnp.asarray(s_w)))
    ty = t_ops.quant_matmul_pre(_t(a_ext), _t(s_a), _t(w_ext), _t(s_w)).numpy()
    np.testing.assert_array_equal(ty, jy)
    acc = a_ext.astype(np.int64) @ w_ext.astype(np.int64)
    assert acc[0, 0] == k * 128 * 127
    np.testing.assert_array_equal(
        ty, (acc.astype(np.float32) * s_a[:, None]) * s_w[None, :])


def test_ip2_fused_embed():
    js, ts, x, w, _ = _operands()
    n_patches = x.shape[1]
    idx = np.stack([RNG.permutation(n_patches)[:5] for _ in range(2)]).astype(np.int32)
    emb = (RNG.normal(size=(32, 24)) * 0.1).astype(np.float32)
    tw8, tsw = t_ops.quantize_weights_int8(_t(emb))
    jw8, jsw = jnp.asarray(tw8.numpy()), jnp.asarray(tsw.numpy())
    tadc = t_adc.ADCSpec()
    ty = t_ops.ip2_fused_embed(_t(x), _t(w), _t(idx), ts, tadc, tw8, tsw).numpy()
    # the port's staged pair, bitwise
    gathered = np.take_along_axis(x, idx[..., None].astype(np.int64), axis=1)
    codes = t_ops.ip2_project(_t(gathered), _t(w), ts, adc=tadc, codes=True)
    staged = t_ops.quant_matmul_pre(codes, torch.tensor(tadc.lsb, dtype=torch.float32),
                                    tw8, tsw).numpy()
    np.testing.assert_array_equal(ty, staged)
    # the JAX fused kernel, on rows whose codes agree
    jy = np.asarray(j_ops.ip2_fused_embed(jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx),
                                          js, j_adc.ADCSpec(), jw8, jsw))
    jcodes = np.asarray(j_ops.ip2_project(jnp.asarray(gathered), jnp.asarray(w), js,
                                          adc=j_adc.ADCSpec(), codes=True))
    same = ~_flip_rows(codes.numpy(), jcodes).reshape(idx.shape)
    np.testing.assert_array_equal(ty[same], jy[same])
    # ragged counts: rows at or past the count are zero
    cnt = np.array([2, 0], np.int32)
    tr = t_ops.ip2_fused_embed(_t(x), _t(w), _t(idx), ts, tadc, tw8, tsw,
                               row_counts=_t(cnt)).numpy()
    np.testing.assert_array_equal(tr[0, :2], ty[0, :2])
    assert not tr[0, 2:].any() and not tr[1].any()


def test_wide_codes_embed_10_bits():
    """A 10-bit ADC's int16 codes through the port's plain quant_matmul_pre
    (bitwise the JAX kernel, the extreme codes against the extreme weights
    included) and ip2_fused_embed (bitwise the port's staged pair, and the
    JAX fused kernel on rows whose codes agree)."""
    js, ts, x, w, _ = _operands()
    jadc, tadc = j_adc.ADCSpec(bits=10), t_adc.ADCSpec(bits=10)
    idx = np.stack([RNG.permutation(x.shape[1])[:5] for _ in range(2)]).astype(np.int32)
    emb = (RNG.normal(size=(32, 24)) * 0.1).astype(np.float32)
    tw8, tsw = t_ops.quantize_weights_int8(_t(emb))
    jw8, jsw = jnp.asarray(tw8.numpy()), jnp.asarray(tsw.numpy())
    gathered = np.take_along_axis(x, idx[..., None].astype(np.int64), axis=1)
    codes = t_ops.ip2_project(_t(gathered), _t(w), ts, adc=tadc, codes=True)
    assert codes.dtype == torch.int16
    ext = codes.clone()
    ext[0, 0], ext[0, 1] = -512, 511
    w_ext = tw8.clone()
    w_ext[:, 0], w_ext[:, 1] = -127, 127
    for c, w8 in ((codes, tw8), (ext, w_ext)):
        jy = np.asarray(j_ops.quant_matmul_pre(jnp.asarray(c.numpy()), jnp.float32(tadc.lsb),
                                               jnp.asarray(w8.numpy()), jsw))
        ty = t_ops.quant_matmul_pre(c, torch.tensor(tadc.lsb, dtype=torch.float32), w8, tsw)
        np.testing.assert_array_equal(ty.numpy(), jy)
    staged = t_ops.quant_matmul_pre(codes, torch.tensor(tadc.lsb, dtype=torch.float32),
                                    tw8, tsw).numpy()
    ty = t_ops.ip2_fused_embed(_t(x), _t(w), _t(idx), ts, tadc, tw8, tsw).numpy()
    np.testing.assert_array_equal(ty, staged)
    jy = np.asarray(j_ops.ip2_fused_embed(jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx),
                                          js, jadc, jw8, jsw))
    jcodes = np.asarray(j_ops.ip2_project(jnp.asarray(gathered), jnp.asarray(w), js,
                                          adc=jadc, codes=True))
    same = ~_flip_rows(codes.numpy(), jcodes).reshape(idx.shape)
    assert same.sum() > 0
    np.testing.assert_array_equal(ty[same], jy[same])


@pytest.mark.parametrize("bits,k,wraps", [(16, 600, True), (10, 600, False), (24, 300, True)],
                         ids=["16bit_K600_wraps", "10bit_K600", "24bit_int32"])
def test_quant_matmul_pre_wraps_like_the_reference(bits, k, wraps):
    """The reference sums the codes in int32, which wraps modulo 2^32 past
    its range: the plain version returns that wrapped sum, bitwise the JAX
    kernel's, for the int16 codes of a 16-bit ADC at the extremes (where
    the sum wraps), a 10-bit ADC at K 600 (where it does not) and the
    int32 codes of a 24-bit ADC."""
    half = 1 << (bits - 1)
    dt = np.int16 if bits <= 16 else np.int32
    a = RNG.integers(-half, half, size=(5, k)).astype(dt)
    a[0], a[1] = -half, half - 1
    a[2] = RNG.choice([-half, half - 1], size=k)
    w8 = RNG.integers(-127, 128, size=(k, 12)).astype(np.int8)
    w8[:, 0], w8[:, 1] = -127, 127
    s_a = RNG.uniform(0.001, 0.1, (5,)).astype(np.float32)
    s_w = RNG.uniform(0.001, 0.1, (12,)).astype(np.float32)
    exact = a.astype(np.int64) @ w8.astype(np.int64)
    assert bool((np.abs(exact) >= 2**31).any()) == wraps
    jy = np.asarray(j_ops.quant_matmul_pre(jnp.asarray(a), jnp.asarray(s_a), jnp.asarray(w8),
                                           jnp.asarray(s_w)))
    ty = t_ops.quant_matmul_pre(_t(a), _t(s_a), _t(w8), _t(s_w)).numpy()
    np.testing.assert_array_equal(ty, jy)
    wrapped = ((exact + 2**31) % 2**32 - 2**31).astype(np.float32)
    np.testing.assert_array_equal(ty, (wrapped * s_a[:, None]) * s_w[None, :])


# bound on the codes (of all codes, per call) a 1-LSB move may touch at the
# serving projection's width: an fp32 sum on an ADC rounding boundary
LSB_MOVES = {10: 0.0005, 16: 0.005}


@pytest.mark.parametrize("bits", [10, 16])
def test_wide_codes_lsb_distance(bits):
    """The plain projection's 10- and 16-bit codes against the JAX Pallas
    kernel (interpret mode) at the serving path's widths (32x32 patches, M
    192): no code further than 1 LSB, and the 1-LSB moves on a bounded
    share of the codes (an LSB of a 16-bit ADC is 2^-15 V, near the fp32
    sums' order noise, so moves are far more common than at 8 bits)."""
    js = j_proj.PatchSpec(32, 32, n_vectors=192)
    ts = t_proj.PatchSpec(32, 32, n_vectors=192)
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(128, 1024)).astype(np.float32)
    w = (rng.normal(size=(192, 1024)) * 12.8).astype(np.float32)
    jc = np.asarray(j_ops.ip2_project(jnp.asarray(x), jnp.asarray(w), js,
                                      adc=j_adc.ADCSpec(bits=bits), codes=True))
    tc = t_ops.ip2_project(_t(x), _t(w), ts, adc=t_adc.ADCSpec(bits=bits), codes=True)
    assert tc.dtype == torch.int16
    d = np.abs(tc.numpy().astype(np.int64) - jc.astype(np.int64))
    assert d.max() <= 1, f"{bits} bits: codes {d.max()} LSB apart"
    assert (d > 0).sum() <= LSB_MOVES[bits] * d.size, \
        f"{bits} bits: {(d > 0).sum()} codes of {d.size} moved, on {(d.max(-1) > 0).sum()} rows"
