"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with ``nvcc`` (the kernels are built at first
use); everywhere else they skip. Run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.
Tolerances: quant_matmul bitwise (int32 sums modulo 2^32, as the
reference's), at shapes that take each of its copy paths, at the largest
sums and on the int16 / int32 codes of 10-, 16-, 24- and 32-bit ADCs, also
where the sums wrap; ip2_project codes within 1 LSB on a bounded number of
rows (cuBLAS and the kernel sum fp32 in different orders), and at 10 and 16
bits within 1 LSB on a bounded share of the codes, kernel 4's too;
ip2_fused_embed bitwise equal to ip2_project -> quant_matmul (the same
projection tile and chain, the same embed sums) over cluster sizes 1 to 8
and beyond, odd D and K, banks that span slots and every count pattern,
and at 10 to 32 bits; the
sparse and ragged projections bitwise ip2_project on the gathered rows,
zero past the counts, and at awkward shapes and count patterns bitwise
ip2_fused_embed through the embed; delta_attention within 1e-5 of its
plain version (its sums run in another order), exact zeros past the
counts, at counts outside [0, S] and with a slot that has no valid key.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import adc as adc_mod
from repro_torch.core import projection as proj
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _operands(dev, n_slots=5, n_patches=16, k=4, n2=256, m=32, d=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    spec = proj.PatchSpec(16, 16, n_vectors=m)
    x = torch.rand((n_slots, n_patches, n2), generator=g)
    w = torch.randn((m, n2), generator=g) * 6.4
    idx = torch.stack([torch.randperm(n_patches, generator=g)[:k] for _ in range(n_slots)])
    w8, s_w = ops.quantize_weights_int8(torch.randn((m, d), generator=g) * 0.1)
    return spec, x.to(dev), w.to(dev), idx.to(torch.int32).to(dev), w8.to(dev), s_w.to(dev)


@pytest.mark.parametrize("readout", ["codes", "dequant", "noadc", "sign"])
def test_ip2_project_kernel_vs_plain(dev, readout):
    spec, x, w, _, _, _ = _operands(dev)
    adc = adc_mod.ADCSpec() if readout in ("codes", "dequant") else None
    bias = torch.linspace(-0.1, 0.1, 32, device=dev)
    flat = x.reshape(-1, x.shape[-1])
    params = ops.kernel_params_from_spec(spec, adc, readout == "codes",
                                         "sign" if readout == "sign" else "adc")
    w_t = ops._dac_weights(w, spec).T.contiguous()
    n0 = ops.LAUNCHES["ip2_project"]
    got = ops._ip2_project_cuda(flat.contiguous(), w_t, bias, params)
    assert ops.LAUNCHES["ip2_project"] == n0 + 1
    want = ref.ip2_project_ref(flat, w_t, bias, params)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if readout == "noadc":
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        return
    d = (got.double() - want.double()).abs()
    if readout == "dequant":
        d = d / adc.lsb
    assert d.max().item() <= 1 + 1e-4
    assert (d.amax(-1) > 0.5).sum().item() <= max(2, flat.shape[0] // 100)


@pytest.mark.parametrize("bits", [10, 20])
def test_ip2_project_wide_codes_kernel(dev, bits):
    """int16 / int32 code stores: the kernel's codes equal the plain ADC on
    the kernel's own analog output (V_R = 0 and no bias: the no-ADC
    readout) bit for bit, and stay within 1 LSB of the plain version at
    10 bits."""
    spec, x, w, _, _, _ = _operands(dev)
    adc = adc_mod.ADCSpec(bits=bits)
    got = ops.ip2_project(x, w, spec, adc=adc, codes=True)
    assert got.dtype == adc.code_dtype
    v_out = ops.ip2_project(x, w, spec)
    assert torch.equal(got, adc_mod.encode(v_out, adc))
    if bits == 10:
        flat = x.reshape(-1, x.shape[-1])
        w_t = ops._dac_weights(w, spec).T.contiguous()
        params = ops.kernel_params_from_spec(spec, adc, codes=True)
        bias = torch.zeros(w_t.shape[1], device=dev)
        want = ref.ip2_project_ref(flat, w_t, bias, params).reshape(got.shape)
        d = (got.int() - want.int()).abs()
        assert d.max().item() <= 1
        assert (d.reshape(-1, d.shape[-1]).amax(-1) > 0).sum().item() <= 2


def _qmm_cuda_once(a8, s_a, w8, s_w):
    n0 = ops.LAUNCHES["quant_matmul"]
    got = ops._quant_matmul_cuda(a8, s_a, w8, s_w)
    assert ops.LAUNCHES["quant_matmul"] == n0 + 1
    torch.cuda.synchronize()
    return got


# R off the 32-row tile and at the serving count; K off the 64-k stage and
# K = 30, 100, 250 on the byte and 4-byte copies; N = 1 and 100, 300 on the
# byte and 4-byte copies, off the 64-column tile
@pytest.mark.parametrize("n", [1, 100, 256, 300])
@pytest.mark.parametrize("k", [30, 100, 192, 250, 1000])
@pytest.mark.parametrize("r", [1, 37, 520, 1024])
def test_quant_matmul_kernel_bitwise(dev, r, k, n):
    g = torch.Generator().manual_seed(r * 7 + k * 3 + n)
    a8 = torch.randint(-128, 128, (r, k), generator=g, dtype=torch.int8).to(dev)
    w8 = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8).to(dev)
    s_a = (torch.rand(r, generator=g) * 0.01).to(dev)
    s_w = (torch.rand(n, generator=g) * 0.01).to(dev)
    got = _qmm_cuda_once(a8, s_a, w8, s_w)
    assert torch.equal(got, ref.quant_matmul_ref(a8, s_a, w8, s_w))


@pytest.mark.parametrize("a,w", [(-128, -127), (-128, 127), (127, 127)])
def test_quant_matmul_kernel_extreme_sums(dev, a, w):
    """The largest sums at K 1000 (|acc| = 1000 * 128 * 127), exact."""
    a8 = torch.full((40, 1000), a, dtype=torch.int8, device=dev)
    w8 = torch.full((1000, 72), w, dtype=torch.int8, device=dev)
    s_a, s_w = torch.ones(40, device=dev), torch.ones(72, device=dev)
    got = _qmm_cuda_once(a8, s_a, w8, s_w)
    assert torch.equal(got, ref.quant_matmul_ref(a8, s_a, w8, s_w))
    assert float(got[0, 0]) == 1000.0 * a * w


def test_quant_matmul_kernel_odd_offset(dev):
    """a8 a contiguous view one byte into its storage: the byte copies."""
    g = torch.Generator().manual_seed(2)
    buf = torch.randint(-128, 128, (37 * 192 + 1,), generator=g, dtype=torch.int8).to(dev)
    a8 = buf[1:].view(37, 192)
    assert a8.is_contiguous() and a8.data_ptr() % 2 == 1
    w8 = torch.randint(-127, 128, (192, 256), generator=g, dtype=torch.int8).to(dev)
    s_a = torch.rand(37, generator=g).to(dev)
    s_w = torch.rand(256, generator=g).to(dev)
    got = _qmm_cuda_once(a8, s_a, w8, s_w)
    assert torch.equal(got, ref.quant_matmul_ref(a8, s_a, w8, s_w))


def test_fused_embed_equals_staged_kernels(dev):
    spec, x, w, idx, w8, s_w = _operands(dev)
    adc = adc_mod.ADCSpec()
    fused = ops.ip2_fused_embed(x, w, idx, spec, adc, w8, s_w)
    gathered = torch.gather(x, 1, idx.long()[..., None].expand(*idx.shape, x.shape[-1]))
    codes = ops.ip2_project(gathered, w, spec, adc=adc, codes=True)
    staged = ops.quant_matmul_pre(codes, adc.lsb, w8, s_w)
    torch.cuda.synchronize()
    assert torch.equal(fused, staged)
    cnt = torch.tensor([4, 2, 0, 1, 3], dtype=torch.int32, device=dev)
    ragged = ops.ip2_fused_embed(x, w, idx, spec, adc, w8, s_w, row_counts=cnt)
    live = torch.arange(4, device=dev)[None, :] < cnt[:, None]
    assert torch.equal(ragged[live], fused[live])
    assert not ragged[~live].any()


@pytest.mark.parametrize("bits", [8, 10])
def test_ip2_sparse_and_ragged_kernels(dev, bits):
    """Kernel 1 (the sparse gather) is bitwise ip2_project's kernel on the
    gathered rows and within 1 LSB of the plain version; kernel 2 with
    counts 0, partial and full per slot is bitwise kernel 1 below the
    count and exactly zero past it."""
    spec, x, w, _, _, _ = _operands(dev)
    g = torch.Generator().manual_seed(3)
    k = 10
    idx = torch.stack([torch.randperm(16, generator=g)[:k] for _ in range(5)])
    idx = idx.to(torch.int32).to(dev)
    adc = adc_mod.ADCSpec(bits=bits)
    n0 = dict(ops.LAUNCHES)
    sparse = ops.ip2_project_sparse(x, w, idx, spec, adc=adc, codes=True)
    assert ops.LAUNCHES["ip2_project_sparse"] == n0["ip2_project_sparse"] + 1
    gathered = torch.gather(x, 1, idx.long()[..., None].expand(*idx.shape, x.shape[-1]))
    assert sparse.dtype == adc.code_dtype
    assert torch.equal(sparse, ops.ip2_project(gathered, w, spec, adc=adc, codes=True))
    w_t = ops._dac_weights(w, spec).T.contiguous()
    params = ops.kernel_params_from_spec(spec, adc, codes=True)
    table, _ = ops._ragged_tables(idx, x.shape[1], None)
    plain = ref.ip2_project_sparse_ref(table, None, x.reshape(-1, x.shape[-1]), w_t,
                                       torch.zeros(w_t.shape[1], device=dev), params, k)
    d = (sparse.reshape(plain.shape).int() - plain.int()).abs()
    assert d.max().item() <= 1 and (d.amax(-1) > 0).sum().item() <= 2
    cnt = torch.tensor([0, 3, 10, 9, 1], dtype=torch.int32, device=dev)
    ragged = ops.ip2_project_sparse(x, w, idx, spec, adc=adc, codes=True, row_counts=cnt)
    assert ops.LAUNCHES["ip2_ragged"] == n0["ip2_ragged"] + 1
    torch.cuda.synchronize()
    live = torch.arange(k, device=dev)[None, :] < cnt[:, None]
    assert torch.equal(ragged[live], sparse[live])
    assert not ragged[~live].any()


# Awkward shapes for the pipelined tiles: 65 slots x 8 rows = 520 rows (off
# the 48- and 16-row tiles), M = 100 (off the 32-column tile), K = 1000 (off
# the 32-k step); K = 250, M = 30 take the 4-byte copies.
ODD_SHAPES = [(1000, 100), (250, 30)]
ODD_SLOTS, ODD_ROWS, ODD_PATCHES = 65, 8, 16
COUNT_PATTERNS = {
    "zero": [0] * ODD_SLOTS,
    "full": [ODD_ROWS] * ODD_SLOTS,
    "one_full": [0] * 32 + [ODD_ROWS] + [0] * 32,
    # the gated path's kind: most slots at 1 stale row (the governor's cap)
    "mostly_one": [2] * 5 + [3] * 3 + [1] * 12 + [0] + [1] * 19 + [0] + [1] * 24,
    # handed to the kernel unclipped: it clips to [0, k] itself
    "clipped": [(-3, ODD_ROWS + 4, 5, 0, ODD_ROWS, -1, 1)[i % 7] for i in range(ODD_SLOTS)],
}


def _odd_operands(dev, kk, mm):
    g = torch.Generator().manual_seed(kk)
    spec = proj.PatchSpec(32, 32, n_vectors=mm)
    x = torch.rand((ODD_SLOTS, ODD_PATCHES, kk), generator=g).to(dev)
    w = (torch.randn((mm, kk), generator=g) * 6.4).to(dev)
    idx = torch.stack([torch.randperm(ODD_PATCHES, generator=g)[:ODD_ROWS]
                       for _ in range(ODD_SLOTS)]).to(torch.int32).to(dev)
    w8, s_w = ops.quantize_weights_int8((torch.randn((mm, 40), generator=g) * 0.1).to(dev))
    return spec, x, w, idx, w8, s_w


@pytest.mark.parametrize("kk,mm", ODD_SHAPES)
def test_odd_shapes_project_equals_fused(dev, kk, mm):
    """ip2_project's codes through quant_matmul equal ip2_fused_embed bit
    for bit; the sparse kernel equals ip2_project."""
    spec, x, w, idx, w8, s_w = _odd_operands(dev, kk, mm)
    adc = adc_mod.ADCSpec()
    gathered = torch.gather(x, 1, idx.long()[..., None].expand(*idx.shape, kk))
    codes = ops.ip2_project(gathered, w, spec, adc=adc, codes=True)
    fused = ops.ip2_fused_embed(x, w, idx, spec, adc, w8, s_w)
    sparse = ops.ip2_project_sparse(x, w, idx, spec, adc=adc, codes=True)
    torch.cuda.synchronize()
    assert torch.equal(ops.quant_matmul_pre(codes, adc.lsb, w8, s_w), fused)
    assert torch.equal(sparse, codes)


@pytest.mark.parametrize("pattern", sorted(COUNT_PATTERNS))
@pytest.mark.parametrize("kk,mm", ODD_SHAPES)
def test_odd_shapes_ragged_equals_fused(dev, kk, mm, pattern):
    """The ragged kernel's codes through quant_matmul equal ip2_fused_embed
    with the same counts bit for bit, its live rows equal ip2_project's
    codes, and its rows past the counts are zero."""
    spec, x, w, idx, w8, s_w = _odd_operands(dev, kk, mm)
    adc = adc_mod.ADCSpec()
    cnt = torch.tensor(COUNT_PATTERNS[pattern], dtype=torch.int32, device=dev)
    table, _ = ops._ragged_tables(idx, ODD_PATCHES, None)
    w_t = ops._dac_weights(w, spec).T.contiguous()
    params = ops.kernel_params_from_spec(spec, adc, codes=True)
    n0 = ops.LAUNCHES["ip2_ragged"]
    ragged = ops._ip2_sparse_cuda(table, cnt, x.reshape(-1, kk), w_t,
                                  torch.zeros(mm, device=dev), params, ODD_ROWS)
    assert ops.LAUNCHES["ip2_ragged"] == n0 + 1
    ragged = ragged.reshape(ODD_SLOTS, ODD_ROWS, mm)
    fused = ops.ip2_fused_embed(x, w, idx, spec, adc, w8, s_w, row_counts=cnt)
    gathered = torch.gather(x, 1, idx.long()[..., None].expand(*idx.shape, kk))
    codes = ops.ip2_project(gathered, w, spec, adc=adc, codes=True)
    torch.cuda.synchronize()
    live = torch.arange(ODD_ROWS, device=dev)[None, :] < cnt.clamp(0, ODD_ROWS)[:, None]
    assert torch.equal(ops.quant_matmul_pre(ragged, adc.lsb, w8, s_w), fused)
    assert torch.equal(ragged[live], codes[live])
    assert not ragged[~live].any()


@pytest.mark.parametrize("readout", ["dequant", "noadc", "sign"])
def test_ip2_ragged_float_and_sign_readouts(dev, readout):
    spec, x, w, idx, _, _ = _operands(dev)
    kw = {"adc": adc_mod.ADCSpec()} if readout == "dequant" else (
        {"readout": "sign"} if readout == "sign" else {})
    bias = torch.linspace(-0.1, 0.1, 32, device=dev)
    cnt = torch.tensor([4, 2, 0, 1, 3], dtype=torch.int32, device=dev)
    ragged = ops.ip2_project_sparse(x, w, idx, spec, bias=bias, row_counts=cnt, **kw)
    sparse = ops.ip2_project_sparse(x, w, idx, spec, bias=bias, **kw)
    torch.cuda.synchronize()
    live = torch.arange(4, device=dev)[None, :] < cnt[:, None]
    assert torch.equal(ragged[live], sparse[live]) and not ragged[~live].any()


# dh 10 takes the 4-byte copies (rows that are not whole float4s)
@pytest.mark.parametrize("dh", [10, 16, 24, 64])
@pytest.mark.parametrize("s", [1, 13, 16, 40])
def test_delta_attention_kernel_vs_plain(dev, s, dh):
    """Counts 0, 1, partial, S, below 0 and above S; the last slot has no
    valid key (a uniform softmax over its -1e30 scores)."""
    g = torch.Generator().manual_seed(s * 100 + dh)
    b, h = 7, 4
    q, k, v = (torch.randn((b, s, h, dh), generator=g).to(dev) for _ in range(3))
    mask = torch.rand((b, s), generator=g) < 0.8
    mask[:, 0] = True
    mask[-1] = False
    mask = mask.to(dev)
    counts = torch.tensor([0, 1, max(s // 2, 1), s, -2, s + 5, s], dtype=torch.int32,
                          device=dev)
    n0 = ops.LAUNCHES["delta_attention"]
    got = ops._delta_attention_cuda(q, k, v, mask, counts)
    assert ops.LAUNCHES["delta_attention"] == n0 + 1
    want = ref.delta_attention_ref(q, k, v, mask, counts)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    live = torch.arange(s, device=dev)[None, :] < counts.clamp(0, s)[:, None]
    assert not got[~live].any()
    assert got[-1].abs().sum() > 0


def test_delta_attention_kernel_rejects_large_shape(dev):
    """A shape whose keys and values do not fit a block's shared memory
    raises, naming the shape, and counts no launch."""
    q = torch.zeros((2, 1000, 1, 64), device=dev)
    mask = torch.ones((2, 1000), dtype=torch.bool, device=dev)
    counts = torch.ones(2, dtype=torch.int32, device=dev)
    n0 = ops.LAUNCHES["delta_attention"]
    with pytest.raises(RuntimeError, match=r"\(2, 1000, 1, 64\)"):
        ops._delta_attention_cuda(q, q, q, mask, counts)
    assert ops.LAUNCHES["delta_attention"] == n0


def _bitwise(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _fused_once(x, w, idx, spec, adc, w8, s_w, counts=None):
    n0 = ops.LAUNCHES["ip2_fused_embed"]
    got = ops.ip2_fused_embed(x, w, idx, spec, adc, w8, s_w, row_counts=counts)
    assert ops.LAUNCHES["ip2_fused_embed"] == n0 + 1
    return got


def _staged(x, w, idx, spec, adc, w8, s_w, counts=None):
    """ip2_project -> quant_matmul on the gathered rows, rows past the
    counts set to +0.0: what the fused kernel must give bit for bit."""
    gathered = torch.gather(x, 1, idx.long()[..., None].expand(*idx.shape, x.shape[-1]))
    codes = ops.ip2_project(gathered, w, spec, adc=adc, codes=True)
    y = ops.quant_matmul_pre(codes, adc.lsb, w8, s_w)
    if counts is None:
        return y, codes
    live = torch.arange(idx.shape[1], device=x.device)[None, :] < counts.clamp(
        0, idx.shape[1])[:, None]
    return torch.where(live[..., None], y, torch.zeros((), device=x.device)), codes


FUSED_SLOTS, FUSED_PATCHES = 7, 20
FUSED_PATTERNS = {
    "zero": lambda k: [0] * FUSED_SLOTS,
    "full": lambda k: [k] * FUSED_SLOTS,
    "one_full": lambda k: [0, 0, 0, k, 0, 0, 0],
    # handed to the kernel unclipped: it clips to [0, k] itself
    "clipped": lambda k: [-3, k + 4, 5, 0, k, -1, 1],
}


# M 30 .. 256: clusters of 1, 4, 6 and 8 blocks; M 300 and 1000: 8 blocks
# that take 2 and 4 column slices each. D 40 and 300 are off the 64-column
# embed tile (40: the 4-byte w8 copies; 300: 5 tiles, 4-byte copies), K 250
# and 1000 off the 32-k step (250: the 4-byte patch copies). k 8, 13, 16
# over 7 slots put the 48-row banks across slot boundaries at odd places.
@pytest.mark.parametrize("kk", [250, 1000, 1024])
@pytest.mark.parametrize("d", [40, 256, 300])
@pytest.mark.parametrize("m", [30, 100, 192, 256, 300, 1000])
def test_fused_embed_kernel_grid(dev, m, d, kk):
    """ip2_fused_embed equals ip2_project -> quant_matmul bit for bit at
    k 8, 13, 16 under every count pattern (rows past the counts +0.0)."""
    g = torch.Generator().manual_seed(m * 31 + d * 7 + kk)
    spec = proj.PatchSpec(32, 32, n_vectors=m)
    x = torch.rand((FUSED_SLOTS, FUSED_PATCHES, kk), generator=g).to(dev)
    w = (torch.randn((m, kk), generator=g) * 6.4).to(dev)
    w8, s_w = ops.quantize_weights_int8((torch.randn((m, d), generator=g) * 0.1).to(dev))
    adc = adc_mod.ADCSpec()
    for k in (8, 13, 16):
        idx = torch.stack([torch.randperm(FUSED_PATCHES, generator=g)[:k]
                           for _ in range(FUSED_SLOTS)]).to(torch.int32).to(dev)
        full, _ = _staged(x, w, idx, spec, adc, w8, s_w)
        assert _bitwise(_fused_once(x, w, idx, spec, adc, w8, s_w), full), f"k {k} no counts"
        for name, pattern in FUSED_PATTERNS.items():
            cnt = torch.tensor(pattern(k), dtype=torch.int32, device=dev)
            want, _ = _staged(x, w, idx, spec, adc, w8, s_w, cnt)
            got = _fused_once(x, w, idx, spec, adc, w8, s_w, cnt)
            torch.cuda.synchronize()
            assert _bitwise(got, want), f"k {k} {name}"


# (R, K, N) per code width: the serving shape, K off the 64-k stage, and
# K past the old int16 bound (511) where the int32 sums wrap at the extremes
WIDE_SHAPES = {
    10: ((1024, 192, 256), (37, 600, 100), (5, 7, 3)),
    16: ((1024, 192, 256), (33, 512, 72), (37, 1000, 100), (5, 7, 3)),
    24: ((1024, 192, 256), (33, 600, 72), (5, 7, 3)),
    32: ((1024, 192, 256), (33, 250, 72), (5, 7, 3)),
}


@pytest.mark.parametrize("bits", [10, 16, 24, 32])
def test_quant_matmul_kernel_wide_codes(dev, bits):
    """int16 / int32 codes of a 10-, 16-, 24- or 32-bit ADC: bitwise the
    plain version, the extreme codes against the extreme weights included,
    also where the int32 sums wrap (the reference's sums wrap there too)."""
    half = 1 << (bits - 1)
    g = torch.Generator().manual_seed(bits)
    dt = torch.int16 if bits <= 16 else torch.int32
    wrapped = False
    for r, k, n in WIDE_SHAPES[bits]:
        a = torch.randint(-half, half, (r, k), generator=g, dtype=torch.int64).to(dt)
        a[0], a[1] = -half, half - 1
        w8 = torch.randint(-128, 128, (k, n), generator=g, dtype=torch.int8)
        w8[:, 0], w8[:, 1] = -128, 127
        exact = a[:2].double() @ w8.double()
        wrapped |= bool((exact.abs() >= 2**31).any())
        s_a, s_w = torch.rand(r, generator=g) * 0.01, torch.rand(n, generator=g) * 0.01
        a, w8, s_a, s_w = a.to(dev), w8.to(dev), s_a.to(dev), s_w.to(dev)
        got = _qmm_cuda_once(a, s_a, w8, s_w)
        assert _bitwise(got, ref.quant_matmul_ref(a, s_a, w8, s_w)), (r, k, n)
        assert torch.equal(ops.quant_matmul_pre(a, s_a, w8, s_w), got)
    assert wrapped == (bits > 10)


def _fused_vs_staged_and_plain(dev, bits, m, scales=(1.0, 40.0)):
    """ip2_fused_embed at ``bits`` and M ``m`` under ragged counts: bitwise
    the staged kernels and the plain version on rows whose codes agree;
    large weights drive many codes to both ends of the ADC."""
    spec, x, w, idx, w8, s_w = _operands(dev, m=m, d=256)
    adc = adc_mod.ADCSpec(bits=bits)
    for scale in scales:
        cnt = torch.tensor([4, 2, 0, 9, 3], dtype=torch.int32, device=dev)
        got = _fused_once(x, w * scale, idx, spec, adc, w8, s_w, cnt)
        want, codes = _staged(x, w * scale, idx, spec, adc, w8, s_w, cnt)
        assert codes.dtype == adc.code_dtype
        assert _bitwise(got, want), f"scale {scale}"
        if scale > 1:  # both ends of the ADC: the codes of v_min and v_max
            ends = adc_mod.encode(torch.tensor([adc.v_min, adc.v_max], device=dev), adc)
            assert int((codes == ends[0]).sum()) > 0 and int((codes == ends[1]).sum()) > 0
        w_t = ops._dac_weights(w * scale, spec).T.contiguous()
        table, cnt_c = ops._ragged_tables(idx, x.shape[1], cnt)
        params = ops.kernel_params_from_spec(spec, adc, codes=True)
        flat = x.reshape(-1, x.shape[-1])
        plain = ref.ip2_fused_embed_ref(table, cnt_c, flat, w_t, w8, s_w, params,
                                        idx.shape[1]).reshape(got.shape)
        plain_codes = ref.ip2_project_ref(flat[table.long()], w_t,
                                          torch.zeros(w_t.shape[1], device=dev), params)
        same = (plain_codes.reshape(codes.shape) == codes).all(-1)
        if bits == 10:  # wider LSBs near the fp32 sums' order noise: see below
            assert int((~same).sum()) <= 2
        assert _bitwise(got[same], plain[same])


@pytest.mark.parametrize("bits,m", [(10, 192), (10, 600), (16, 192), (16, 600), (24, 192),
                                    (32, 192), (32, 576)])
def test_fused_embed_kernel_wide_codes(dev, bits, m):
    """10- to 32-bit codes through ip2_fused_embed (int16 / int32 codes).
    M 600 is past the old int16 bound (511); M 576 is the largest M whose
    int32 code tile fits a block's shared memory in one chunk."""
    _fused_vs_staged_and_plain(dev, bits, m)


# M just past the largest one-chunk code tile of each code width (int8
# 2496, int16 1216, int32 576): 2 chunks; M 5000 with int8 codes: 3 chunks
@pytest.mark.parametrize("bits,m", [(8, 2560), (16, 1280), (32, 640), (8, 5000)])
def test_fused_embed_kernel_past_code_tile(dev, bits, m):
    """Kernel 4 walks M in chunks where the bank's code tile does not fit
    a block's shared memory, carrying its int32 sums: bitwise the staged
    kernels and the plain version on rows whose codes agree."""
    _fused_vs_staged_and_plain(dev, bits, m)


# bound on the codes a 1-LSB move may touch (of all codes of a call): an
# fp32 sum on an ADC rounding boundary, summed in another order by the
# kernel's tile and by cuBLAS
LSB_MOVES = {10: 0.001, 16: 0.01}


@pytest.mark.parametrize("bits", [10, 16])
def test_wide_codes_lsb_distance(dev, bits):
    """Kernel 4 (through its codes: fused embed of the identity) and kernel
    6 against the plain projection at the serving path's widths (1024
    rows of 32x32 patches, M 192): no code further than 1 LSB, and the
    1-LSB moves on a bounded share of the codes."""
    g = torch.Generator().manual_seed(bits)
    spec = proj.PatchSpec(32, 32, n_vectors=192)
    x = torch.rand((1024, 1024), generator=g).to(dev)
    w = (torch.randn((192, 1024), generator=g) * 12.8).to(dev)
    adc = adc_mod.ADCSpec(bits=bits)
    params = ops.kernel_params_from_spec(spec, adc, codes=True)
    w_t = ops._dac_weights(w, spec).T.contiguous()
    plain = ref.ip2_project_ref(x, w_t, torch.zeros(192, device=dev), params)
    k6 = ops.ip2_project(x, w, spec, adc=adc, codes=True)
    # kernel 4's codes: its embed of the 192 x 192 identity reproduces them
    eye = torch.eye(192, dtype=torch.int8, device=dev)
    rows = torch.arange(1024, device=dev, dtype=torch.int32)[None]
    k4 = ops.ip2_fused_embed(x[None], w, rows, spec, adc, eye, torch.ones(192, device=dev))
    k4 = torch.round(k4[0] / adc.lsb).to(torch.int64)
    for name, got in (("ip2_project", k6.to(torch.int64)), ("ip2_fused_embed", k4)):
        d = (got - plain.to(torch.int64)).abs()
        assert int(d.max()) <= 1, f"{name} {bits} bits: codes {int(d.max())} LSB apart"
        moved = int((d > 0).sum())
        assert moved <= LSB_MOVES[bits] * d.numel(), \
            f"{name} {bits} bits: {moved} codes moved, on {int((d.amax(-1) > 0).sum())} rows"


def test_embed_kernels_reject_wide_codes(dev):
    """What the embed kernels do not take raises, naming the shape and
    counting no launch: the fused kernel an ADC wider than 32 bits (no
    code dtype holds it); quant_matmul a code dtype that is not int8,
    int16 or int32. Codes of up to 32 bits at any K and any M are taken
    (see the wide-codes and past-code-tile tests)."""
    n0 = dict(ops.LAUNCHES)
    spec, x, w, idx, w8, s_w = _operands(dev)
    with pytest.raises(RuntimeError, match=r"\(20, 256, 32, 40\)"):
        ops.ip2_fused_embed(x, w, idx, spec, adc_mod.ADCSpec(bits=40), w8, s_w)
    with pytest.raises(ValueError, match="int8, int16 and int32"):
        ops.quant_matmul_pre(torch.zeros((20, 32), dtype=torch.int64, device=dev), 1.0,
                             w8, s_w)
    assert ops.LAUNCHES["ip2_fused_embed"] == n0["ip2_fused_embed"]
    assert ops.LAUNCHES["quant_matmul"] == n0["quant_matmul"]


@pytest.mark.parametrize("readout", ["float", "codes", "sign"])
@pytest.mark.parametrize("stride", [8, 4])
@pytest.mark.parametrize("size", ["small", "sensor"])
def test_ip2_conv_kernel_vs_plain(dev, size, stride, readout):
    """ops.ip2_conv launches kernel 6 over the conv windows (K 8, C 16) and
    holds to its plain route (``extract_windows`` + ``ref.ip2_project_ref``)
    on the same card: the float readout within 1e-5, codes and sign bits
    within 1 LSB on at most 1 % of rows, or 2 rows on the small frames' 192
    and 690 windows (as the other projection tests here). ``sensor`` is the
    2 Mpix 1080p frame of chip_smoke.py's conv phase (one frame here)."""
    h, w = (64, 96) if size == "small" else (1080, 1920)
    g = torch.Generator().manual_seed(stride)
    frame = torch.rand((1 if size == "sensor" else 2, h, w), generator=g).to(dev)
    wts = (torch.randn((16, 64), generator=g) * 3.0).to(dev)
    bias = (torch.randn((16,), generator=g) * 0.1).to(dev)
    conv = proj.ConvSpec(kernel=8, stride=stride, n_channels=16)
    adc = adc_mod.ADCSpec(bits=8)
    kw = {"float": {}, "codes": {"adc": adc, "codes": True, "bias": bias},
          "sign": {"readout": "sign"}}[readout]
    n0 = ops.LAUNCHES["ip2_project"]
    got = ops.ip2_conv(frame, wts, conv, **kw)
    assert ops.LAUNCHES["ip2_project"] == n0 + 1
    windows = proj.extract_windows(frame, 8, stride).reshape(-1, 64)
    params = ops.kernel_params_from_spec(conv.patch_spec(), kw.get("adc"),
                                         kw.get("codes", False), kw.get("readout", "adc"))
    b = bias if readout == "codes" else torch.zeros(16, device=dev)
    want = ref.ip2_project_ref(windows, ops._dac_weights(wts, conv.patch_spec()).T, b, params)
    gh, gw = conv.out_grid(h, w)
    assert got.shape == (frame.shape[0], gh * gw, 16)
    got = got.reshape(-1, 16)
    torch.cuda.synchronize()
    if readout == "float":
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        return
    if readout == "sign":
        assert got.dtype == torch.bool
        moved = int((got != want.bool()).any(-1).sum())
    else:
        assert got.dtype == torch.int8
        d = (got.int() - want.int()).abs()
        assert int(d.max()) <= 1
        moved = int((d.amax(-1) > 0).sum())
    assert moved <= max(2, got.shape[0] // 100), f"{moved} of {got.shape[0]} rows moved"
