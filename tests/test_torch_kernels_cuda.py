"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with ``nvcc`` (the kernels are built at first
use); everywhere else they skip. Run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.
Tolerances: quant_matmul bitwise (exact int32 sums), at shapes that take
each of its copy paths and at the largest sums; ip2_project codes within
1 LSB on a bounded number of rows (cuBLAS and the kernel sum fp32 in
different orders); ip2_fused_embed bitwise equal to ip2_project ->
quant_matmul; the sparse and ragged projections bitwise ip2_project on the
gathered rows (the same fmaf chain and epilogue), zero past the counts,
and at awkward shapes and count patterns bitwise ip2_fused_embed (the
older tile) through the embed; delta_attention within 1e-5 of its plain
version (its sums run in another order), exact zeros past the counts, at
counts outside [0, S] and with a slot that has no valid key.
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
    """ip2_project's codes through quant_matmul equal ip2_fused_embed, which
    keeps the older tile, bit for bit; the sparse kernel equals
    ip2_project."""
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


def test_embed_kernels_reject_wide_codes(dev):
    """The int8 embed kernels raise on codes wider than 8 bits rather than
    wrapping them."""
    spec, x, w, idx, w8, s_w = _operands(dev)
    adc = adc_mod.ADCSpec(bits=10)
    with pytest.raises(ValueError, match="8 bits"):
        ops.ip2_fused_embed(x, w, idx, spec, adc, w8, s_w)
    codes = ops.ip2_project(x, w, spec, adc=adc, codes=True)
    with pytest.raises(ValueError, match="int8"):
        ops.quant_matmul_pre(codes, adc.lsb, w8, s_w)
