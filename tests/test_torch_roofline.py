"""Port parity: the roofline cost model against the reference's.

The analytic costs price the same block arguments with the same
arithmetic, so ``flops``, ``bytes``, ``coll_bytes`` and ``detail`` are
equal exactly (pure Python floats, the same operations in the same order).
What differs is the card: the times and the bottleneck follow the H100's
constants, checked against the arithmetic written out here.
"""

import itertools

import pytest

from repro.roofline import analysis as ra
from repro_torch.roofline import analysis as ta


def _strip_bottleneck(detail):
    """``detail`` without the card-dependent ``bottleneck`` entries."""
    if isinstance(detail, dict):
        return {k: _strip_bottleneck(v) for k, v in detail.items() if k != "bottleneck"}
    if isinstance(detail, list):
        return [_strip_bottleneck(v) for v in detail]
    return detail


def _same_cost(got, want):
    assert set(got) == set(want)
    for key in ("flops", "bytes", "coll_bytes"):
        assert got[key] == want[key], key
    assert _strip_bottleneck(got["detail"]) == _strip_bottleneck(want["detail"])


COUNTS = {
    "zero": [0, 0, 0, 0],
    "partial": [1, 5, 8, 3],
    "full": [16, 16, 16, 16],
    "past_k": [40, -3, 17, 9],
}


@pytest.mark.parametrize("counts", COUNTS, ids=str)
@pytest.mark.parametrize("d", [None, 256])
@pytest.mark.parametrize("out_bytes", [1, 4])
@pytest.mark.parametrize("blocks", [{}, dict(block_r=16, block_m=64, block_k=128)],
                         ids=["default_blocks", "other_blocks"])
def test_megakernel_cost_matches_reference(counts, d, out_bytes, blocks):
    for k, n2, m in ((16, 1024, 192), (13, 768, 400), (16, 256, 32)):
        args = (COUNTS[counts], k, n2, m)
        _same_cost(ta.megakernel_cost(*args, d=d, out_bytes=out_bytes, **blocks),
                   ra.megakernel_cost(*args, d=d, out_bytes=out_bytes, **blocks))


@pytest.mark.parametrize("shape", [(16, 128, 4), (16, 768, 12), (13, 256, 4), (40, 64, 8)])
@pytest.mark.parametrize("block_q", [8, 16])
def test_delta_attention_cost_matches_reference(shape, block_q):
    k, d_model, heads = shape
    for j in list(range(k + 1)) + [k + 5, -2]:
        got = ta.delta_attention_cost(j, k, d_model, heads, block_q=block_q)
        want = ra.delta_attention_cost(j, k, d_model, heads, block_q=block_q)
        _same_cost(got, want)
        t = ta.RooflineTerms(got["flops"], got["bytes"], 0.0)
        assert got["time_s"] == max(got["flops"] / 67e12, got["bytes"] / 3.35e12)
        assert got["detail"]["bottleneck"] == t.bottleneck


@pytest.mark.parametrize("layers", [
    ([16, 8, 0, 3], [16, 4, 0, 16]),
    ([0, 0], [0, 0]),
    ([5.5, 2.0, 16.0], [3.0, 7.0, 16.0]),
])
def test_delta_backend_cost_matches_reference(layers):
    j_qkv, q_attn = layers
    for j_embed in (0.0, 3.0, 16.0):
        args = (j_embed, j_qkv, q_attn, 16, 192, 256, 4, 1024, 4)
        got, want = ta.delta_backend_cost(*args), ra.delta_backend_cost(*args)
        _same_cost(got, want)
        assert len(got["detail"]["layers"]) == len(j_qkv)
        assert got["time_s"] == max(got["flops"] / 67e12, got["bytes"] / 3.35e12)


@pytest.mark.parametrize("train", [True, False])
def test_model_flops_matches_reference(train):
    for n, tokens in ((86_616_208, 4096), (94_560, 512), (0, 7)):
        assert ta.model_flops(n, tokens, train) == ra.model_flops(n, tokens, train)


def test_extrapolate_matches_reference():
    p1 = {"flops": 1.5e12, "bytes": 3.0e9, "coll_bytes": 1.0e6}
    p2 = {"flops": 2.5e12, "bytes": 4.5e9, "coll_bytes": 3.0e6}
    for reps in itertools.product((1, 2), (2, 4), (12, 48)):
        got, want = ta.extrapolate(p1, p2, *reps), ra.extrapolate(p1, p2, *reps)
        for key in ("flops_per_chip", "bytes_per_chip", "coll_bytes_per_chip"):
            assert getattr(got, key) == getattr(want, key)


def test_roofline_terms_follow_the_h100():
    assert (ta.HBM_BW, ta.PEAK_FLOPS_FP32, ta.PEAK_OPS_INT8, ta.PEAK_FLOPS_BF16) == (
        3.35e12, 67e12, 1979e12, 989e12)
    assert ta.HBM_BYTES == 80 * 1024**3
    t = ta.RooflineTerms(67e12, 3.35e12 * 2, 450e9 * 0.5)
    assert (t.t_compute, t.t_memory, t.t_collective) == (1.0, 2.0, 0.5)
    assert t.bottleneck == "memory" and t.t_bound == 2.0 and t.mxu_occupancy == 0.5
    i8 = ta.RooflineTerms(1979e12, 0.0, 0.0, peak=ta.PEAK_OPS_INT8)
    assert i8.t_compute == 1.0 and i8.bottleneck == "compute" and i8.mxu_occupancy == 1.0
    assert set(t.as_dict()) == set(ra.RooflineTerms(1.0, 1.0, 1.0).as_dict())
    assert ta.RooflineTerms(0.0, 0.0, 0.0).mxu_occupancy == 0.0


def test_kernel_bound():
    """The bound column of the kernel table: bytes over HBM against the
    operations at their units' peaks, the fp32 and int8 times added."""
    assert ta.kernel_bound(3.35e12) == (1.0, "bytes")
    assert ta.kernel_bound(3.35e12, fp32_flops=134e12) == (2.0, "operations")
    assert ta.kernel_bound(0.0, fp32_flops=67e12, int8_ops=1979e12) == (2.0, "operations")
    n_bytes, fp32, i8 = 4.0e6, 2.0 * 1024 * 16 * 1024 * 192, 2.0 * 1024 * 192 * 256
    s, by = ta.kernel_bound(n_bytes, fp32_flops=fp32, int8_ops=i8)
    assert s == max(n_bytes / 3.35e12, fp32 / 67e12 + i8 / 1979e12)
    assert by == ("bytes" if n_bytes / 3.35e12 >= fp32 / 67e12 + i8 / 1979e12
                  else "operations")
