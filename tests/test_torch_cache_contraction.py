"""``attention._contract_cache``, the bf16 / int8 KV cache contracted in
its storage dtype with float32 results, on each device's branch against
the float32 einsum of the same stored cache.

The CPU cases run everywhere; the ``cuda`` cases need an NVIDIA GPU and
skip elsewhere. On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cache_contraction.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.models import attention as t_attn

CACHES = {"bfloat16": torch.bfloat16, "int8": torch.int8}


def _contraction_device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cache contraction's cuBLAS branch)")
    return torch.device(name)


@pytest.mark.parametrize("spec", ["bngd,btnd->bngt", "bngt,btnd->bngd"])
@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_contract_cache_matches_float32_einsum(device, cache, spec):
    """``_contract_cache`` on each device's branch (the CPU's blocks of
    positions, the card's ``bmm`` per kv head with ``out_dtype``), for the
    scores and the values, against the float32 einsum of the same stored
    cache with ``a`` rounded to bf16: 3 kv heads of 3 grouped queries,
    1000 positions (not a multiple of ``CPU_CACHE_BLOCK``). The bf16
    products are exact in float32, so only the order of the float32 sums
    differs: 1e-5 of the result's largest |value|."""
    dev = _contraction_device(device)
    td = CACHES[cache]
    rng = np.random.default_rng(0)
    b, t, hkv, g, dh = 2, 1000, 3, 3, 64
    stored = torch.from_numpy(rng.integers(-127, 128, (b, t, hkv, dh)).astype(np.int8))
    if td == torch.bfloat16:
        stored = (stored.to(torch.float32) * 0.01).to(td)
    a_shape = (b, hkv, g, dh) if spec.endswith("bngt") else (b, hkv, g, t)
    a = torch.from_numpy(rng.normal(size=a_shape).astype(np.float32))
    want = torch.einsum(spec, a.to(torch.bfloat16).to(torch.float32),
                        stored.to(torch.float32))
    got = t_attn._contract_cache(spec, a.to(dev), stored.to(dev)).cpu()
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
