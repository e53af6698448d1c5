"""Port parity for LM serving with the bf16 and int8 KV caches: prefill and
token-by-token decode for every arch of ``ARCH_IDS`` at its smoke config
plus pixtral with the IP2 vision frontend, against the reference on the
same seed-0 weights and tokens.

Bound: 3e-3 on the logits, port against reference. Both packages round the
same keys and values to bf16 (or to int8 codes), but those come out of
float32 arithmetic that differs in its last bits, so now and then one
element rounds to the neighbouring bf16 value or int8 code; over these 33
runs the largest logit difference measured was 1.27e-3 (pixtral, int8).
Greedy tokens agree wherever the reference's top-2 gap exceeds twice the
bound. Against the full float32 ``forward`` the reference itself moves by
up to 1.5e-2 with the int8 cache (its own test allows ~1.5 %), so the
port is held there at 2e-2.

Both caches are contracted in their storage dtype with float32 results,
as the reference's ``preferred_element_type`` does: one decode layer over
a cache several contraction blocks long allocates no tensor as large as
a float32 copy of the cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro_torch.configs import smoke_config
from repro_torch.models import attention as t_attn
from test_torch_lm_decode import HALF, run_port, run_reference
from test_torch_lm_models import ARCHS, carried, make_batch, smoke_pair, to_jax

BOUND = 3e-3
FWD_BOUND = 2e-2
CACHES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    jc, tc = smoke_pair(request.param)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    batch = make_batch(jc)
    full = np.asarray(jax.jit(lambda p, b: JM.forward(p, b, jc))(jp, to_jax(batch))[0])
    return jc, tc, jp, carried(jp), batch, full


@pytest.mark.parametrize("cache", sorted(CACHES))
def test_quantised_cache_decode_matches_reference(weights, cache):
    jc, tc, jp, tp, batch, full = weights
    jd, td = CACHES[cache]
    full, n_pre, jsteps = run_reference(jc, jp, batch, jd, full=full)
    tsteps, st = run_port(tc, tp, batch, td, n_pre)
    for i, (a, b) in enumerate(zip(tsteps, jsteps)):
        np.testing.assert_allclose(a, b, atol=BOUND, rtol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(a, full[:, n_pre + HALF - 1 + i], atol=FWD_BOUND, rtol=0)
        top2 = np.sort(b, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * BOUND
        np.testing.assert_array_equal(a.argmax(-1)[clear], b.argmax(-1)[clear])
    for leaf in (st["stacks"] + st["tail"]):
        if isinstance(leaf, dict) and "k" in leaf:
            assert leaf["k"].dtype == td
            assert ("k_scale" in leaf) == (td == torch.int8)


@pytest.mark.parametrize("cache", sorted(CACHES))
def test_cache_contraction_makes_no_float32_copy(cache):
    """One decode layer at 4 CPU contraction blocks of positions, under the
    profiler's memory tracking: the largest single allocation stays below
    the float32 size of one cache (a float32 copy of the cache, as a cast
    before the einsum makes, would reach it). The layer's output matches
    the float32 contraction of the same stored cache within 3e-3."""
    td = CACHES[cache][1]
    cfg = smoke_config("smollm-135m")
    p = t_attn.init_attention(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    b, t = 2, 4 * t_attn.CPU_CACHE_BLOCK
    shape = (b, t, cfg.n_kv_heads, cfg.head_dim)
    k, v = (torch.from_numpy(rng.integers(-100, 100, shape).astype(np.int8)).to(td)
            for _ in range(2))
    scales = None
    if td == torch.int8:
        scales = {n: torch.from_numpy(rng.uniform(1e-3, 2e-2, shape[:3]).astype(np.float32))
                  for n in ("k", "v")}
    else:
        k, v = k * 0.01, v * 0.01
    x = torch.from_numpy(rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32))
    pos = torch.tensor(t - 7)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                profile_memory=True) as prof:
        out, *_ = t_attn.attention_decode(p, x, k, v, pos, cfg, cache_scales=scales)
    largest = max(e.self_cpu_memory_usage for e in prof.events())
    assert 0 < largest < k.numel() * 4, (largest, k.numel() * 4)
    # the same stored values contracted from float32 copies
    if td == torch.int8:
        k32, v32 = (c.to(torch.float32) * scales[n][..., None] for c, n in ((k, "k"), (v, "v")))
    else:
        k32, v32 = k.to(torch.float32), v.to(torch.float32)
    want, *_ = t_attn.attention_decode(p, x, k32, v32, pos, cfg)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=BOUND, rtol=0)
