"""Port parity for LM serving with a float32 cache: prefill, then token by
token decode, for every arch of ``ARCH_IDS`` at its smoke config plus
pixtral with the IP2 vision frontend.

The reference's seed-0 weights run in both packages on the same tokens:
the prefill logits and every ``decode_step``'s logits within 1e-5 of the
reference's (float32 cache), and within the reference's own 2e-4 of the
full ``forward`` (decode == forward, ``tests/test_models.py:70``). Also: the
rolling local window past its length, the serve steps (greedy argmax, and
sampling under a seeded ``torch.Generator``), and no host read in a
decode step (a ``TorchDispatchMode`` trace shows no
``aten._local_scalar_dense``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import models as JM
from repro.configs import smoke_config as j_smoke
from repro.serve import serve_step as j_ss
from repro_torch import models as TM
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.serve import serve_step as t_ss
from test_torch_lm_models import ARCHS, B, S, carried, make_batch, smoke_pair, to_jax, to_torch

ATOL = 1e-5
FWD_ATOL = 2e-4
HALF = 8


def run_reference(jc, jp, batch, cache_dtype, s=S, half=HALF, full=None):
    """JAX: forward logits (unless given as ``full``), prefill logits and
    each decode step's logits."""
    if full is None:
        full = np.asarray(jax.jit(lambda p, b: JM.forward(p, b, jc))(jp, to_jax(batch))[0])
    n_pre = full.shape[1] - s
    st = JM.init_decode_state(jc, JM.DEFAULT_PLAN, B, n_pre + s, cache_dtype=cache_dtype)
    pre = dict(batch, tokens=batch["tokens"][:, :half])
    lg, st = jax.jit(lambda p, b, x: JM.prefill(p, b, jc, JM.DEFAULT_PLAN, x))(
        jp, to_jax(pre), st)
    steps = [np.asarray(lg)]
    dec = jax.jit(lambda p, x, t, pos: JM.decode_step(p, x, t, pos, jc))
    for t in range(half, s):
        lg, st = dec(jp, st, jnp.asarray(batch["tokens"][:, t]), jnp.int32(n_pre + t))
        steps.append(np.asarray(lg))
    return full, n_pre, steps


def run_port(tc, tp, batch, cache_dtype, n_pre, s=S, half=HALF):
    """The port: prefill logits, each decode step's logits, final state."""
    st = TM.init_decode_state(tc, TM.DEFAULT_PLAN, B, n_pre + s, cache_dtype=cache_dtype,
                              device="cpu")
    pre = dict(batch, tokens=batch["tokens"][:, :half])
    with torch.no_grad():
        lg, st = TM.prefill(tp, to_torch(pre), tc, TM.DEFAULT_PLAN, st)
        steps = [lg.numpy()]
        for t in range(half, s):
            lg, st = TM.decode_step(tp, st, torch.from_numpy(batch["tokens"][:, t]),
                                    torch.tensor(n_pre + t, dtype=torch.int32), tc)
            steps.append(lg.numpy())
    return steps, st


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference_and_forward(arch):
    jc, tc = smoke_pair(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    batch = make_batch(jc)
    full, n_pre, jsteps = run_reference(jc, jp, batch, jnp.float32)
    tsteps, st = run_port(tc, carried(jp), batch, torch.float32, n_pre)
    for i, (a, b) in enumerate(zip(tsteps, jsteps)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(a, full[:, n_pre + HALF - 1 + i], atol=FWD_ATOL, rtol=0,
                                   err_msg=f"decode != forward at step {i}")


def test_local_window_rolls_past_its_length():
    """recurrentgemma at local_window 6: the rolling buffer wraps during
    prefill (10 tokens) and again in decode (to 20); against the reference
    at 1e-5 and against forward at 2e-4."""
    jc = dataclasses.replace(j_smoke("recurrentgemma-2b"), local_window=6)
    tc = dataclasses.replace(t_smoke("recurrentgemma-2b"), local_window=6)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    batch = make_batch(jc, s=20)
    full, n_pre, jsteps = run_reference(jc, jp, batch, jnp.float32, s=20, half=10)
    tsteps, st = run_port(tc, carried(jp), batch, torch.float32, n_pre, s=20, half=10)
    assert st["stacks"][2]["k"].shape[2] == 6          # the window, not max_len
    for i, (a, b) in enumerate(zip(tsteps, jsteps)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(a, full[:, 9 + i], atol=FWD_ATOL, rtol=0)


def test_decode_state_tree_matches_reference():
    """init_decode_state: the reference's tree, shapes and dtypes for every
    block kind and cache dtype (bf16 conv states included)."""
    from repro.checkpoint.manager import _flatten_with_paths
    from repro_torch.convert import tree_flatten_with_paths

    for arch in ("recurrentgemma-2b", "xlstm-1.3b", "whisper-tiny", "kimi-k2-1t-a32b"):
        for jd, td in ((jnp.bfloat16, torch.bfloat16), (jnp.int8, torch.int8)):
            js = JM.init_decode_state(j_smoke(arch), JM.DEFAULT_PLAN, 3, 40, cache_dtype=jd)
            ts = TM.init_decode_state(t_smoke(arch), TM.DEFAULT_PLAN, 3, 40, cache_dtype=td,
                                      device="cpu")
            paths, leaves, _ = _flatten_with_paths(js)
            want = [(p, np.shape(x), np.asarray(x).dtype.name, np.asarray(x).tolist())
                    for p, x in zip(paths, leaves)]
            got = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."),
                    x.float().tolist() if x.dtype == torch.bfloat16 else x.tolist())
                   for p, x in tree_flatten_with_paths(ts)]
            assert got == want, (arch, td)


# ---- the serve steps -----------------------------------------------------------

@pytest.fixture(scope="module")
def smollm():
    jc, tc = smoke_pair("smollm-135m")
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, carried(jp)


def test_serve_steps_greedy_match_reference(smollm):
    """make_prefill_step / make_decode_step: the same logits, and the same
    greedy tokens, fed back for 6 steps."""
    jc, tc, jp, tp = smollm
    batch = make_batch(jc)
    jpre = jax.jit(j_ss.make_prefill_step(jc, JM.DEFAULT_PLAN))
    jdec = jax.jit(j_ss.make_decode_step(jc, JM.DEFAULT_PLAN))
    tpre = t_ss.make_prefill_step(tc, TM.DEFAULT_PLAN)
    tdec = t_ss.make_decode_step(tc, TM.DEFAULT_PLAN)
    js = JM.init_decode_state(jc, JM.DEFAULT_PLAN, B, S + 6, cache_dtype=jnp.float32)
    ts = TM.init_decode_state(tc, TM.DEFAULT_PLAN, B, S + 6, cache_dtype=torch.float32,
                              device="cpu")
    jl, js = jpre(jp, to_jax(batch), js)
    tl, ts = tpre(tp, to_torch(batch), ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    jn = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    tn = torch.argmax(tl, dim=-1).to(torch.int32)
    key = jax.random.PRNGKey(2)
    for i in range(6):
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jn, jl, js = jdec(jp, js, jn, jnp.int32(S + i), key)
        tn, tl, ts = tdec(tp, ts, tn, torch.tensor(S + i, dtype=torch.int32))
        assert tn.dtype == torch.int32 and tn.shape == (B,)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_greedy_takes_the_first_index_on_ties(smollm):
    _, tc, _, tp = smollm
    tdec = t_ss.make_decode_step(tc, TM.DEFAULT_PLAN)
    st = TM.init_decode_state(tc, TM.DEFAULT_PLAN, B, 4, cache_dtype=torch.float32,
                              device="cpu")
    flat = dict(tp, embed=torch.zeros_like(tp["embed"]))   # every logit 0
    nxt, logits, _ = tdec(flat, st, torch.zeros(B, dtype=torch.int32),
                          torch.tensor(0, dtype=torch.int32))
    assert torch.all(logits == 0)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnp.argmax(jnp.zeros((B, 4)), -1)))


def test_sampling_is_seeded_in_support_and_shaped(smollm):
    """temperature > 0 draws from softmax(logits / T) with the caller's
    generator: the same seed gives the same tokens, every token has nonzero
    probability, and a temperature near 0 gives the argmax."""
    _, tc, _, tp = smollm
    batch = to_torch(make_batch(tc))

    def sample(temp, seed, n=5):
        st = TM.init_decode_state(tc, TM.DEFAULT_PLAN, B, S + n, cache_dtype=torch.float32,
                                  device="cpu")
        lg, st = t_ss.make_prefill_step(tc, TM.DEFAULT_PLAN)(tp, batch, st)
        dec = t_ss.make_decode_step(tc, TM.DEFAULT_PLAN, temperature=temp)
        rng = torch.Generator().manual_seed(seed)
        nxt = torch.argmax(lg, -1).to(torch.int32)
        out = []
        for i in range(n):
            prev = nxt
            nxt, lg, st = dec(tp, st, prev, torch.tensor(S + i, dtype=torch.int32), rng)
            assert nxt.shape == (B,) and nxt.dtype == torch.int32
            probs = torch.softmax(lg / temp, -1)
            assert bool(torch.all(probs[torch.arange(B), nxt.long()] > 0))
            out.append((nxt.clone(), torch.argmax(lg, -1)))
        return out

    a, b, c = sample(1.0, 7), sample(1.0, 7), sample(1.0, 8)
    assert all(torch.equal(x[0], y[0]) for x, y in zip(a, b))
    assert any(not torch.equal(x[0], y[0]) for x, y in zip(a, c))
    for got, greedy in sample(1e-4, 3):
        assert torch.equal(got.long(), greedy)


# ---- no host read in a decode step --------------------------------------------

class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,cache", [
    ("smollm-135m", torch.int8), ("recurrentgemma-2b", torch.bfloat16),
    ("qwen3-moe-235b-a22b", torch.float32), ("whisper-tiny", torch.bfloat16),
    ("xlstm-1.3b", torch.bfloat16), ("pixtral-12b", torch.int8),
])
def test_decode_step_makes_no_host_read(arch, cache):
    """A traced decode step (and a greedy serve step) dispatches no
    ``aten._local_scalar_dense`` (``int()`` / ``bool()`` / ``.item()`` on a
    tensor: a host sync on the card) and no ``aten.lift_fresh``
    (``torch.tensor`` of a Python value: a host-to-device copy)."""
    tc = t_smoke(arch)
    tp = TM.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    batch = to_torch(make_batch(tc))
    n_pre = tc.n_image_tokens if tc.is_vlm else 0
    st = TM.init_decode_state(tc, TM.DEFAULT_PLAN, B, n_pre + S + 2, cache_dtype=cache,
                              device="cpu")
    with torch.no_grad():
        _, st = TM.prefill(tp, batch, tc, TM.DEFAULT_PLAN, st)
        tok = batch["tokens"][:, -1]
        pos = torch.tensor(n_pre + S, dtype=torch.int32)
        dec = t_ss.make_decode_step(tc, TM.DEFAULT_PLAN)
        with _Ops() as rec:
            _, st = TM.decode_step(tp, st, tok, pos, tc)
            dec(tp, st, tok, pos + 1)
    assert rec.names, "nothing was traced"
    bad = [n for n in rec.names if "_local_scalar_dense" in n or "lift_fresh" in n]
    assert not bad, bad
