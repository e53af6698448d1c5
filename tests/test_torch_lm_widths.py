"""Port parity for the LM families at their own widths (CPU, against the
reference).

The smoke configs cut every family to d_model 128, head_dim 32 and at most
4 heads; here each family keeps its published d_model, query and kv heads,
head_dim, d_ff / d_expert, top_k, capacity factor, window, logit softcap
and IP2 geometry, at one repeat of its block pattern (whisper-tiny runs
whole). Cuts, for the CPU's time and memory: the vocabulary to 1024 rows;
qwen3-moe's experts to 16 (top-8 at capacity factor 1.25, as published);
two sequences of 16 tokens; pixtral's IP2 frontend over one 64 x 64 image
(4 patches of 32 px, 400 vectors).

The reference's ``init_params`` weights are carried across leaf by leaf
(``carried_once``) and the same numpy batch runs through both packages:
the forward logits within 1e-5; prefill of 12 tokens and 4 decode steps
with the float32 cache within 1e-5 of the reference's and within 2e-4 of
the port's forward (where no token is dropped: the MoE at capacity 1.25
drops by batch); the MoE's dropped (token, expert) pairs at capacity 1.25
on inputs that bind it, and the layer's output within 2e-5 (measured
1.24e-5: eight experts' products summed).
``tests/test_torch_lm_widths_recurrent.py`` holds recurrentgemma and xlstm,
gradients included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro import models as JM
from repro.models import moe as j_moe
from repro_torch import configs as t_configs
from repro_torch import models as TM
from repro_torch.models import moe as t_moe
from test_torch_lm_decode import run_port, run_reference
from test_torch_lm_models import B, S, to_jax, to_torch
from test_torch_lm_models import _reference_dropped

ATOL = 1e-5
FWD_ATOL = 2e-4
MOE_ATOL = 2e-5   # the MoE layer's output at d 4096, top-8 (measured 1.24e-5)
HALF = 12
VOCAB = 1024
N_EXPERTS = 16
IMAGE_EDGE = 64


def width_pair(arch: str):
    """(reference cfg, port cfg) of ``arch`` at its own widths, one pattern
    repeat (whisper-tiny whole), the vocabulary cut to ``VOCAB``, qwen3-moe
    to ``N_EXPERTS`` experts; ``pixtral-12b-ip2`` is pixtral with the IP2
    frontend."""
    base = arch.removesuffix("-ip2")
    pair = []
    for mod in (j_configs, t_configs):
        c = mod.get_config(base)
        repl = {"vocab": VOCAB}
        if not c.is_encoder_decoder:
            repl["n_layers"] = len(c.block_pattern)
        if c.moe is not None:
            repl["moe"] = dataclasses.replace(c.moe, n_experts=N_EXPERTS)
        if arch.endswith("-ip2"):
            repl["vision_frontend"] = "ip2"
        pair.append(dataclasses.replace(c, **repl))
    return tuple(pair)


def width_batch(cfg, seed=0) -> dict:
    """numpy batch of ``B`` x ``S`` tokens and the arch's other inputs."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    if cfg.is_vlm:
        b["images_rgb"] = rng.uniform(size=(B, IMAGE_EDGE, IMAGE_EDGE, 3)).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["frames"] = rng.normal(size=(B, cfg.n_encoder_frames, cfg.d_model)).astype(np.float32)
    return b


def carried_once(jp):
    """The reference's weights as the port's CPU tensors, each reference
    leaf dropped from ``jp`` once it is copied (one model in memory, not
    two: qwen2.5-32b's layer is 2 GB)."""
    if isinstance(jp, (dict, list)):
        keys = list(jp) if isinstance(jp, dict) else range(len(jp))
        for k in keys:
            jp[k] = carried_once(jp[k])
        return jp
    return torch.from_numpy(np.array(jp))


def held_against_reference(arch):
    """Forward, prefill and decode of ``arch`` at its widths through both
    packages: (reference's, port's) logits, and the port's forward."""
    jc, tc = width_pair(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    batch = width_batch(jc)
    full, n_pre, jsteps = run_reference(jc, jp, batch, jnp.float32, half=HALF)
    tp = carried_once(jp)           # jp's leaves are the port's from here
    with torch.no_grad():
        tfull = TM.forward(tp, to_torch(batch), tc)[0].numpy()
    tsteps, _ = run_port(tc, tp, batch, torch.float32, n_pre, half=HALF)
    return {"jc": jc, "tc": tc, "tp": tp, "full": full, "tfull": tfull, "n_pre": n_pre,
            "jsteps": jsteps, "tsteps": tsteps}


ARCHS = ["llama3-8b", "pixtral-12b-ip2", "qwen2.5-32b", "qwen3-moe-235b-a22b", "whisper-tiny"]


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return held_against_reference(request.param)


def test_widths_are_the_published_ones(run):
    """The geometry the smoke configs cut: the query width differs from
    d_model for pixtral (32 x 128 against 5120) and qwen3-moe (64 x 128
    against 4096)."""
    jc, tc = run["jc"], run["tc"]
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    full = t_configs.get_config(tc.name)
    for f in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "local_window",
              "logit_softcap", "ip2_patch", "ip2_vectors", "qkv_bias"):
        assert getattr(tc, f) == getattr(full, f), f
    if tc.moe is not None:
        assert (tc.moe.top_k, tc.moe.d_expert, tc.moe.capacity_factor) == (
            full.moe.top_k, full.moe.d_expert, full.moe.capacity_factor)


def test_forward_matches_reference(run):
    assert run["tfull"].shape == run["full"].shape
    np.testing.assert_allclose(run["tfull"], run["full"], atol=ATOL, rtol=0)


def test_prefill_decode_match_reference_and_forward(run):
    """Prefill of ``HALF`` tokens, then decode to ``S``, float32 cache."""
    n_pre, tc = run["n_pre"], run["tc"]
    dropping = tc.moe is not None and tc.moe.capacity_factor < tc.moe.n_experts
    for i, (a, b) in enumerate(zip(run["tsteps"], run["jsteps"])):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=f"step {i}")
        if not dropping:
            np.testing.assert_allclose(a, run["tfull"][:, n_pre + HALF - 1 + i],
                                       atol=FWD_ATOL, rtol=0, err_msg=f"decode != forward {i}")


def test_moe_drops_reference_pairs_at_published_capacity():
    """qwen3-moe's MoE layer at capacity factor 1.25, top-8 of 16 experts,
    d 4096, d_expert 1536, on 32 tokens with a shared component (the
    router's preferred experts then overflow): the port drops the
    reference's (token, expert) pairs, and the layer's output agrees."""
    jc, tc = width_pair("qwen3-moe-235b-a22b")
    assert tc.moe.capacity_factor == 1.25 and tc.moe.top_k == 8
    jp = j_moe.init_moe(jax.random.PRNGKey(4), jc)
    g = np.random.default_rng(5)
    h = (g.normal(size=(B, S, jc.d_model)) + 2.0 * g.normal(size=(1, 1, jc.d_model))
         ).astype(np.float32)
    want_drop, want_ids = _reference_dropped(jp, jnp.asarray(h), jc)
    jo, jaux = j_moe.apply_moe(jp, jnp.asarray(h), jc)
    jo, jaux = np.asarray(jo), float(jaux)
    tp = carried_once(jp)
    _, _, ids = t_moe.route(tp, torch.from_numpy(h).reshape(-1, jc.d_model), tc)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    d = t_moe.dispatch(ids, tc.moe.n_experts, t_moe.capacity(tc, B * S))
    got_drop = sorted({(int(a), int(e)) for a, e, k in zip(
        d["tok_of"].numpy(), d["expert"].numpy(), d["keep"].numpy()) if not k})
    assert got_drop == want_drop and len(got_drop) > 0
    with torch.no_grad():
        to, taux = t_moe.apply_moe(tp, torch.from_numpy(h), tc)
    # the sum of 8 experts' d_expert-1536 products: measured 1.24e-5 off
    np.testing.assert_allclose(to.numpy(), jo, atol=MOE_ATOL, rtol=0)
    assert float(taux) == pytest.approx(jaux, abs=1e-7)
