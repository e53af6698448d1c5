"""Port parity for recurrentgemma-2b and xlstm-1.3b at their own widths
(CPU, against the reference), gradients included.

As ``tests/test_torch_lm_widths.py`` (its cuts and helpers): one repeat
of each block pattern at the published widths, the vocabulary cut to
1024. recurrentgemma: d_model 2560, 10 query heads on one kv head of
width 256 (MQA), d_ff 7680 (GeGLU), a 2048-position local window and the
logit softcap 30, over (RG-LRU, RG-LRU, local attention). xlstm: d_model
2048, 4 heads of width 1024 over the inner width 4096, seven mLSTM blocks
and one sLSTM block.

Held: the forward logits, and prefill of 12 tokens and 4 decode steps
with the float32 cache, against the reference's within ``ATOL_OF``, and
decode within 2e-4 of the port's forward; ``loss_fn`` gradients by
``torch.autograd`` against ``jax.value_and_grad``, each leaf within
``GRAD_REL_OF`` of its own largest |g| (``tests/test_torch_lm_grads.py``'s
rule, 1e-4 there).

The tolerances are wider than the smoke tests' 1e-5 where measured so:
float32 sums over these widths (the mLSTM's 1024-wide heads, 4096-wide
inner products, exponential gates) round differently in XLA and in torch.
One mLSTM block at xlstm's width is 5.4e-6 off the reference's (of 2.6),
one sLSTM block 3.6e-6 (of 4.2); the 8 blocks' logits 7.0e-5 (of 4.2, and
decode 6.3e-5), while each package's own decode is within 1.4e-5 of its
forward. recurrentgemma's logits are 1.25e-5 off (of 4.6). The gradients:
recurrentgemma 5.2e-6 of a leaf's largest |g|; xlstm 2.36e-4 (the third
mLSTM block's ``wq``; eight leaves of the mLSTM blocks past 1.7e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as JM
from repro_torch import models as TM
from test_torch_lm_decode import run_port, run_reference
from test_torch_lm_grads import hold_grads, port_grads
from test_torch_lm_models import to_jax, to_torch
from test_torch_lm_widths import FWD_ATOL, HALF, carried_once, width_batch, width_pair

# measured (module docstring): recurrentgemma 1.25e-5, xlstm 7.0e-5 (logits);
# gradients 5.2e-6 and 2.36e-4 of a leaf's largest |g|
ATOL_OF = {"recurrentgemma-2b": 2e-5, "xlstm-1.3b": 1e-4}
GRAD_REL_OF = {"recurrentgemma-2b": 1e-4, "xlstm-1.3b": 5e-4}


@pytest.fixture(scope="module", params=["recurrentgemma-2b", "xlstm-1.3b"])
def run(request):
    """The reference's forward, prefill and decode logits and its loss and
    gradients (numpy), then the port's on the same weights."""
    jc, tc = width_pair(request.param)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    batch = width_batch(jc)
    full, n_pre, jsteps = run_reference(jc, jp, batch, jnp.float32, half=HALF)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, b, jc)[0]))(
        jp, to_jax(batch))
    jg = jax.tree.map(np.asarray, jg)
    tp = carried_once(jp)           # jp's leaves are the port's from here
    with torch.no_grad():
        tfull = TM.forward(tp, to_torch(batch), tc)[0].numpy()
    tsteps, _ = run_port(tc, tp, batch, torch.float32, n_pre, half=HALF)
    return {"arch": request.param, "tc": tc, "tp": tp, "batch": batch, "full": full,
            "tfull": tfull, "n_pre": n_pre, "jsteps": jsteps, "tsteps": tsteps,
            "jloss": float(jloss), "jg": jg}


def test_forward_matches_reference(run):
    assert run["tfull"].shape == run["full"].shape
    np.testing.assert_allclose(run["tfull"], run["full"], atol=ATOL_OF[run["arch"]], rtol=0)


def test_prefill_decode_match_reference_and_forward(run):
    n_pre = run["n_pre"]
    for i, (a, b) in enumerate(zip(run["tsteps"], run["jsteps"])):
        np.testing.assert_allclose(a, b, atol=ATOL_OF[run["arch"]], rtol=0, err_msg=f"step {i}")
        np.testing.assert_allclose(a, run["tfull"][:, n_pre + HALF - 1 + i],
                                   atol=FWD_ATOL, rtol=0, err_msg=f"decode != forward {i}")


def test_loss_grads_match_jax_grad(run):
    loss, got = port_grads(run["tp"], run["batch"], run["tc"])
    assert loss == pytest.approx(run["jloss"], abs=1e-5)
    worst, floored = hold_grads(got, run["jg"], rel=GRAD_REL_OF[run["arch"]])
    print(run["arch"], "worst share of a leaf's largest |g|:", worst, "floored:", floored)
    assert not floored, floored
