"""Port parity for the LM's gradients: ``lm.loss_fn`` under
``torch.autograd`` against the reference's ``jax.grad`` for every arch of
``ARCH_IDS`` at its smoke config plus pixtral with the IP2 vision frontend
(its STE path included), on the reference's seed-0 weights and one numpy
batch.

Each leaf is held within 1e-4 of its own largest |g| (fp32 sum order
through the backward). A leaf whose gradient is 0 in exact arithmetic
holds only rounding noise in both packages: whisper's cross-attention key
bias (softmax is shift-invariant along the keys), ~6e-10 against a tree
whose largest |g| is ~1. A leaf whose largest |g| is below 1e-6 of the
tree's largest is therefore held against 1e-2 of the tree's largest, as
``tests/test_torch_train.py`` holds the ViT's ``bk``; every other leaf
gets its own scale. No leaf may lose its gradient (a cut graph) where the
reference's is non-zero.
"""

import jax
import numpy as np
import pytest
import torch

from repro import models as JM
from repro.checkpoint.manager import _flatten_with_paths
from repro_torch import models as TM
from repro_torch.convert import tree_flatten_with_paths, tree_unflatten
from test_torch_lm_models import ARCHS, carried, make_batch, smoke_pair, to_jax, to_torch

REL = 1e-4
ROUNDING = 1e-6   # leaves below this share of the tree's largest |g|
FLOOR = 1e-2      # ... are held against this share of it


def port_grads(tp, batch, tc):
    """(loss, [(path, grad)]) of the port's ``loss_fn`` by autograd."""
    paths = [p for p, _ in tree_flatten_with_paths(tp)]
    live = [x.detach().requires_grad_(True) for _, x in tree_flatten_with_paths(tp)]
    loss, _ = TM.loss_fn(tree_unflatten(tp, live), to_torch(batch), tc)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return float(loss.detach()), list(zip(paths, grads))


def hold_grads(got, want_tree, rel=REL):
    """Each leaf of ``got`` against the reference's gradient tree, within
    ``rel`` of its largest |g|; returns the worst share and the leaves held
    at the floor."""
    paths, leaves, _ = _flatten_with_paths(want_tree)
    want = {p: np.asarray(x) for p, x in zip(paths, leaves)}
    assert [p for p, _ in got] == paths
    top = max(float(np.abs(w).max()) for w in want.values())
    worst, floored = 0.0, []
    for path, g in got:
        w = want[path]
        scale = float(np.abs(w).max())
        assert g is not None or scale == 0.0, f"{path}: the port's graph lost this leaf"
        g = np.zeros_like(w) if g is None else g.numpy()
        if scale < ROUNDING * top:
            floored.append(path)
            scale = FLOOR * top
        share = float(np.abs(g - w).max()) / scale
        assert share <= rel, f"{path}: off by {share:.3g} of its largest |g| ({scale:.3g})"
        worst = max(worst, share)
    return worst, floored


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_match_jax_grad(arch):
    jc, tc = smoke_pair(arch)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    batch = make_batch(jc)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, b, jc)[0]))(
        jp, to_jax(batch))
    loss, got = port_grads(carried(jp), batch, tc)
    assert loss == pytest.approx(float(jloss), abs=1e-5)
    _, floored = hold_grads(got, jg)
    # only a zero-in-exact-arithmetic leaf may sit at rounding level
    assert all("['bk']" in p for p in floored), floored
    if arch.endswith("-ip2"):
        ip2 = [g for p, g in got if p.startswith("['ip2']")]
        assert ip2 and all(g is not None and torch.isfinite(g).all() for g in ip2)
        assert any(bool(g.abs().max() > 0) for g in ip2), "no gradient reached the frontend"
