"""The sLSTM's time scan as one operator, ``torch.ops.repro_torch.slstm_scan``
with its backward operator ``repro_torch::slstm_scan_backward`` (the port's
counterpart of the reference's ``lax.scan`` in ``slstm_forward``).

Held at small widths on the CPU:

* ``torch.library.opcheck`` on both ops (schema, fake implementation,
  autograd registration);
* the op's forward bitwise against its plain loop (``slstm_scan_ref``),
  from a zero and from a nonzero state, over a sequence and one position
  (decode);
* the op's gradients against ``torch.autograd`` of the plain loop within
  1e-5 of each leaf's largest |g| (measured 3.3e-7 at most over the cases
  below, the stabiliser's exact tie and the clamped normaliser included),
  and ``slstm_forward``'s against ``jax.grad`` of the reference's within
  1e-4 of each leaf's largest |g|, the bound of
  ``tests/test_torch_lm_grads.py`` (measured 5.7e-7 at most; the outputs
  7.2e-7 apart, bound 1e-5);
* the flop formulas, as ``FlopCounterMode`` counts them;
* the dry run's trace of an xLSTM step holds one scan op a direction per
  sLSTM layer, and as many ops at 64 positions as at 256.
"""

import dataclasses
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.models import xlstm as JX
from repro_torch.models import xlstm as TX

B, S, D, NH = 2, 9, 32, 4
DH = D // NH
REL_AUTOGRAD = 1e-5
REL_JAX = 1e-4


def _inputs(seed, b=B, s=S, state=True):
    """The op's inputs from numpy, float32: gx (B,S,4,NH,dh), r, and the
    state c, n, m, h (B,NH,dh), zero (m at -1e30) unless ``state``."""
    rng = np.random.default_rng(seed)
    gx = rng.standard_normal((b, s, 4, NH, DH)).astype(np.float32)
    r = (rng.standard_normal((4, NH, DH, DH)) / np.sqrt(DH)).astype(np.float32)
    if state:
        c = rng.standard_normal((b, NH, DH))
        n = rng.uniform(0.5, 2.0, (b, NH, DH))
        m = rng.standard_normal((b, NH, DH))
        h = rng.standard_normal((b, NH, DH)) * 0.5
    else:
        c, n, h = (np.zeros((b, NH, DH)) for _ in range(3))
        m = np.full((b, NH, DH), -1e30)
    return [torch.from_numpy(np.asarray(x, np.float32)) for x in (gx, r, c, n, m, h)]


def _tie_and_clamp_inputs():
    """One position from a zero h (so the gates are gx): at [0, 0, 0, 0]
    the stabiliser's two sides are equal (i = logsigmoid(f) + m, f = 0,
    m = 0); at [0, 1, 0, 0] the normaliser n lies below its clamp 1e-6
    (m far above i, n tiny)."""
    gx, r, c, n, m, h = _inputs(3, b=1, s=1)
    h.zero_()
    gx[0, 0, 2, 0, 0] = 0.0
    m[0, 0, 0] = 0.0
    gx[0, 0, 1, 0, 0] = torch.nn.functional.logsigmoid(torch.zeros(()))
    gx[0, 0, 1, 1, 0] = -30.0
    gx[0, 0, 2, 1, 0] = 5.0
    m[0, 1, 0] = 0.0
    n[0, 1, 0] = 1e-9
    return [gx, r, c, n, m, h]


def _held(got, want):
    """The worst leaf's largest difference as a share of its largest |g|; a
    leaf whose gradient is 0 (an initial state that the first position's
    weights multiply by 0) must be 0 in both."""
    worst = 0.0
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        if scale == 0.0:
            assert float(a.abs().max()) == 0.0
            continue
        worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def test_opcheck_forward_and_backward():
    gx, r, c, n, m, h = (x.requires_grad_(True) for x in _inputs(0))
    torch.library.opcheck(torch.ops.repro_torch.slstm_scan.default, (gx, r, c, n, m, h, True))
    # without save the op keeps nothing for a backward: checked without gradients
    torch.library.opcheck(torch.ops.repro_torch.slstm_scan.default,
                          (*(x.detach() for x in (gx, r, c, n, m, h)), False))
    outs = TX.slstm_scan_ref(*(x.detach() for x in (gx, r, c, n, m, h)))
    hs, cT, nT, mT, hT, pre, cs, ns, ms = outs
    g = torch.Generator().manual_seed(1)
    grads = [torch.randn(x.shape, generator=g) for x in (hs, cT, nT, mT, hT)]
    torch.library.opcheck(torch.ops.repro_torch.slstm_scan_backward.default,
                          (*grads, r.detach(), pre, cs, ns, ms, hs,
                           *(x.detach() for x in (c, n, m, h))))


@pytest.mark.parametrize("case", ["zero_state", "state", "decode"])
def test_forward_bitwise_plain_loop(case):
    """Every output of the op equals the plain loop's bit for bit, with and
    without the states it keeps for the backward."""
    args = _inputs(1, s=1 if case == "decode" else S, state=case != "zero_state")
    for save in (True, False):
        got = torch.ops.repro_torch.slstm_scan(*args, save)
        want = TX.slstm_scan_ref(*args, save)
        assert len(got) == len(want) == 9
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.equal(a, b)
    assert not got[5].numel()


def _loss_weights(seed, b, s):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, NH, DH), generator=g)] + [
        torch.randn((b, NH, DH), generator=g) for _ in range(4)]


@pytest.mark.parametrize("case", ["zero_state", "state", "decode", "tie_and_clamp"])
def test_gradients_match_autograd_of_plain_loop(case):
    """The backward op's gradients of gx, r and the initial state against
    ``torch.autograd`` through the plain loop, for a loss that weighs hs
    and every final state; at the stabiliser's tie both give each side
    half (``torch.maximum``, as ``jnp.maximum``), at the clamp none to n."""
    if case == "tie_and_clamp":
        args = _tie_and_clamp_inputs()
    else:
        args = _inputs(2, s=1 if case == "decode" else S, state=case != "zero_state")
    b, s = args[0].shape[:2]
    w = _loss_weights(4, b, s)

    def grads(fn):
        live = [x.detach().requires_grad_(True) for x in args]
        outs = fn(*live)[:5]
        loss = sum((o * wi).sum() for o, wi in zip(outs, w))
        return torch.autograd.grad(loss, live)

    got = grads(lambda *a: torch.ops.repro_torch.slstm_scan(*a, True))
    want = grads(lambda *a: TX.slstm_scan_ref(*a, False))
    share = _held(got, want)
    print(case, "worst share", share)
    assert share <= REL_AUTOGRAD, share
    if case == "tie_and_clamp":
        # the tie's half shares reach f's and i's gradients alike
        assert float(got[0][0, 0, 1, 0, 0]) != 0.0 and float(got[0][0, 0, 2, 0, 0]) != 0.0


def _slstm_params(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((D, 4 * D)) / np.sqrt(D)).astype(np.float32),
            "r": (rng.standard_normal((4, NH, DH, DH)) / np.sqrt(DH)).astype(np.float32),
            "b": (rng.standard_normal(4 * D) * 0.5).astype(np.float32),
            "gn": rng.uniform(0.5, 1.5, D).astype(np.float32),
            "w_down": (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)}


@pytest.mark.parametrize("state", [False, True])
def test_slstm_forward_gradients_match_jax(state):
    """``slstm_forward``'s gradients (weights, input, initial state) through
    the op against ``jax.grad`` of the reference's ``slstm_forward`` (its
    ``lax.scan``) on the same numpy weights, within 1e-4 of each leaf's
    largest |g|; its outputs within 1e-5."""
    p = _slstm_params(5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    st = None
    if state:
        st = {"c": rng.standard_normal((B, NH, DH)).astype(np.float32),
              "n": rng.uniform(0.5, 2.0, (B, NH, DH)).astype(np.float32),
              "m": rng.standard_normal((B, NH, DH)).astype(np.float32),
              "h": (rng.standard_normal((B, D)) * 0.5).astype(np.float32)}
    wo = rng.standard_normal((B, S, D)).astype(np.float32)
    ws = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in (st or {}).items()}

    def jloss(p, x, st):
        out, new = JX.slstm_forward(p, x, st)
        return jnp.sum(out * wo) + sum(jnp.sum(new[k] * ws[k]) for k in ws), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(p, x, st)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tst = None if st is None else {k: torch.from_numpy(v).requires_grad_(True)
                                   for k, v in st.items()}
    out, new = TX.slstm_forward(tp, tx, tst)
    loss = (out * torch.from_numpy(wo)).sum() + sum(
        (new[k] * torch.from_numpy(ws[k])).sum() for k in ws)
    leaves = [*tp.values(), tx, *(tst or {}).values()]
    got = torch.autograd.grad(loss, leaves)
    want = [*(jg[0][k] for k in tp), jg[1], *((jg[2][k] for k in tst) if tst else ())]
    share = _held(got, [torch.from_numpy(np.asarray(v)) for v in want])
    print("state" if state else "zero state", "worst share", share,
          "out", float(np.abs(out.detach().numpy() - np.asarray(jout)).max()))
    assert np.allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    assert share <= REL_JAX, share


def test_flop_formulas():
    """``FlopCounterMode`` counts the op by its formula: 2·B·S·4·NH·dh²
    forward, twice that backward."""
    args = [x.requires_grad_(True) for x in _inputs(7)]
    with FlopCounterMode(display=False) as fc:
        hs = torch.ops.repro_torch.slstm_scan(*args, True)[0]
        fwd = fc.get_total_flops()
        hs.sum().backward()
    want = 2 * B * S * 4 * NH * DH * DH
    assert fwd == want
    assert fc.get_total_flops() == 3 * want


# ---------------------------------------------------------------------------
# the dry run's trace does not grow with the sequence
# ---------------------------------------------------------------------------

TRACE_SECONDS = 300   # the eight traces below take ~15 s here


class _Alarm:
    def __init__(self, seconds):
        self.seconds = seconds

    def _fire(self, *_):
        raise TimeoutError(f"the traces ran past {self.seconds} s: a per-position trace?")

    def __enter__(self):
        self.old = signal.signal(signal.SIGALRM, self._fire)
        signal.alarm(self.seconds)

    def __exit__(self, *exc):
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self.old)
        return False


def _in(codes) -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code in codes:
            return True
        f = f.f_back
    return False


def _op_counts(kind, seq, mesh_shape):
    """Ops rank 0 records in a step of xlstm's smoke config cut to one
    sLSTM block at ``seq`` positions on fake CPU ranks of ``mesh_shape``:
    the names of all of them, and of those the sLSTM layer dispatches
    (``slstm_forward`` or the scan's backward on the stack)."""
    from repro_torch.configs import SLSTM, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import plan_for
    from repro_torch.roofline import trace

    seen, slstm = [], []
    codes = {TX.slstm_forward.__code__, TX._scan_backward.__code__}
    real = trace.StepRecorder._record

    def record(self, func, args, kwargs, out):
        seen.append(str(func.overloadpacket))
        if _in(codes):
            slstm.append(seen[-1])
        return real(self, func, args, kwargs, out)

    cfg = dataclasses.replace(smoke_config("xlstm-1.3b"), n_layers=1, block_pattern=(SLSTM,))
    trace.StepRecorder._record = record
    try:
        with trace.fake_world(mesh_shape[0] * mesh_shape[1]):
            mesh = make_host_mesh(*mesh_shape, device_type="cpu")
            tr = dryrun.lower_cell(cfg, ShapeConfig(kind, seq, 8, kind), mesh,
                                   plan_for(cfg, mesh))
    finally:
        trace.StepRecorder._record = real
    return seen, slstm, tr


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_trace_does_not_grow_with_the_sequence(kind):
    """The dry run traces the sLSTM's scan as one op forward (and one
    backward in training): the ops rank 0 records in the sLSTM layer of
    an xlstm step on (2, 2) fake ranks are the same at 256 positions
    as at 64, the scan's flops (by its formula) grow with them, and on a
    (1, 1) mesh, where no layout changes with the sequence, the whole
    step records as many ops at both. Within ``TRACE_SECONDS``, so that a
    per-position trace fails here instead of running on."""
    with _Alarm(TRACE_SECONDS):
        (_, sl64, tr64), (_, sl256, tr256) = (_op_counts(kind, s, (2, 2)) for s in (64, 256))
        (all64, _, _), (all256, _, _) = (_op_counts(kind, s, (1, 1)) for s in (64, 256))
    print(kind, "sLSTM layer", len(sl64), len(sl256), "step on (1, 1)", len(all64), len(all256))
    want = ["repro_torch.slstm_scan"] + (["repro_torch.slstm_scan_backward"]
                                         if kind == "train" else [])
    for ops in (sl64, sl256, all64, all256):
        assert sorted(op for op in ops if op.startswith("repro_torch.")) == want
    assert sorted(sl64) == sorted(sl256)
    assert len(all64) == len(all256)
    assert tr256.flops > tr64.flops
