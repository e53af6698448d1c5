"""A decode step copies each stacked KV cache once.

``lm.decode_step`` clones each stacked cache and writes every layer's new
slot into that copy in place (``lm._own_caches``, ``attention._decode_into``).
Held here against the out-of-place route it replaced (each layer's slot
written by ``attention_decode`` into a new cache, the layers restacked),
written out below from the public block API:

* the caller's state is bitwise unchanged by the step;
* the new state and the logits are bitwise the out-of-place route's, for
  float32 / bf16 / int8 caches, RG-LRU and xLSTM states (recurrentgemma's
  local window past its length) and whisper's decoder;
* a ``TorchDispatchMode`` counts the bytes of the cache-sized tensors a
  step allocates: one stacked cache's worth per stacked cache leaf, where
  the out-of-place route allocates two.

Port only: the reference's decode is held by ``test_torch_lm_decode.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import models as M
from repro_torch.configs import smoke_config
from repro_torch.convert import tree_flatten_with_paths, tree_map
from repro_torch.models import blocks as blk
from repro_torch.models import lm

CPU = torch.device("cpu")
PLAN = M.DEFAULT_PLAN
CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _out_of_place_step(params, state, tokens, pos, cfg):
    """The decode step as it was: every layer's state through the public
    ``blk.apply_block`` (``attention_decode`` writes a new cache), the
    pattern repeats restacked."""
    x = params["embed"][tokens.long()][:, None, :]
    n_rep, pat, tail = lm._pattern_layout(cfg)
    if cfg.is_encoder_decoder:
        new_stack, new_tail = [], list(state["tail"])
        for i in range(cfg.n_layers):
            lp, st = lm._decoder_layer(params, state, i, n_rep)
            x, st_new, _ = blk.apply_block(lp, "attn", x, cfg, None, st, decode_pos=pos)
            if i < n_rep:
                new_stack.append(st_new)
            else:
                new_tail[i - n_rep] = st_new
            x = lm._cross_attend(lm._layer(params["cross"], i), x, state["enc"], cfg)
        new = dict(state, stacks=[lm._stack(new_stack)], tail=new_tail)
        return lm._logits(params, x, cfg)[:, 0], new
    ys = []
    for r in range(n_rep):
        row = []
        for pi, kind in enumerate(pat):
            x, st_new, _ = blk.apply_block(lm._layer(params["stacks"][pi], r), kind, x, cfg,
                                           None, lm._layer(state["stacks"][pi], r),
                                           decode_pos=pos)
            row.append(st_new)
        ys.append(row)
    tail_states = []
    for i, kind in enumerate(tail):
        x, st_new, _ = blk.apply_block(params["tail"][i], kind, x, cfg, None,
                                       state["tail"][i], decode_pos=pos)
        tail_states.append(st_new)
    stacks = [lm._stack([y[pi] for y in ys]) for pi in range(len(pat))] if n_rep else None
    return lm._logits(params, x, cfg)[:, 0], {"stacks": stacks, "tail": tail_states}


def _prefilled(arch, cache_dtype, repl=None, prompt=6, max_len=12, seed=0):
    cfg = dataclasses.replace(smoke_config(arch), **(repl or {}))
    params = M.init_params(torch.Generator().manual_seed(seed), cfg, device=CPU)
    g = np.random.default_rng(seed + 1)
    batch = {"tokens": torch.from_numpy(g.integers(0, cfg.vocab, size=(2, prompt)))}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(
            g.normal(size=(2, cfg.n_encoder_frames, cfg.d_model)).astype(np.float32))
    state = M.init_decode_state(cfg, PLAN, 2, max_len, cache_dtype=cache_dtype, device=CPU)
    with torch.no_grad():
        _, state = M.prefill(params, batch, cfg, PLAN, state)
    return cfg, params, state, g


def _snapshot(tree):
    return [(path, x.clone()) for path, x in tree_flatten_with_paths(tree)]


def _assert_bitwise(tree, snap):
    leaves = tree_flatten_with_paths(tree)
    assert [p for p, _ in leaves] == [p for p, _ in snap]
    for (path, x), (_, y) in zip(leaves, snap):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x, y), path


CASES = [("llama3-8b", name, None) for name in CACHE_DTYPES] + [
    ("qwen3-moe-235b-a22b", "bfloat16", None),
    ("recurrentgemma-2b", "float32", {"local_window": 4}),
    ("recurrentgemma-2b", "int8", {"local_window": 4}),
    ("xlstm-1.3b", "float32", None),
    ("whisper-tiny", "float32", None),
    ("whisper-tiny", "bfloat16", None),
]


@pytest.mark.parametrize("arch,cache,repl", CASES)
def test_decode_leaves_state_and_matches_out_of_place(arch, cache, repl):
    """Three steps from a prefilled state (recurrentgemma's 4-position
    window wraps): the caller's state is untouched, and the new state and
    logits are bitwise the out-of-place route's."""
    cfg, params, state, g = _prefilled(arch, CACHE_DTYPES[cache], repl)
    want_state = state
    for t in range(6, 9):
        tokens = torch.from_numpy(g.integers(0, cfg.vocab, size=(2,)))
        pos = torch.full((), t, dtype=torch.int32)
        before = _snapshot(state)
        with torch.no_grad():
            logits, new = M.decode_step(params, state, tokens, pos, cfg, PLAN)
            want_logits, want_state = _out_of_place_step(params, want_state, tokens, pos, cfg)
        _assert_bitwise(state, before)
        assert torch.equal(logits, want_logits)
        _assert_bitwise(new, _snapshot(want_state))
        state = new


class _CacheCopies(TorchDispatchMode):
    """Bytes of the tensors of at least ``min_numel`` elements that ops
    allocate (outputs of ops that are neither views nor in place): all of
    them, and those of a cache's shape (per layer or stacked) and dtype
    alone (a copy of the cache, not a widened operand of its contraction)."""

    def __init__(self, min_numel, cache_shapes):
        super().__init__()
        self.min_numel, self.cache_shapes = min_numel, cache_shapes
        self.bytes = self.cache_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name.split("::")[-1]
        if not func.is_view and not name.endswith("_"):
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.numel() >= self.min_numel:
                    self.bytes += t.numel() * t.element_size()
                    if (tuple(t.shape), t.dtype) in self.cache_shapes:
                        self.cache_bytes += t.numel() * t.element_size()
        return out


@pytest.mark.parametrize("cache", list(CACHE_DTYPES))
def test_one_cache_copy_per_step(cache):
    """A step of llama3-8b's smoke config (2 stacked attention layers,
    T 64 positions) allocates one stacked cache's bytes in tensors of a
    cache's shape per stacked cache leaf (the clone); the out-of-place
    route allocates two (each layer's new cache, then the restack). Over
    every cache-sized tensor the step allocates exactly one stacked cache
    fewer than that route (the contraction's float32 operands, permuted or
    widened, are the same in both)."""
    cfg, params, state, g = _prefilled("llama3-8b", CACHE_DTYPES[cache], max_len=64)
    cache_leaves = [x for _, x in tree_flatten_with_paths(state["stacks"])]
    stacked = sum(x.numel() * x.element_size() for x in cache_leaves)
    layer_numel = min(x[0].numel() for x in cache_leaves)
    shapes = ({(tuple(x.shape), x.dtype) for x in cache_leaves}
              | {(tuple(x.shape[1:]), x.dtype) for x in cache_leaves})
    tokens = torch.from_numpy(g.integers(0, cfg.vocab, size=(2,)))
    pos = torch.full((), 6, dtype=torch.int32)
    counts = {}
    for name, step in (("one_copy", lambda: M.decode_step(params, state, tokens, pos, cfg)),
                       ("out_of_place", lambda: _out_of_place_step(params, state, tokens,
                                                                   pos, cfg))):
        with torch.no_grad(), _CacheCopies(layer_numel, shapes) as mode:
            step()
        counts[name] = (mode.cache_bytes / stacked, mode.bytes / stacked)
    print(cache, counts)
    assert counts["one_copy"][0] == 1.0 and counts["out_of_place"][0] == 2.0, counts
    assert counts["out_of_place"][1] - counts["one_copy"][1] == 1.0, counts


def test_tree_map_clone_keeps_dtypes_and_aliasing_apart():
    """The int8 scales of one block alias ({"k": z, "v": z} from
    ``make_cache_scales``); the step's copy gives each its own storage."""
    st = M.init_decode_state(smoke_config("llama3-8b"), PLAN, 1, 4, cache_dtype=torch.int8,
                             device=CPU)
    own = lm._own_caches(st["stacks"], ("attn",))
    for (_, a), (_, b) in zip(tree_flatten_with_paths(st["stacks"]),
                              tree_flatten_with_paths(own)):
        assert a.dtype == b.dtype and a.data_ptr() != b.data_ptr()
    leaves = [x for _, x in tree_flatten_with_paths(own)]
    assert len({x.data_ptr() for x in leaves}) == len(leaves)
    assert tree_map(lambda x: x.dtype, own) == tree_map(lambda x: x.dtype, st["stacks"])
