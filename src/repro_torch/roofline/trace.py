"""The dry run's stand-in for a compiler: one rank's record of a step run
on fake tensors.

The reference compiles each step with XLA and reads the compiled program:
``cost_analysis()`` for flops and bytes accessed, the partitioned HLO text
for the collectives, ``memory_analysis()`` for the bytes per device. The
port has no compiler, so it runs the step itself, as ``DTensor``s on a
``fake`` process group (one process stands for every rank; collectives
return at once) and on ``FakeTensor``s (shapes, dtypes and devices with no
storage behind them), and :class:`StepRecorder` records what rank 0 does:

* ``flops``: the matmul-class ops (``torch.utils.flop_counter``'s
  formulas: mm, bmm, addmm, convolutions, attention), as XLA's count of a
  dot; elementwise work is not counted;
* ``bytes``: each op's tensor inputs read once and its outputs written
  once, fusion-blind as XLA:CPU's "bytes accessed" (views and ``empty``
  move nothing and count nothing);
* ``collectives``: each ``_c10d_functional`` / ``c10d`` / ``_dtensor``
  collective, by the reference's kind name, with the bytes of its result
  on this rank;
* ``peak_bytes``: the most bytes of live storage this rank held at once,
  the step's arguments included (each storage counted once, freed when
  its last tensor dies, as the caching allocator sees the eager step).

``DTensor`` computes each op on its local shards, so the recorder returns
``NotImplemented`` for an op on ``DTensor``s and records the local ops
that ``DTensor`` then dispatches: rank 0's share, not the global work that
``torch.utils.flop_counter.FlopCounterMode`` counts for a ``DTensor`` op.
The global-shape fake op that ``DTensor``'s sharding propagation runs to
learn an output's layout is not rank 0's work and is left out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# collective op name (``_c10d_functional``, ``c10d`` and ``_dtensor``
# namespaces) -> the reference's HLO kind. ``shard_dim_alltoall`` is
# DTensor's Shard(i) -> Shard(j) on CUDA (on the CPU it gathers and chunks
# instead); ``send`` is one side of a ring shift, which XLA emits as a
# collective-permute
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")
# the result a c10d op writes: the argument that is its output buffer
_OUT_ARG = {"allgather_": 0, "_allgather_base_": 0, "reduce_scatter_": 0,
            "_reduce_scatter_base_": 0, "alltoall_base_": 0, "alltoall_": 0,
            "allgather_into_tensor_coalesced_": 0}

_TORCH_DIR = os.path.dirname(torch.__file__)
_DIST_DIR = os.path.join(_TORCH_DIR, "distributed")

@dataclasses.dataclass
class Trace:
    """What one rank did in one step (see the module docstring), and the
    local bytes of the step's arguments and outputs (``alias_bytes``: the
    outputs that reuse an argument's storage, as an update in place)."""

    flops: float = 0.0
    bytes: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)  # [(kind, bytes)]
    # the collectives made inside ``sharding_ctx.replicated`` (the Replicate()
    # detours around ops DTensor has no rule for), also in ``collectives``
    detour_collectives: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    n_outputs: int = 0
    setup_s: float = 0.0     # building the step's inputs (set by the caller)
    step_s: float = 0.0      # the traced step's wall time


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def local_tensor(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s shard on this rank, else ``x``."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flop_formula(func):
    from torch.utils.flop_counter import flop_registry

    return flop_registry.get(func._overloadpacket)


@contextlib.contextmanager
def _propagation_marked(rec: "StepRecorder"):
    """While active, ``rec.propagating`` counts the calls in flight of
    ``DTensor``'s sharding propagation, which runs an op at global shapes
    to learn its output's layout: not rank 0's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        raise RuntimeError(f"torch {torch.__version__}: ShardingPropagator.{name} is gone; "
                           "the recorder cannot tell propagation from rank 0's ops")

    def marked(self, *args, **kwargs):
        rec.propagating += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            rec.propagating -= 1

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _made_by_torch_distributed() -> bool:
    """Whether the tensor factory op being dispatched was called from
    ``torch.distributed`` (DTensor's layout bookkeeping, which reads its
    small index tensors back to the host) rather than from the step's own
    code: the first frame up the stack outside torch's dispatch plumbing
    decides."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_DIST_DIR):
            return True
        if not name.startswith(_TORCH_DIR):
            return False
        f = f.f_back
    return False


def _in_detour() -> bool:
    """Whether ``sharding_ctx.replicated`` is on the stack."""
    from repro_torch.models.sharding_ctx import replicated

    code = replicated.__code__
    f = sys._getframe(2)
    while f is not None:
        if f.f_code is code:
            return True
        f = f.f_back
    return False


class StepRecorder(TorchDispatchMode):
    """Records rank 0's local ops into :attr:`trace`. Use as a context
    manager around the step, after :meth:`hold` has registered the step's
    arguments as live storage. With ``fake_mode`` (the ``FakeTensorMode``
    of the fake inputs) the step runs outside that mode, and the tensors
    the step's own code makes from nothing (``torch.zeros``, ``arange``,
    ``full``) are made in it: fake, whatever their size. DTensor's
    bookkeeping tensors stay real, since DTensor reads them back."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.trace = Trace()
        self.read: set[int] = set()       # ids of the storages a non-view op took
        self.propagating = 0              # see _propagation_marked
        self._live: dict[int, int] = {}   # id of a live storage -> its bytes
        self._cur = 0
        self._stack = contextlib.ExitStack()

    # -- live storage ------------------------------------------------------
    def _free(self, key: int) -> None:
        self._cur -= self._live.pop(key, 0)

    def _hold_storage(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        weakref.finalize(st, self._free, key)
        self._cur += n
        if self._cur > self.trace.peak_bytes:
            self.trace.peak_bytes = self._cur

    def hold(self, tree) -> None:
        """Count the local storage of every tensor of ``tree`` as live."""
        for x in _tensors(tree):
            self._hold_storage(local_tensor(x))

    # -- the mode ------------------------------------------------------------
    def __enter__(self):
        self._stack.enter_context(_propagation_marked(self))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor dispatches the local ops
        if (self.fake_mode is not None and not _tensors((args, kwargs))
                and not _made_by_torch_distributed()):
            with self.fake_mode:
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        if not self.propagating:
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        tr = self.trace
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        name = func._opname
        kind = (COLLECTIVE_KINDS.get(name) if func.namespace in _COLLECTIVE_NAMESPACES
                else None)
        if kind is not None:
            # the result on this rank: the output buffer of an in-place c10d
            # op (which returns only a work handle), the sent tensor of a
            # ring shift, else the op's output (or its in-place operand)
            res = (_tensors(args[_OUT_ARG[name]]) if name in _OUT_ARG
                   else ins[:1] if kind == "collective-permute" else outs or ins[:1])
            tr.collectives.append((kind, sum(_nbytes(t) for t in res)))
            if _in_detour():
                tr.detour_collectives.append(tr.collectives[-1])
        if not outs:             # metadata (prim.device, sizes) or a work handle
            return
        if self.fake_mode is not None and not isinstance(outs[0], FakeTensor):
            return               # DTensor's real bookkeeping, not the step's work
        if not func.is_view:     # a view reads nothing; what consumes it does
            self.read.update(id(t.untyped_storage()) for t in ins)
        formula = _flop_formula(func)
        if formula is not None:
            if func._overloadname == "dtype":   # bmm.dtype's (a, b, out_dtype): no shape
                args, kwargs = args[:-1], dict(kwargs, out_dtype=args[-1])
            tr.flops += float(formula(*args, **kwargs, out_val=out))
        if not func.is_view and not name.startswith("empty") and name != "wait_tensor":
            tr.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._hold_storage(t)


def _local_bytes(tree) -> int:
    return sum(_nbytes(local_tensor(x)) for x in _tensors(tree))


def trace_step(step, *args, fake_mode=None) -> Trace:
    """Run ``step(*args)`` under a :class:`StepRecorder` holding ``args``
    as live storage; its trace, with the local bytes of the arguments the
    step reads (one that no op takes, or whose shape alone is used, is not
    an argument of the step, as ``jax.jit`` prunes it) and of its outputs.
    ``fake_mode``: the ``FakeTensorMode`` of fake ``args`` (see
    :class:`StepRecorder`); the step runs outside it."""
    rec = StepRecorder(fake_mode)
    rec.hold(args)
    t0 = time.time()
    with rec:
        out = step(*args)
    tr = rec.trace
    tr.step_s = time.time() - t0
    arg_storages = {id(local_tensor(x).untyped_storage()) for x in _tensors(args)}
    tr.argument_bytes = sum(_nbytes(local_tensor(x)) for x in _tensors(args)
                            if id(local_tensor(x).untyped_storage()) in rec.read)
    tr.output_bytes = _local_bytes(out)
    tr.alias_bytes = sum(_nbytes(local_tensor(x)) for x in _tensors(out)
                         if id(local_tensor(x).untyped_storage()) in arg_storages)
    tr.n_outputs = len(_tensors(out))
    return tr


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks in this
    process, this process rank 0: collectives return at once and move
    nothing. Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process; "
                           "the dry run needs its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
