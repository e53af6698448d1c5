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
  on this rank; and, given the mesh, the mesh axes its group spans
  (``collective_axes``), so that traffic over "pod", the slow axis
  between pods, is told apart from traffic over "data";
* ``peak_bytes``: the most bytes of live storage this rank held at once,
  the step's arguments included (each storage counted once, freed when
  its last tensor dies, as the caching allocator sees the eager step);
* ``local_fallbacks``: the times ``sharding_ctx.local_shards`` found its
  ``DTensor``s laid out other than on the dims it computes along and ran
  its function on them whole (0 where every rank computes its own share).

With ``holders=True`` the recorder also keeps, for each storage the step
made, its bytes, shape, dtype and the port's frames that made it
(:class:`Holder`): ``Trace.made``, and ``Trace.peak_holders``, the
storages live at the peak, largest first (``tools/peak_holders.py``). A
storage made in the backward is named by the forward frames of the
autograd node that made it (each node is tagged with the port's frames
when the forward makes it or first hands it on), after any port frames of
the backward code itself (a custom ``backward``, a recompute): the
frames of the backward's caller alone would name every such storage by
the training step's call to ``torch.autograd.grad``.

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
from torch.overrides import TorchFunctionMode
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
    # the mesh axes each collective's group spans, in mesh order: one tuple
    # per ``collectives`` entry, () where the trace was given no mesh
    collective_axes: list = dataclasses.field(default_factory=list)
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
    local_fallbacks: int = 0
    # with StepRecorder(holders=True): every storage the step made, and those
    # live at the peak (the arguments' too), largest first
    made: list = dataclasses.field(default_factory=list)
    peak_holders: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Holder:
    """A storage of the step: its bytes, the shape and dtype of the tensor
    it was made for, and the port's frames on the stack then, innermost
    first (``"models/rglru.py:120 associative_scan"``); ``("argument",)``
    for a step's argument. ``backward``: the name of the autograd node
    that made it in the backward (``"MmBackward0"``), whose forward frames
    then end ``frames``; ``None`` in the forward."""

    nbytes: int
    shape: tuple
    dtype: str
    frames: tuple
    backward: str | None = None


_PORT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.abspath(__file__)


_FRAMES_KEY = "repro_torch_frames"     # an autograd node's metadata: its forward frames
_ENGINE_ENTRY = "_engine_run_backward"  # torch.autograd's call into the engine


def _port_frames(depth: int = 8, start: int = 2, in_backward: bool = False) -> tuple:
    """The innermost ``depth`` frames of the port's code on the stack from
    ``start`` frames up, the recorder's own left out; ``in_backward``:
    only those the autograd engine runs (a custom ``backward``, a
    recompute), not its caller's."""
    out = []
    f = sys._getframe(start)
    while f is not None and len(out) < depth:
        if in_backward and f.f_code.co_name == _ENGINE_ENTRY:
            break
        name = f.f_code.co_filename
        if name.startswith(_PORT_DIR) and name != _SELF:
            out.append(f"{os.path.relpath(name, _PORT_DIR)}:{f.f_lineno} {f.f_code.co_name}")
        f = f.f_back
    return tuple(out)


def _made_where(depth: int = 8) -> tuple[tuple, str | None]:
    """The frames that name a storage made now, and the autograd node that
    makes it where the backward runs (see the module docstring)."""
    node = torch._C._current_autograd_node()
    if node is None:
        return _port_frames(depth, start=3), None
    live = _port_frames(depth, start=3, in_backward=True)
    return (live + node.metadata.get(_FRAMES_KEY, ()))[:depth], node.name()


class _NodeFrames(TorchFunctionMode):
    """Tags each autograd node an op makes with the port's frames at that
    point, once (:data:`_FRAMES_KEY` in its metadata): the nodes of the
    tensors it makes or takes and the untagged nodes behind them (a
    composite op's inner nodes, an einsum's ``bmm``). A node this mode
    does not see made (a custom ``autograd.Function``'s, a
    ``redistribute``'s) is tagged where it is first used."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        frames = None
        todo = [t.grad_fn for t in _tensors((out, args, kwargs))]
        while todo:
            node = todo.pop()
            if node is None or _FRAMES_KEY in node.metadata:
                continue
            frames = frames or _port_frames(start=2)
            node.metadata[_FRAMES_KEY] = frames
            todo.extend(n for n, _ in node.next_functions)
        return out


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

    def __init__(self, fake_mode=None, mesh=None, holders: bool = False):
        super().__init__()
        self.fake_mode = fake_mode
        self.mesh = mesh
        self.holders = holders
        # with holders: [Holder, born, died] a storage, in the order made;
        # the event count (a storage made or freed) and its value at the peak
        self._made: list = []
        self._events = 0
        self._peak_event = 0
        self._arguments = True            # hold() registers the arguments
        self._axes: dict = {}             # a collective's group -> its mesh axes
        self.trace = Trace()
        self.read: set[int] = set()       # ids of the storages a non-view op took
        self.propagating = 0              # see _propagation_marked
        self._live: dict[int, int] = {}   # id of a live storage -> its bytes
        self._cur = 0
        self._stack = contextlib.ExitStack()

    # -- live storage ------------------------------------------------------
    def _free(self, key: int, entry=None) -> None:
        self._cur -= self._live.pop(key, 0)
        if entry is not None:
            self._events += 1
            entry[2] = self._events

    def _hold_storage(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        entry = None
        if self.holders:
            self._events += 1
            frames, node = (("argument",), None) if self._arguments else _made_where()
            entry = [Holder(n, tuple(t.shape), str(t.dtype).replace("torch.", ""), frames,
                            node), self._events, None]
            self._made.append(entry)
        weakref.finalize(st, self._free, key, entry)
        self._cur += n
        if self._cur > self.trace.peak_bytes:
            self.trace.peak_bytes = self._cur
            self._peak_event = self._events

    def hold(self, tree) -> None:
        """Count the local storage of every tensor of ``tree`` as live."""
        for x in _tensors(tree):
            self._hold_storage(local_tensor(x))

    def collect_holders(self) -> None:
        """Fill the trace's ``made`` and ``peak_holders`` (with ``holders``)."""
        at = self._peak_event
        self.trace.made = [h for h, _, _ in self._made if h.frames != ("argument",)]
        live = [h for h, born, died in self._made
                if born <= at and (died is None or died > at)]
        self.trace.peak_holders = sorted(live, key=lambda h: -h.nbytes)

    def _group_axes(self, args, kwargs) -> tuple[str, ...]:
        """The axes of :attr:`mesh` along which a collective's group (its
        ``group_name`` or its ``ProcessGroup`` argument) runs: those whose
        coordinate differs between the group's ranks. ``()`` without a
        mesh."""
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        if self.mesh is None:
            return ()
        flat = tree_flatten((args, kwargs))[0]
        group = next((a for a in reversed(flat) if isinstance(a, str)), None)
        if group is None:
            group = next((a for a in flat if isinstance(a, dist.ProcessGroup)), None)
        if group is None:
            return ()
        key = group if isinstance(group, str) else id(group)
        if key not in self._axes:
            pg = _resolve_process_group(group) if isinstance(group, str) else group
            ranks = dist.get_process_group_ranks(pg)
            layout = self.mesh.mesh
            coords = [tuple(int(c) for c in (layout == r).nonzero()[0]) for r in ranks]
            names = self.mesh.mesh_dim_names or tuple(str(i) for i in range(layout.dim()))
            self._axes[key] = tuple(n for d, n in enumerate(names)
                                    if len({c[d] for c in coords}) > 1)
        return self._axes[key]

    # -- the mode ------------------------------------------------------------
    def __enter__(self):
        self._arguments = False
        self._stack.enter_context(_propagation_marked(self))
        if self.holders:
            self._stack.enter_context(_NodeFrames())
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
            tr.collective_axes.append(self._group_axes(args, kwargs))
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


def trace_step(step, *args, fake_mode=None, mesh=None, holders: bool = False) -> Trace:
    """Run ``step(*args)`` under a :class:`StepRecorder` holding ``args``
    as live storage; its trace, with the local bytes of the arguments the
    step reads (one that no op takes, or whose shape alone is used, is not
    an argument of the step, as ``jax.jit`` prunes it) and of its outputs.
    ``fake_mode``: the ``FakeTensorMode`` of fake ``args`` (see
    :class:`StepRecorder`); the step runs outside it. ``mesh``: the
    ``DeviceMesh`` whose axes each collective is attributed to.
    ``holders``: keep each storage's provenance (:class:`StepRecorder`)."""
    from repro_torch.models import sharding_ctx

    rec = StepRecorder(fake_mode, mesh, holders)
    rec.hold(args)
    fallbacks = sharding_ctx.LOCAL_FALLBACKS[0]
    t0 = time.time()
    with rec:
        out = step(*args)
    tr = rec.trace
    tr.step_s = time.time() - t0
    tr.local_fallbacks = sharding_ctx.LOCAL_FALLBACKS[0] - fallbacks
    if holders:
        rec.collect_holders()
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
