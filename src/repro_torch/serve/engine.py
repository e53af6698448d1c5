"""Multi-stream saccadic serving engine.

The engine owns ``capacity`` fixed slots; every device tensor is
slot-major with a static leading axis, so one batched step serves any mix
of streams:

* ``admit`` / ``evict`` only record host bookkeeping; all pending row
  writes (and a governed engine's budget re-split) coalesce, last op per
  slot wins, into ONE flush right before the next step or state read.
* ``step(frames)`` takes any subset of the admitted streams. Un-fed slots
  hold: their gaze, frame age, caches, controls and meters pass through
  unchanged and their logits are zero; fed slots are served exactly as in
  a full-cover step.
* ``step(frames, block=False)`` returns a :class:`StepHandle` as soon as
  the tick is issued; ``step_rollout(frames_by_tick)`` issues T ticks with
  no host round-trip between them (:func:`serve_step.make_rollout`),
  bitwise T ``step()`` calls. Neither waits for the card: constants are
  filled on the device, the delta backend's skip is a device-side select,
  and uploads are non-blocking copies from page-locked staging. The one
  host wait is for a staging buffer whose previous upload is still in
  flight (two alternate for ``step``; one per rollout length T).
* Frames live in a persistent device buffer (S, H, W, 3); each tick
  uploads only the fed rows and writes them into it in place.
* Freshly admitted slots bootstrap their first gaze from the in-pixel
  patch energy inside the step; later frames take the top k of the
  saccade scores (optionally EMA-smoothed).
* Each slot meters the energy events its frontend executed (last frame
  and running mean since admit), priced at read time by an EnergyMeter.

Modes: ``temporal=True`` threads a per-slot feature cache (only stale
patches are re-projected); ``governor=GovernorSpec(...)`` (needs temporal)
steers each slot's recompute cap, token tier and backend snap budget
toward a mW budget, and with ``sign_tier`` may degrade a slot to the sign
view of its codes; ``backend_delta=True`` threads a per-slot backend
cache (unchanged rows reuse their encoder work, an unchanged frame serves
cached logits).

Slot sharding: with ``mesh=`` (a ``launch.mesh.LocalMesh``) the slots are
split over the mesh's devices along ``axis`` when the axis divides the
capacity (``fit_spec``): each shard's state and frame buffer live on its
device and each shard is stepped there with its own kernel launches
(per-slot parallel, params replicated, no collective); fetches merge the
shards in slot order. An indivisible capacity runs unsharded on the
mesh's first device.
"""

from __future__ import annotations

from typing import Any, Hashable, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.convert import tree_to
from repro_torch.core import frontend as fe
from repro_torch.core import saliency as sal
from repro_torch.core.power import EnergyMeter, EventCounts, dense_backend_macs
from repro_torch.core.temporal import FeatureCache, init_feature_cache
from repro_torch.models import backend_delta as bdel
from repro_torch.models.sharding_ctx import P, fit_spec
from repro_torch.models.vit import vit_forward_compact
from repro_torch.serve import governor as gov_mod
from repro_torch.serve.serve_step import make_rollout, saccade_scores


def _fetch(logits, axis: int) -> np.ndarray:
    """Device logits (a tensor, or one per slot shard) on the host, the
    shards merged in slot order along ``axis``."""
    if isinstance(logits, torch.Tensor):
        return logits.cpu().numpy()
    return np.concatenate([t.cpu().numpy() for t in logits], axis=axis)


class StepHandle:
    """A tick's result, issued but not fetched: the device's (S, n_classes)
    logits (one tensor per slot shard on a sharded engine) and the fed
    streams' sid -> slot map. :meth:`result` makes the device-to-host
    fetch and caches the dict. The handle stays valid across later engine
    calls (step outputs are fresh tensors that nothing writes into), but
    an unfetched handle keeps its logits on the card."""

    __slots__ = ("_logits", "_slots", "_out")

    def __init__(self, logits, slots: dict):
        self._logits = logits
        self._slots = slots
        self._out = None

    def result(self) -> dict[Hashable, np.ndarray]:
        """Stream id -> (n_classes,) logits for exactly the fed streams;
        blocks until they are on the host. Idempotent."""
        if self._out is None:
            arr = None if self._logits is None else _fetch(self._logits, 0)
            self._out = {sid: arr[s] for sid, s in self._slots.items()}
            self._logits = None
        return self._out


class RolloutHandle:
    """A rollout's result, issued but not fetched: the device's (T, S,
    n_classes) logits and each tick's sid -> slot map; :meth:`result`
    fetches all T ticks in one transfer. Same lifetime as
    :class:`StepHandle`."""

    __slots__ = ("_logits", "_slot_maps", "_out")

    def __init__(self, logits, slot_maps: list):
        self._logits = logits
        self._slot_maps = slot_maps
        self._out = None

    def result(self) -> list[dict[Hashable, np.ndarray]]:
        """One dict per tick (stream id -> (n_classes,) logits of that
        tick's fed streams); blocks until they are on the host. Idempotent."""
        if self._out is None:
            arr = None if self._logits is None else _fetch(self._logits, 1)
            self._out = [{sid: arr[t, s] for sid, s in m.items()}
                         for t, m in enumerate(self._slot_maps)]
            self._logits = None
        return self._out


class _Staging(NamedTuple):
    """Host staging of fed rows (page-locked on a CUDA engine), compact:
    ``rows[f]`` is the f-th fed frame, ``slots[f]`` its slot, ``fed`` the
    (S,) or (T, S) fed mask; ``event`` (CUDA only) is recorded after the
    last upload from it, and the host waits on it before writing again.
    The numpy views share the tensors' memory."""

    rows: torch.Tensor
    slots: torch.Tensor
    fed: torch.Tensor
    rows_np: np.ndarray
    slots_np: np.ndarray
    fed_np: np.ndarray
    event: Any


def _new_staging(n_rows: int, fed_shape: tuple, frame_shape: tuple,
                 device: torch.device) -> _Staging:
    pin = device.type == "cuda"
    rows = torch.zeros((n_rows,) + frame_shape, dtype=torch.float32, pin_memory=pin)
    slots = torch.zeros((n_rows,), dtype=torch.int64, pin_memory=pin)
    fed = torch.zeros(fed_shape, dtype=torch.bool, pin_memory=pin)
    return _Staging(rows, slots, fed, rows.numpy(), slots.numpy(), fed.numpy(),
                    torch.cuda.Event() if pin else None)


class StreamState(NamedTuple):
    """Per-slot gaze state; every leaf is slot-major with static shape.
    ``cache`` (temporal), ``controls`` (governed) and ``bcache`` (backend
    delta) are None unless the engine runs in that mode."""

    indices: torch.Tensor    # (S, k) int32 — next frame's patch selection
    ema: torch.Tensor        # (S, P) float32 — attention-score EMA
    frame_age: torch.Tensor  # (S,) int32 — frames served since admit (0 = bootstrap)
    active: torch.Tensor     # (S,) bool — slot occupied
    cache: FeatureCache | None = None          # per-slot temporal cache
    events_last: EventCounts = EventCounts()   # (S,) leaves — last frame
    events_mean: EventCounts = EventCounts()   # (S,) leaves — mean/frame
    controls: gov_mod.GovernorControls | None = None  # governed mode only
    bcache: bdel.BackendCache | None = None   # backend-delta mode only


def _zero_events(capacity: int, device) -> EventCounts:
    return EventCounts(*(torch.zeros((capacity,), dtype=torch.float32, device=device)
                         for _ in EventCounts._fields))


def init_stream_state(cfg, capacity: int, device, temporal: bool = False,
                      governed: bool = False, backend: bool = False) -> StreamState:
    """All slots free; indices are a placeholder (age 0 bootstraps in-step)."""
    k = cfg.frontend.n_active
    p = cfg.frontend.n_patches
    j_max = cfg.frontend.temporal.budget(k)
    return StreamState(
        indices=torch.arange(k, dtype=torch.int32, device=device).repeat(capacity, 1),
        ema=torch.zeros((capacity, p), dtype=torch.float32, device=device),
        frame_age=torch.zeros((capacity,), dtype=torch.int32, device=device),
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        cache=(init_feature_cache(cfg.frontend, (capacity,), device=device)
               if temporal else None),
        events_last=_zero_events(capacity, device),
        events_mean=_zero_events(capacity, device),
        controls=gov_mod.init_controls(capacity, j_max, device) if governed else None,
        # the payload dtype of the code wire, as the feature cache holds it
        bcache=(bdel.init_backend_cache(cfg, k, (capacity,),
                                        dtype=cfg.frontend.adc.code_dtype,
                                        device=device) if backend else None),
    )


def _freeze_rows(act: torch.Tensor, new: NamedTuple, old: NamedTuple) -> NamedTuple:
    """Per-leaf ``where(act, new, old)`` with act (S,) broadcast up to each
    slot-major leaf."""
    return type(new)(*(torch.where(act.reshape(act.shape + (1,) * (n.dim() - 1)), n, o)
                       for n, o in zip(new, old)))


def make_engine_step(cfg, explore: float = 0.1, ema_decay: float = 0.0,
                     project_fn=None, temporal: bool = False,
                     governor: gov_mod.GovernorSpec | None = None,
                     meter: EnergyMeter = EnergyMeter(), frame_hz: float = 30.0,
                     backend: bool = False):
    """Batched slot step (params, frames (S,H,W,3), fed (S,) bool, state)
    -> (logits (S, n_classes), state): per slot one saccade frame, plus the
    in-step bootstrap at age 0, EMA blending of the scores, and holds for
    inactive or un-fed slots. A governed step applies the controls to this
    frame's gate and updates them from this frame's events for the next."""
    fcfg = cfg.frontend
    k = fcfg.n_active
    j_max = fcfg.temporal.budget(k)
    n_pixels = float(fcfg.image_h * fcfg.image_w)
    backend_mw = 0.0
    if backend:
        # the governor's plant model of the backend: a dense frame's power
        backend_mw = (dense_backend_macs(k, cfg.n_layers, fcfg.patch.n_vectors,
                                         cfg.d_model, cfg.d_ff, cfg.n_classes)
                      * meter.k.e_backend_mac_j * frame_hz * 1e3)

    def step(params, frames, fed, state: StreamState):
        act = state.active & fed
        patches, weights = fe.sensor_patches(params["ip2"], frames, fcfg)
        boot = sal.topk_patch_indices(sal.patch_energy(patches), k)
        fresh = state.frame_age == 0
        indices = torch.where(fresh[:, None], boot, state.indices)
        cache = bcache = eps = None
        if temporal:
            # belt to the admit wipe: a fresh slot never serves held charge
            cache = state.cache._replace(valid=state.cache.valid & ~fresh[:, None])
        if backend:
            bcache = state.bcache._replace(valid=state.bcache.valid & ~fresh)
            if governor is not None:
                eps = state.controls.eps
        k_cap = stale_cap = sign_mode = None
        if governor is not None:
            k_cap = gov_mod.tier_k_eff(governor, state.controls.tier, k)
            stale_cap = state.controls.j_cap
            if governor.sign_tier:
                # the sign tier: flagged slots serve the sign view of their
                # codes; the cache keeps the real ones for the recovery
                sign_mode = gov_mod.tier_is_sign(governor, state.controls.tier)
        logits, aux = vit_forward_compact(
            params, frames, cfg, indices=indices, project_fn=project_fn,
            precomputed=(patches, weights), cache=cache, k_cap=k_cap,
            stale_cap=stale_cap, sign_mode=sign_mode, backend_cache=bcache,
            backend_eps=eps, backend_act=act if backend else None)
        scores = saccade_scores(aux, explore)
        ema = torch.where(fresh[:, None], scores,
                          ema_decay * state.ema + (1.0 - ema_decay) * scores)
        next_idx = sal.topk_patch_indices(ema, k)
        # only served slots spend events; the cumulative meter is a running
        # mean since admit, so it stays at per-frame magnitude
        ev_last = EventCounts(*(torch.where(act, e, o)
                                for e, o in zip(aux["events"], state.events_last)))
        n_served = (state.frame_age + 1).to(torch.float32)
        ev_mean = EventCounts(*(torch.where(act, m + (e - m) / n_served, m)
                                for m, e in zip(state.events_mean, ev_last)))
        controls = None
        if governor is not None:
            actf = act.to(torch.float32)
            controls = gov_mod.control_update(
                governor, state.controls, EventCounts(*(e * actf for e in aux["events"])),
                act, meter, frame_hz, n_pixels, fcfg.patch.pixels_per_patch,
                fcfg.patch.n_vectors, j_max, k, backend_mw=backend_mw)
        new_state = StreamState(
            indices=torch.where(act[:, None], next_idx, state.indices),
            ema=torch.where(act[:, None], ema, state.ema),
            frame_age=torch.where(act, state.frame_age + 1, state.frame_age),
            active=state.active,
            cache=_freeze_rows(act, aux["cache"], state.cache) if temporal else None,
            events_last=ev_last,
            events_mean=ev_mean,
            controls=controls,
            bcache=(_freeze_rows(act, aux["backend_cache"], state.bcache)
                    if backend else None),
        )
        logits = torch.where(act[:, None], logits, torch.zeros_like(logits))
        return logits, new_state

    return step


def _make_churn(k: int, j_max: int):
    """ONE coalesced churn flush: ``admit_hit`` rows are fully reset (a
    recycled slot never serves its predecessor's state), ``evict_hit`` rows
    only drop the active flag; ``budgets`` (S,) rewrites a governed
    engine's per-slot shares."""

    def churn(state: StreamState, admit_hit, evict_hit, budgets=None) -> StreamState:
        hit = admit_hit
        dev = hit.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        cache = state.cache
        if cache is not None:
            cache = FeatureCache(
                features=torch.where(hit[:, None, None],
                                     torch.zeros((), dtype=cache.features.dtype, device=dev),
                                     cache.features),
                energy=torch.where(hit[:, None], zero, cache.energy),
                age=torch.where(hit[:, None], torch.zeros_like(cache.age), cache.age),
                valid=cache.valid & ~hit[:, None],
                n_stale=torch.where(hit, torch.zeros_like(cache.n_stale), cache.n_stale),
            )
        bcache = None if state.bcache is None else bdel.wipe_rows(state.bcache, hit)
        controls = state.controls
        if controls is not None:
            controls = gov_mod.reset_rows(controls, hit, j_max)
            if budgets is not None:
                controls = controls._replace(budget_mw=budgets)
        return StreamState(
            indices=torch.where(hit[:, None],
                                torch.arange(k, dtype=torch.int32, device=dev)[None],
                                state.indices),
            ema=torch.where(hit[:, None], zero, state.ema),
            frame_age=torch.where(hit, torch.zeros_like(state.frame_age), state.frame_age),
            active=(state.active & ~evict_hit) | hit,
            cache=cache,
            events_last=EventCounts(*(torch.where(hit, zero, e) for e in state.events_last)),
            events_mean=EventCounts(*(torch.where(hit, zero, e) for e in state.events_mean)),
            controls=controls,
            bcache=bcache,
        )

    return churn


class _Shard:
    """Slots ``lo..hi`` of an engine on ``device``: their params copy,
    state and frame buffer."""

    __slots__ = ("lo", "hi", "device", "params", "state", "frames")

    def __init__(self, lo, hi, device, params, state, frames):
        self.lo, self.hi, self.device = lo, hi, device
        self.params, self.state, self.frames = params, state, frames


def _cat_states(states: list, device: torch.device):
    """Slot-major trees (tensors, NamedTuples, None) of several shards
    concatenated along the slot axis on ``device``."""
    first = states[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([s.to(device) for s in states])
    return type(first)(*(_cat_states(list(parts), device) for parts in zip(*states)))


class SaccadeEngine:
    """Slot-based multi-stream saccadic server.

    Every call runs on the current CUDA stream in eager PyTorch. ``step``
    and ``step_rollout`` issue their work and, with ``block=False``, return
    a handle before the card has finished; churn (admit / evict / budget)
    is flushed at the next step or rollout, so it lands only at their
    boundaries.

    Args:
      cfg: ViTConfig of the backend (``quant_embed`` / ``fused_embed``
        select the kernel routes; ``delta_kernel`` the ragged attention
        kernel of the delta-gated backend).
      params: model parameters (moved to ``device``).
      capacity: number of slots.
      explore / project_fn: as in ``serve_step.make_saccade_step``; pass
        ``ops.ip2_codes_fn(spec, adc)`` for the staged kernel route.
      ema_decay: attention-EMA smoothing; 0.0 = per-frame scores.
      temporal: the per-slot temporal gate (``cfg.frontend.temporal``).
      meter / frame_hz: the EnergyMeter pricing the per-slot meters.
      governor: a ``GovernorSpec`` closing the loop on a mW budget (needs
        ``temporal``); shares are priority-weighted over admitted streams.
        Its ``sign_tier`` serves the sign view of the code wire on slots the
        budget cannot otherwise fund (the staged route only).
      backend_delta: the per-slot delta-gated backend cache
        (``governor.backend_eps > 0`` needs it).
      device: where the engine runs; None means the GPU (raises without one).
      mesh / axis: a ``LocalMesh`` to split the slots over along ``axis``
        (default "data") when it divides the capacity; otherwise the
        engine runs unsharded on the mesh's first device. Excludes
        ``device``.
    """

    def __init__(self, cfg, params, capacity: int = 8, *, mesh=None, axis: str = "data",
                 explore: float = 0.1,
                 ema_decay: float = 0.0, project_fn=None, temporal: bool = False,
                 meter: EnergyMeter = EnergyMeter(), frame_hz: float = 30.0,
                 governor: gov_mod.GovernorSpec | None = None,
                 backend_delta: bool = False, device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if governor is not None and not temporal:
            raise ValueError("governor requires temporal=True: the recompute cap "
                             "governs the temporal gate's per-frame allocation")
        if governor is not None and governor.backend_eps > 0.0 and not backend_delta:
            raise ValueError("governor.backend_eps budgets the delta-gated backend; "
                             "build the engine with backend_delta=True or drop "
                             "backend_eps")
        if mesh is not None and device is not None:
            raise ValueError("pass mesh or device, not both")
        shard_devices = None
        if mesh is not None:
            # an indivisible slot axis is dropped: run unsharded
            if fit_spec(P(axis), (capacity,), mesh)[0] is not None:
                # every device of a LocalMesh lies on its first axis
                shard_devices = mesh.devices if axis == mesh.axis_names[0] else mesh.devices[:1]
            device = mesh.devices[0]
        self.device = resolve_device(device)
        if shard_devices is None:
            shard_devices = [self.device]
        else:
            shard_devices = [resolve_device(d) for d in shard_devices]
        self.cfg = cfg
        self.params = tree_to(params, self.device)
        self.capacity = capacity
        self.temporal = temporal
        self.backend = backend_delta
        self.meter = meter
        self.frame_hz = frame_hz
        self.governor = governor
        self._priority: dict[Hashable, float] = {}
        self._slots: list[Hashable | None] = [None] * capacity
        self._slot_index: dict[Hashable, int] = {}
        # slot -> "admit" | "evict", last op wins; flushed (with a governed
        # engine's budget re-split) before the next step or state read
        self._pending: dict[int, str] = {}
        self._budgets_dirty = False
        self._budget_mw = None if governor is None else governor.budget_mw
        fcfg = cfg.frontend
        self._frame_shape = (fcfg.image_h, fcfg.image_w, 3)
        # step() alternates two staging buffers; rollouts keep one per T
        self._stages = [_new_staging(capacity, (capacity,), self._frame_shape, self.device)
                        for _ in range(2)]
        self._stage_next = 0
        self._roll_stage: dict[int, _Staging] = {}
        self._step_fn = make_engine_step(
            cfg, explore=explore, ema_decay=ema_decay, project_fn=project_fn,
            temporal=temporal, governor=governor, meter=meter, frame_hz=frame_hz,
            backend=backend_delta)
        k = fcfg.n_active
        self._churn_fn = _make_churn(k, fcfg.temporal.budget(k))
        self._rollout_fn = make_rollout(self._step_fn)
        per = capacity // len(shard_devices)
        self._shards = [
            _Shard(i * per, (i + 1) * per, dev,
                   self.params if dev == self.device else tree_to(params, dev),
                   init_stream_state(cfg, per, dev, temporal=temporal,
                                     governed=governor is not None, backend=backend_delta),
                   torch.zeros((per, fcfg.image_h, fcfg.image_w, 3),
                               dtype=torch.float32, device=dev))
            for i, dev in enumerate(shard_devices)]

    # ---- host-side slot bookkeeping ------------------------------------
    @property
    def n_shards(self) -> int:
        """Slot shards the engine steps (1 when unsharded)."""
        return len(self._shards)

    @property
    def shard_states(self) -> list[StreamState]:
        """Each shard's device state (slots lo..hi of the shard, on its
        device), pending churn flushed first."""
        self._flush_churn()
        return [sh.state for sh in self._shards]

    @property
    def state(self) -> StreamState:
        """Device state with any pending churn flushed first; a sharded
        engine's shards merged in slot order on the first shard's device."""
        self._flush_churn()
        if len(self._shards) == 1:
            return self._shards[0].state
        return _cat_states([sh.state for sh in self._shards], self.device)

    @property
    def stream_ids(self) -> list[Hashable]:
        return [s for s in self._slots if s is not None]

    @property
    def free_slots(self) -> int:
        return self._slots.count(None)

    def slot_of(self, stream_id: Hashable) -> int:
        try:
            return self._slot_index[stream_id]
        except KeyError:
            raise KeyError(f"stream {stream_id!r} not admitted") from None

    def admit(self, stream_id: Hashable, priority: float = 1.0) -> int:
        """Claim a free slot; its first frame bootstraps from the patch
        energy inside the next step(). ``priority`` weights the stream's
        share of a governed engine's budget."""
        if stream_id in self._slot_index:
            raise ValueError(f"stream {stream_id!r} already admitted")
        if priority <= 0:
            raise ValueError(f"priority must be > 0, got {priority}")
        try:
            slot = self._slots.index(None)
        except ValueError:
            raise RuntimeError(
                f"engine at capacity ({self.capacity}); evict a stream first"
            ) from None
        self._slots[slot] = stream_id
        self._slot_index[stream_id] = slot
        self._priority[stream_id] = float(priority)
        self._pending[slot] = "admit"
        self._budgets_dirty = True
        return slot

    def evict(self, stream_id: Hashable) -> None:
        slot = self.slot_of(stream_id)
        self._slots[slot] = None
        del self._slot_index[stream_id]
        self._priority.pop(stream_id, None)
        self._pending[slot] = "evict"        # last-op-wins per slot
        self._budgets_dirty = True

    def set_budget_mw(self, budget_mw: float) -> None:
        """Rewrite the engine's total power budget; the per-slot shares are
        re-split at the next flush."""
        if self.governor is None:
            raise RuntimeError("engine was built without a governor")
        if budget_mw <= 0:
            raise ValueError(f"budget_mw must be > 0, got {budget_mw}")
        self._budget_mw = float(budget_mw)
        self._budgets_dirty = True

    @property
    def budget_mw(self) -> float | None:
        """The engine-total budget being split over slots (None ungoverned)."""
        return self._budget_mw

    @staticmethod
    def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
        """A small host array on ``device`` without a host wait: through a
        page-locked copy whose block PyTorch's host allocator keeps until
        the upload has left it."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    def _flush_churn(self) -> None:
        dirty_budget = self.governor is not None and self._budgets_dirty
        if not self._pending and not dirty_budget:
            return
        admit_hit = np.zeros((self.capacity,), bool)
        evict_hit = np.zeros((self.capacity,), bool)
        for slot, op in self._pending.items():
            (admit_hit if op == "admit" else evict_hit)[slot] = True
        hits_np = np.stack([admit_hit, evict_hit])
        budgets_np = None
        if self.governor is not None:
            w = np.zeros((self.capacity,), np.float64)
            for slot, sid in enumerate(self._slots):
                if sid is not None:
                    w[slot] = self._priority[sid]
            budgets_np = np.asarray(gov_mod.allocate_budgets(
                self.governor, w, total_mw=self._budget_mw))
        for sh in self._shards:
            hits = self._upload(hits_np[:, sh.lo:sh.hi], sh.device)
            budgets = (None if budgets_np is None
                       else self._upload(budgets_np[sh.lo:sh.hi], sh.device))
            sh.state = self._churn_fn(sh.state, hits[0], hits[1], budgets)
        self._pending.clear()
        self._budgets_dirty = False

    # ---- serving -------------------------------------------------------
    @staticmethod
    def _wait_staging(st: _Staging) -> None:
        """Host wait until the staging buffer's last upload has left it: the
        one wait the serving path makes, and only when the host is a whole
        buffer cycle ahead of the card."""
        if st.event is not None:
            st.event.synchronize()

    def _issue_upload(self, st: _Staging, n_by_shard: list) -> list:
        """Per shard, the non-blocking upload of its fed rows (staged
        shard-major: one contiguous run each, slots local to the shard) and
        its slice of the fed mask, straight to the shard's device; records
        the buffer's event."""
        out, off = [], 0
        for sh, n in zip(self._shards, n_by_shard):
            out.append(tuple(t.to(sh.device, non_blocking=True)
                             for t in (st.rows[off:off + n], st.slots[off:off + n],
                                       st.fed[..., sh.lo:sh.hi])))
            off += n
        if st.event is not None:
            st.event.record()
        return out

    def _stage_rows(self, st: _Staging, ticks: list, slot_maps: list) -> list:
        """Stage the fed frames of ``ticks`` shard-major (each shard's rows
        in tick order, their slots local to the shard) and set the fed mask
        (``fed[slot]``, or ``fed[t, slot]`` for a rollout's (T, S) mask).
        Returns, per shard, its row count per tick."""
        st.fed_np[:] = False
        f = 0
        counts = []
        for sh in self._shards:
            per_tick = []
            for t, fr in enumerate(ticks):
                n = 0
                for sid, frame in fr.items():
                    slot = slot_maps[t][sid]
                    if sh.lo <= slot < sh.hi:
                        st.rows_np[f] = frame
                        st.slots_np[f] = slot - sh.lo
                        st.fed_np[(t, slot) if st.fed_np.ndim == 2 else slot] = True
                        f += 1
                        n += 1
                per_tick.append(n)
            counts.append(per_tick)
        return counts

    def step(self, frames: Mapping[Hashable, Any], block: bool = True
             ) -> "dict[Hashable, np.ndarray] | StepHandle":
        """Serve one frame for any subset of the admitted streams:
        stream id -> (H, W, 3) RGB in, stream id -> (n_classes,) logits out
        for exactly the fed streams. Unknown stream ids raise.

        The fed rows are staged in page-locked memory and uploaded with a
        non-blocking copy. With ``block=False`` the call returns a
        :class:`StepHandle` once the tick is issued, before the card has
        run it; an empty ``frames`` issues nothing."""
        if not frames:
            return {} if block else StepHandle(None, {})
        unknown = set(frames) - self._slot_index.keys()
        if unknown:
            raise ValueError(f"frames for streams never admitted: "
                             f"unknown={sorted(map(str, unknown))}")
        st = self._stages[self._stage_next]
        self._wait_staging(st)
        slots_by_sid = {sid: self._slot_index[sid] for sid in frames}
        counts = self._stage_rows(st, [frames], [slots_by_sid])
        self._stage_next ^= 1
        self._flush_churn()
        with torch.inference_mode():
            ups = self._issue_upload(st, [c[0] for c in counts])
            logits = []
            for sh, (rows, slots, fed) in zip(self._shards, ups):
                sh.frames.index_copy_(0, slots, rows)
                lg, sh.state = self._step_fn(sh.params, sh.frames, fed, sh.state)
                logits.append(lg)
        handle = StepHandle(logits[0] if len(logits) == 1 else logits, slots_by_sid)
        return handle.result() if block else handle

    def step_rollout(self, frames_by_tick, block: bool = True
                     ) -> "list[dict[Hashable, np.ndarray]] | RolloutHandle":
        """Serve T ticks with no host round-trip between them.

        ``frames_by_tick`` is a sequence of T dicts, each what :meth:`step`
        takes (an empty dict is an all-hold tick). Logits and the final
        state are bitwise those of T ``step()`` calls. The cohort is fixed
        for the rollout: pending churn is flushed before it, and admits or
        evicts made later apply to the next call. The T ticks' fed rows are
        staged compactly in page-locked memory kept per T and uploaded in
        one non-blocking copy; each tick's rows are scattered into the
        frame buffer inside the loop.

        Returns a list of T dicts, or with ``block=False`` a
        :class:`RolloutHandle` that fetches all T ticks in one transfer."""
        ticks = list(frames_by_tick)
        t_len = len(ticks)
        if t_len == 0:
            return [] if block else RolloutHandle(None, [])
        slot_maps: list[dict[Hashable, int]] = []
        for t, fr in enumerate(ticks):
            unknown = set(fr) - self._slot_index.keys()
            if unknown:
                raise ValueError(f"tick {t}: frames for streams never admitted: "
                                 f"unknown={sorted(map(str, unknown))}")
            slot_maps.append({sid: self._slot_index[sid] for sid in fr})
        self._flush_churn()
        st = self._roll_stage.get(t_len)
        if st is None:
            st = _new_staging(t_len * self.capacity, (t_len, self.capacity),
                              self._frame_shape, self.device)
            self._roll_stage[t_len] = st
        self._wait_staging(st)
        shard_counts = self._stage_rows(st, ticks, slot_maps)
        with torch.inference_mode():
            ups = self._issue_upload(st, [sum(c) for c in shard_counts])
            logits = []
            for sh, counts, (rows, slots, fed_seq) in zip(self._shards, shard_counts, ups):
                lg, sh.state = self._rollout_fn(sh.params, sh.frames, rows, slots, fed_seq,
                                                counts, sh.state)
                logits.append(lg)
        handle = RolloutHandle(logits[0] if len(logits) == 1 else logits, slot_maps)
        return handle.result() if block else handle

    def _served_slot(self, stream_id: Hashable) -> int:
        slot = self.slot_of(stream_id)
        if int(self.state.frame_age[slot]) == 0:
            raise RuntimeError(f"stream {stream_id!r} has not served a frame yet")
        return slot

    def recompute_fraction(self, stream_id: Hashable) -> float:
        """Fraction of the stream's served tokens (its tier's k_eff when
        governed) re-projected and converted on its last frame."""
        if not self.temporal:
            raise RuntimeError("engine was built without temporal=True")
        slot = self._served_slot(stream_id)
        denom = (self.k_tier(stream_id) if self.governor is not None
                 else self.cfg.frontend.n_active)
        return float(self.state.cache.n_stale[slot]) / denom

    def _controls(self, stream_id: Hashable) -> tuple[gov_mod.GovernorControls, int]:
        if self.governor is None:
            raise RuntimeError("engine was built without a governor")
        return self.state.controls, self.slot_of(stream_id)

    def recompute_cap(self, stream_id: Hashable) -> int:
        """The governor's current per-frame recompute allocation."""
        c, slot = self._controls(stream_id)
        return int(c.j_cap[slot])

    def k_tier(self, stream_id: Hashable) -> int:
        """The governor's current token count (k_eff of the stream's tier)."""
        c, slot = self._controls(stream_id)
        tokens = self.governor.tier_tokens(self.cfg.frontend.n_active)
        return tokens[min(int(c.tier[slot]), len(tokens) - 1)]

    def sign_readout(self, stream_id: Hashable) -> bool:
        """True while the governor holds the stream in the sign tier."""
        c, slot = self._controls(stream_id)
        return bool(self.governor.sign_tier and int(c.tier[slot]) >= len(self.governor.k_tiers))

    def backend_eps(self, stream_id: Hashable) -> float:
        """The governor's current backend snap budget (0.0 = exact reuse)."""
        c, slot = self._controls(stream_id)
        if not self.backend:
            raise RuntimeError("engine was built without backend_delta=True")
        return float(c.eps[slot])

    def backend_cached(self, stream_id: Hashable) -> bool:
        """True when the stream's last frame was served wholly from its
        backend cache (zero backend MACs)."""
        if not self.backend:
            raise RuntimeError("engine was built without backend_delta=True")
        slot = self._served_slot(stream_id)
        return float(self.state.events_last.backend_macs[slot]) == 0.0

    # ---- energy metering -----------------------------------------------
    def _fetch_meters(self, window: str) -> tuple[EventCounts, np.ndarray]:
        """ONE device->host fetch of (meter counts, frame ages)."""
        st = self.state
        src = st.events_last if window == "last" else st.events_mean
        host = torch.stack([*src, st.frame_age.to(torch.float32)]).cpu().numpy()
        return EventCounts(*host[:-1]), host[-1].astype(np.int64)

    def events(self, stream_id: Hashable, window: str = "last") -> EventCounts:
        """Executed energy events: the last served frame, the per-frame
        mean since admit, or the total (mean × frames, float64)."""
        if window not in ("last", "mean", "total"):
            raise ValueError(f"window must be 'last', 'mean' or 'total', got {window!r}")
        slot = self.slot_of(stream_id)
        host, ages = self._fetch_meters("last" if window == "last" else "mean")
        ev = EventCounts(*(float(e[slot]) for e in host))
        if window == "total":
            return ev.scale(float(ages[slot]))
        return ev

    def power_mw(self, stream_id: Hashable, window: str = "last") -> float:
        """Measured frontend power of this stream in mW."""
        if window not in ("last", "mean"):
            raise ValueError(f"window must be 'last' or 'mean', got {window!r}")
        slot = self.slot_of(stream_id)
        host, ages = self._fetch_meters(window)
        if window == "mean" and ages[slot] == 0:
            raise RuntimeError(f"stream {stream_id!r} has not served a frame yet")
        return float(self.meter.power_mw(
            EventCounts(*(float(e[slot]) for e in host)), self.frame_hz))

    def fleet_power_mw(self, window: str = "last") -> float:
        """Measured frontend power summed over the admitted, served streams."""
        if window not in ("last", "mean"):
            raise ValueError(f"window must be 'last' or 'mean', got {window!r}")
        host, ages = self._fetch_meters(window)
        served = np.array([s is not None for s in self._slots]) & (ages > 0)
        per_slot = np.asarray(self.meter.power_mw(host, self.frame_hz))
        return float(np.where(served, per_slot, 0.0).sum())

    def energy_report(self, stream_id: Hashable) -> dict:
        """Per-component joules the stream has spent since admit."""
        return self.meter.energy_j(self.events(stream_id, "total"), self.frame_hz)

    def gaze(self, stream_id: Hashable) -> np.ndarray:
        """The (k,) patch indices this stream will convert next frame;
        undefined (raises) before its first frame."""
        slot = self.slot_of(stream_id)
        st = self.state
        if int(st.frame_age[slot]) == 0:
            raise RuntimeError(
                f"stream {stream_id!r} has not served a frame yet; its first "
                f"gaze is the in-step energy bootstrap of the next step()")
        return st.indices[slot].cpu().numpy()
