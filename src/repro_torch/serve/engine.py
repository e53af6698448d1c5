"""Multi-stream saccadic serving engine, plain mode.

The engine owns ``capacity`` fixed slots; every device tensor is
slot-major with a static leading axis, so one batched step serves any mix
of streams:

* ``admit`` / ``evict`` only record host bookkeeping; all pending row
  writes coalesce, last op per slot wins, into ONE flush right before the
  next step or state read.
* ``step(frames)`` takes any subset of the admitted streams. Un-fed slots
  hold: their gaze, frame age and meters pass through unchanged and their
  logits are zero; fed slots are served exactly as in a full-cover step.
* Frames live in a persistent device buffer (S, H, W, 3); each tick
  uploads only the fed rows and writes them into it in place.
* Freshly admitted slots bootstrap their first gaze from the in-pixel
  patch energy inside the step; later frames take the top k of the
  saccade scores (optionally EMA-smoothed).
* Each slot meters the energy events its frontend executed (last frame
  and running mean since admit), priced at read time by an EnergyMeter.
"""

from __future__ import annotations

from typing import Any, Hashable, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.convert import tree_to
from repro_torch.core import frontend as fe
from repro_torch.core import saliency as sal
from repro_torch.core.power import EnergyMeter, EventCounts
from repro_torch.models.vit import vit_forward_compact
from repro_torch.serve.serve_step import saccade_scores


class StreamState(NamedTuple):
    """Per-slot gaze state; every leaf is slot-major with static shape."""

    indices: torch.Tensor    # (S, k) int32 — next frame's patch selection
    ema: torch.Tensor        # (S, P) float32 — attention-score EMA
    frame_age: torch.Tensor  # (S,) int32 — frames served since admit (0 = bootstrap)
    active: torch.Tensor     # (S,) bool — slot occupied
    events_last: EventCounts = EventCounts()   # (S,) leaves — last frame
    events_mean: EventCounts = EventCounts()   # (S,) leaves — mean/frame


def _zero_events(capacity: int, device) -> EventCounts:
    return EventCounts(*(torch.zeros((capacity,), dtype=torch.float32, device=device)
                         for _ in EventCounts._fields))


def init_stream_state(cfg, capacity: int, device) -> StreamState:
    """All slots free; indices are a placeholder (age 0 bootstraps in-step)."""
    k = cfg.frontend.n_active
    p = cfg.frontend.n_patches
    return StreamState(
        indices=torch.arange(k, dtype=torch.int32, device=device).repeat(capacity, 1),
        ema=torch.zeros((capacity, p), dtype=torch.float32, device=device),
        frame_age=torch.zeros((capacity,), dtype=torch.int32, device=device),
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        events_last=_zero_events(capacity, device),
        events_mean=_zero_events(capacity, device),
    )


def make_engine_step(cfg, explore: float = 0.1, ema_decay: float = 0.0,
                     project_fn=None):
    """Batched slot step (params, frames (S,H,W,3), fed (S,) bool, state)
    -> (logits (S, n_classes), state): per slot one saccade frame, plus the
    in-step bootstrap at age 0, EMA blending of the scores, and holds for
    inactive or un-fed slots."""
    fcfg = cfg.frontend
    k = fcfg.n_active

    def step(params, frames, fed, state: StreamState):
        act = state.active & fed
        patches, weights = fe.sensor_patches(params["ip2"], frames, fcfg)
        boot = sal.topk_patch_indices(sal.patch_energy(patches), k)
        fresh = state.frame_age == 0
        indices = torch.where(fresh[:, None], boot, state.indices)
        logits, aux = vit_forward_compact(
            params, frames, cfg, indices=indices, project_fn=project_fn,
            precomputed=(patches, weights))
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
        new_state = StreamState(
            indices=torch.where(act[:, None], next_idx, state.indices),
            ema=torch.where(act[:, None], ema, state.ema),
            frame_age=torch.where(act, state.frame_age + 1, state.frame_age),
            active=state.active,
            events_last=ev_last,
            events_mean=ev_mean,
        )
        logits = torch.where(act[:, None], logits, torch.zeros_like(logits))
        return logits, new_state

    return step


def _make_churn(k: int):
    """ONE coalesced churn flush: ``admit_hit`` rows are fully reset,
    ``evict_hit`` rows only drop the active flag."""

    def churn(state: StreamState, admit_hit, evict_hit) -> StreamState:
        hit = admit_hit
        zero = torch.zeros((), dtype=torch.float32, device=hit.device)
        return StreamState(
            indices=torch.where(hit[:, None],
                                torch.arange(k, dtype=torch.int32, device=hit.device)[None],
                                state.indices),
            ema=torch.where(hit[:, None], zero, state.ema),
            frame_age=torch.where(hit, torch.zeros_like(state.frame_age), state.frame_age),
            active=(state.active & ~evict_hit) | hit,
            events_last=EventCounts(*(torch.where(hit, zero, e) for e in state.events_last)),
            events_mean=EventCounts(*(torch.where(hit, zero, e) for e in state.events_mean)),
        )

    return churn


class SaccadeEngine:
    """Slot-based multi-stream saccadic server.

    Args:
      cfg: ViTConfig of the backend (``quant_embed`` / ``fused_embed``
        select the kernel routes).
      params: model parameters (moved to ``device``).
      capacity: number of slots.
      explore / project_fn: as in ``serve_step.make_saccade_step``; pass
        ``ops.ip2_codes_fn(spec, adc)`` for the staged kernel route.
      ema_decay: attention-EMA smoothing; 0.0 = per-frame scores.
      meter / frame_hz: the EnergyMeter pricing the per-slot meters.
      device: where the engine runs; None means the GPU (raises without one).
    """

    def __init__(self, cfg, params, capacity: int = 8, *, explore: float = 0.1,
                 ema_decay: float = 0.0, project_fn=None,
                 meter: EnergyMeter = EnergyMeter(), frame_hz: float = 30.0,
                 device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = tree_to(params, self.device)
        self.capacity = capacity
        self.meter = meter
        self.frame_hz = frame_hz
        self._slots: list[Hashable | None] = [None] * capacity
        self._slot_index: dict[Hashable, int] = {}
        # slot -> "admit" | "evict", last op wins; flushed before the next
        # step or state read
        self._pending: dict[int, str] = {}
        fcfg = cfg.frontend
        self._stage = np.zeros((capacity, fcfg.image_h, fcfg.image_w, 3), np.float32)
        self._stage_slots = np.zeros((capacity,), np.int64)
        self._fed = np.zeros((capacity,), bool)
        self._step_fn = make_engine_step(cfg, explore=explore, ema_decay=ema_decay,
                                         project_fn=project_fn)
        self._churn_fn = _make_churn(fcfg.n_active)
        self._state = init_stream_state(cfg, capacity, self.device)
        self._frames_dev = torch.zeros((capacity, fcfg.image_h, fcfg.image_w, 3),
                                       dtype=torch.float32, device=self.device)

    # ---- host-side slot bookkeeping ------------------------------------
    @property
    def state(self) -> StreamState:
        """Device state with any pending churn flushed first."""
        self._flush_churn()
        return self._state

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

    def admit(self, stream_id: Hashable) -> int:
        """Claim a free slot; its first frame bootstraps from the patch
        energy inside the next step()."""
        if stream_id in self._slot_index:
            raise ValueError(f"stream {stream_id!r} already admitted")
        try:
            slot = self._slots.index(None)
        except ValueError:
            raise RuntimeError(
                f"engine at capacity ({self.capacity}); evict a stream first"
            ) from None
        self._slots[slot] = stream_id
        self._slot_index[stream_id] = slot
        self._pending[slot] = "admit"
        return slot

    def evict(self, stream_id: Hashable) -> None:
        slot = self.slot_of(stream_id)
        self._slots[slot] = None
        del self._slot_index[stream_id]
        self._pending[slot] = "evict"        # last-op-wins per slot

    def _flush_churn(self) -> None:
        if not self._pending:
            return
        admit_hit = np.zeros((self.capacity,), bool)
        evict_hit = np.zeros((self.capacity,), bool)
        for slot, op in self._pending.items():
            (admit_hit if op == "admit" else evict_hit)[slot] = True
        hits = torch.from_numpy(np.stack([admit_hit, evict_hit])).to(self.device)
        self._state = self._churn_fn(self._state, hits[0], hits[1])
        self._pending.clear()

    # ---- serving -------------------------------------------------------
    def step(self, frames: Mapping[Hashable, Any]) -> dict[Hashable, np.ndarray]:
        """Serve one frame for any subset of the admitted streams:
        stream id -> (H, W, 3) RGB in, stream id -> (n_classes,) logits out
        for exactly the fed streams. Unknown stream ids raise."""
        if not frames:
            return {}
        fed = self._fed
        fed[:] = False
        slots_by_sid: dict[Hashable, int] = {}
        for f, (sid, frame) in enumerate(frames.items()):
            if sid not in self._slot_index:
                unknown = set(frames) - self._slot_index.keys()
                raise ValueError(f"frames for streams never admitted: "
                                 f"unknown={sorted(map(str, unknown))}")
            slot = self._slot_index[sid]
            self._stage[f] = frame
            self._stage_slots[f] = slot
            fed[slot] = True
            slots_by_sid[sid] = slot
        self._flush_churn()
        n = len(slots_by_sid)
        with torch.inference_mode():
            rows = torch.from_numpy(self._stage[:n]).to(self.device)
            slots = torch.from_numpy(self._stage_slots[:n]).to(self.device)
            self._frames_dev.index_copy_(0, slots, rows)
            fed_dev = torch.from_numpy(fed.copy()).to(self.device)
            logits, self._state = self._step_fn(self.params, self._frames_dev,
                                                fed_dev, self._state)
            host = logits.cpu().numpy()
        return {sid: host[s] for sid, s in slots_by_sid.items()}

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
