"""Multi-host fleet coordinator over per-host serving engines.

One :class:`~repro_torch.serve.engine.SaccadeEngine` serves one host's
slots; a deployment of many cameras runs many hosts, each with its own
engine. This module is the thin, host-side layer on top:

* **Per-host engines.** Each host owns a ``SaccadeEngine`` on its own
  device (``devices=``; by default every engine is on the GPU). Engines
  never talk to each other: streams are independent, so fleet scaling is
  pure horizontal slot capacity.

* **Per-host admit queues with priority classes.** ``submit(sid,
  priority_class=...)`` enqueues a stream on the least-loaded host;
  ``drain()`` (implicit in every ``step``) admits queued streams into free
  slots highest class first (FIFO within a class), so when churn outruns
  capacity, realtime streams never wait behind background ones. The class
  weight doubles as the stream's governor priority.

* **Budget hierarchy fleet -> host -> slot.** A governed fleet splits the
  fleet-level mW budget over hosts with the same proportional law the
  engine uses over slots (``governor.allocate_budgets`` with ``total_mw=``):
  host weight = the priority mass its admitted streams carry; each engine
  then re-splits its host share over its slots. Rebalancing happens on
  churn only.

* **Dispatch before fetch.** ``fleet.step(frames)`` takes any subset of the
  admitted streams, routes each frame to its host, and steps only the
  engines with fed slots: an idle host costs nothing. Every fed engine is
  dispatched with ``engine.step(..., block=False)`` before any result is
  fetched, so no host's fetch waits in front of another host's dispatch;
  ``block=False`` hands the caller the same split. All engines issue to
  the current CUDA stream: the contract is on the host side.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Hashable, Mapping

import numpy as np
import torch

from repro_torch.launch.mesh import LocalMesh
from repro_torch.serve import governor as gov_mod
from repro_torch.serve.engine import SaccadeEngine

# Default priority classes: weight = share of a governed budget, and the
# admit-queue rank. A few latency-critical streams over a sea of
# best-effort ones.
PRIORITY_CLASSES: dict[str, float] = {
    "realtime": 4.0,
    "interactive": 2.0,
    "standard": 1.0,
    "background": 0.25,
}


def make_fleet_meshes(n_hosts: int, axis: str = "data", devices=None) -> list:
    """Partition the devices into ``n_hosts`` contiguous per-host meshes
    (``LocalMesh``es, 1-D, named ``axis``): the stand-in for one process per
    host, each seeing only its local devices. ``devices`` defaults to every
    visible CUDA device (raises without CUDA); tests pass CPU entries, and
    one card may appear several times. ``n_hosts`` must divide the device
    count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=[...] "
                               "to build the meshes over other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    if len(devs) % n_hosts != 0:
        raise ValueError(f"{len(devs)} devices do not split over {n_hosts} hosts")
    per = len(devs) // n_hosts
    return [LocalMesh(devs[h * per:(h + 1) * per], (axis,)) for h in range(n_hosts)]


class FleetHandle:
    """Merged non-blocking fleet result: wraps the fed hosts'
    :class:`~repro_torch.serve.engine.StepHandle`\\ s (one tick) or
    :class:`~repro_torch.serve.engine.RolloutHandle`\\ s (a rollout) and
    merges them at fetch time. ``result()`` fetches host by host; by then
    every host's work was already issued. Idempotent, with the per-engine
    handles' lifetime."""

    __slots__ = ("_handles", "_n_ticks", "_out")

    def __init__(self, handles: list, n_ticks: int | None = None):
        self._handles = handles
        self._n_ticks = n_ticks          # None: single tick -> one dict
        self._out = None

    def result(self):
        if self._out is None:
            if self._n_ticks is None:
                out: Any = {}
                for h in self._handles:
                    out.update(h.result())
            else:
                out = [{} for _ in range(self._n_ticks)]
                for h in self._handles:
                    for t, d in enumerate(h.result()):
                        out[t].update(d)
            self._out = out
            self._handles = []
        return self._out


@dataclasses.dataclass
class _Queued:
    """One waiting admit request."""
    stream_id: Hashable
    weight: float
    seq: int            # FIFO tiebreak within a class


class SaccadeFleet:
    """Fleet of per-host :class:`SaccadeEngine`\\ s behind one API.

    Args:
      cfg / params: as for the engine (params are shared; each engine moves
        them to its device).
      n_hosts: number of per-host engines.
      capacity: slots per host (fleet capacity = n_hosts * capacity).
      devices: optional list of n_hosts devices, one per host engine; None
        puts every engine on the GPU (raises without one).
      meshes: optional list of n_hosts ``LocalMesh``es
        (:func:`make_fleet_meshes`), one per host engine, each sharding its
        engine's slots; excludes ``devices``.
      governor: a fleet-level ``GovernorSpec``; its ``budget_mw`` is the
        fleet budget, split over hosts by admitted priority mass and
        re-split over slots inside each engine.
      priority_classes: name -> weight map (default :data:`PRIORITY_CLASSES`).
      engine_kw: forwarded to every engine (temporal, meter, frame_hz,
        explore, project_fn, backend_delta, ...).
    """

    def __init__(self, cfg, params, *, n_hosts: int = 1, capacity: int = 8,
                 devices=None, meshes=None,
                 governor: gov_mod.GovernorSpec | None = None,
                 priority_classes: Mapping[str, float] | None = None,
                 **engine_kw):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        if devices is not None and len(devices) != n_hosts:
            raise ValueError(f"got {len(devices)} devices for {n_hosts} hosts")
        if meshes is not None and len(meshes) != n_hosts:
            raise ValueError(f"got {len(meshes)} meshes for {n_hosts} hosts")
        if meshes is not None and devices is not None:
            raise ValueError("pass meshes or devices, not both")
        self.governor = governor
        self.classes = dict(priority_classes or PRIORITY_CLASSES)
        if any(w <= 0 for w in self.classes.values()):
            raise ValueError(f"class weights must be > 0: {self.classes}")
        self.engines: list[SaccadeEngine] = [
            SaccadeEngine(cfg, params, capacity=capacity,
                          device=None if devices is None else devices[h],
                          mesh=None if meshes is None else meshes[h],
                          governor=governor, **engine_kw)
            for h in range(n_hosts)
        ]
        self._queues: list[list[_Queued]] = [[] for _ in range(n_hosts)]
        self._host_of: dict[Hashable, int] = {}
        self._queued_ids: set[Hashable] = set()
        self._seq = 0

    # ---- fleet shape ---------------------------------------------------
    @property
    def n_hosts(self) -> int:
        return len(self.engines)

    @property
    def capacity(self) -> int:
        return sum(e.capacity for e in self.engines)

    @property
    def stream_ids(self) -> list[Hashable]:
        return [sid for e in self.engines for sid in e.stream_ids]

    @property
    def free_slots(self) -> int:
        return sum(e.free_slots for e in self.engines)

    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues)

    def host_of(self, stream_id: Hashable) -> int:
        try:
            return self._host_of[stream_id]
        except KeyError:
            raise KeyError(f"stream {stream_id!r} not admitted") from None

    # ---- admission -----------------------------------------------------
    def submit(self, stream_id: Hashable, priority_class: str = "standard") -> int:
        """Enqueue a stream on the least-loaded host's admit queue; it is
        admitted (highest class first) by the next ``drain``/``step``.
        Returns the chosen host index."""
        if stream_id in self._host_of or stream_id in self._queued_ids:
            raise ValueError(f"stream {stream_id!r} already submitted")
        if priority_class not in self.classes:
            raise ValueError(
                f"unknown priority class {priority_class!r}; "
                f"have {sorted(self.classes)}")
        # least-loaded: most free slots after the already-queued admits
        # (max keeps the lowest host on ties)
        host = max(range(self.n_hosts),
                   key=lambda h: self.engines[h].free_slots - len(self._queues[h]))
        self._queues[host].append(_Queued(stream_id, self.classes[priority_class], self._seq))
        self._queued_ids.add(stream_id)
        self._seq += 1
        return host

    def drain(self) -> list[Hashable]:
        """Admit queued streams into free slots, highest priority class
        first (FIFO within a class); leftover requests stay queued.
        Rebalances the fleet budget when anything changed. Returns the
        stream ids admitted this call."""
        admitted = []
        for host, q in enumerate(self._queues):
            eng = self.engines[host]
            q.sort(key=lambda r: (-r.weight, r.seq))
            while q and eng.free_slots > 0:
                r = q.pop(0)
                eng.admit(r.stream_id, priority=r.weight)
                self._host_of[r.stream_id] = host
                self._queued_ids.discard(r.stream_id)
                admitted.append(r.stream_id)
        if admitted:
            self._rebalance_budgets()
        return admitted

    def evict(self, stream_id: Hashable) -> None:
        """Evict an admitted stream (or cancel a queued one)."""
        if stream_id in self._queued_ids:
            for q in self._queues:
                q[:] = [r for r in q if r.stream_id != stream_id]
            self._queued_ids.discard(stream_id)
            return
        host = self.host_of(stream_id)
        self.engines[host].evict(stream_id)
        del self._host_of[stream_id]
        self._rebalance_budgets()

    def _rebalance_budgets(self) -> None:
        """fleet -> host: the host -> slot law again, with the fleet budget
        as the pool and each host's admitted priority mass as its weight."""
        if self.governor is None:
            return
        w = np.zeros((self.n_hosts,), np.float64)
        for h, eng in enumerate(self.engines):
            w[h] = sum(eng._priority[sid] for sid in eng.stream_ids)
        shares = gov_mod.allocate_budgets(self.governor, w, total_mw=self.governor.budget_mw)
        for eng, share in zip(self.engines, shares):
            if share > 0:
                eng.set_budget_mw(float(share))

    # ---- serving -------------------------------------------------------
    def step(self, frames: Mapping[Hashable, Any], block: bool = True
             ) -> "dict[Hashable, np.ndarray] | FleetHandle":
        """Drain the admit queues, then serve one tick: route each frame to
        its stream's host engine and step only the engines with fed slots
        (everyone else's streams hold). Every fed engine is dispatched
        before any result is fetched. ``block=True`` returns the merged
        stream id -> logits dict for exactly the fed streams;
        ``block=False`` a :class:`FleetHandle` to fetch later."""
        self.drain()
        per_host: list[dict] = [{} for _ in range(self.n_hosts)]
        for sid, frame in frames.items():
            per_host[self.host_of(sid)][sid] = frame
        handles = [eng.step(fh, block=False)
                   for eng, fh in zip(self.engines, per_host) if fh]
        handle = FleetHandle(handles)
        return handle.result() if block else handle

    def step_rollout(self, frames_by_tick, block: bool = True):
        """Serve T ticks per host, one rollout per fed host (un-fed ticks
        hold inside it); every host is dispatched before any is fetched.
        Churn drains once, at the rollout boundary. Returns a list of T
        merged per-tick dicts (or a :class:`FleetHandle` over them)."""
        self.drain()
        ticks = list(frames_by_tick)
        per_host: list[list[dict]] = [[{} for _ in ticks] for _ in range(self.n_hosts)]
        for t, fr in enumerate(ticks):
            for sid, frame in fr.items():
                per_host[self.host_of(sid)][t][sid] = frame
        handles = [eng.step_rollout(sched, block=False)
                   for eng, sched in zip(self.engines, per_host) if any(sched)]
        handle = FleetHandle(handles, n_ticks=len(ticks))
        return handle.result() if block else handle

    # ---- metering ------------------------------------------------------
    def fleet_power_mw(self, window: str = "last") -> float:
        """Measured frontend power summed over every host's admitted
        streams: the quantity the fleet budget tracks."""
        return sum(e.fleet_power_mw(window) for e in self.engines)

    def power_mw(self, stream_id: Hashable, window: str = "last") -> float:
        return self.engines[self.host_of(stream_id)].power_mw(stream_id, window)

    def events(self, stream_id: Hashable, window: str = "last"):
        return self.engines[self.host_of(stream_id)].events(stream_id, window)
