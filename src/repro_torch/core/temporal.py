"""Temporal gate configuration (paper §2.1.2 non-destructive readout).

Only :class:`TemporalSpec` is ported so far: it is a field of
``FrontendConfig`` and the engine reads ``budget(k)``. The gate itself
(feature cache, stale selection, refresh) is not ported yet.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TemporalSpec:
    """delta_threshold: energy change that marks a selected patch stale;
    recompute_budget: static patches re-projected per frame (None = k);
    droop_lsb_budget: LSBs of droop a held entry may accrue."""

    delta_threshold: float = 0.0
    recompute_budget: int | None = None
    droop_lsb_budget: float = 0.5

    def budget(self, k: int) -> int:
        j = k if self.recompute_budget is None else self.recompute_budget
        if j < 1:
            raise ValueError(f"recompute_budget must be >= 1, got {j}")
        return min(j, k)
