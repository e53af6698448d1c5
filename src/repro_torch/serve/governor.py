"""Closed-loop power governor of the saccade engine.

Given a chip budget in mW, it steers each slot's per-frame recompute cap
``j_cap`` (truncating the temporal gate's needed set) and its token tier
``k_eff`` (shedding the lowest-ranked selection slots) so that the power
the meter prices from executed events tracks the budget. Both knobs are
data, so governing changes no shape.

Per slot and frame (:func:`control_update`): the feedforward target is
``floor((budget - fixed(k_eff)) / slot_mw)`` clipped to ``[floor, j_max]``;
the cap moves toward it by at most ``slew`` and holds inside the deadband;
the tier is the largest with ``k_eff <= j_cap · refresh_horizon``, moving
one step per frame (up only with the ``1 - deadband`` margin); the backend
snap budget ``eps`` engages when the budget cannot fund the frontend floor
plus the dense backend. With ``sign_tier`` one more rung sits below the k
ladder: a slot whose budget cannot cover the finest tier's floor serves
the sign view of its codes (the finest tier's token count, conversions
priced as sign comparisons). Budget shares are split over the admitted
streams on the host (:func:`allocate_budgets`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._arith import const_vector, div, to_int32
from repro_torch._device import resolve_device
from repro_torch.core.power import EnergyMeter, EventCounts, frontend_frame_events


@dataclasses.dataclass(frozen=True)
class GovernorSpec:
    """budget_mw: chip budget of the fleet's frontends, split over streams;
    floor: minimum recompute slots per stream per frame; deadband: hold
    band as a fraction of the budget; slew: max cap move per frame;
    k_tiers: token tiers as fractions of k, best first (tier 0 is 1.0);
    refresh_horizon: bound on served-token staleness; sign_tier: the
    ADC-less tier (index ``len(k_tiers)``) below the k ladder; backend_eps: the
    delta-gated backend's engaged snap budget (0.0 disables the knob)."""

    budget_mw: float
    floor: int = 1
    deadband: float = 0.05
    slew: int = 2
    k_tiers: tuple[float, ...] = (1.0, 0.75, 0.5, 0.25)
    refresh_horizon: int = 8
    sign_tier: bool = False
    backend_eps: float = 0.0

    def __post_init__(self):
        if self.budget_mw <= 0:
            raise ValueError(f"budget_mw must be > 0, got {self.budget_mw}")
        if self.backend_eps < 0:
            raise ValueError(f"backend_eps must be >= 0 (0 disables the backend "
                             f"knob), got {self.backend_eps}")
        if self.floor < 1:
            raise ValueError(f"floor must be >= 1, got {self.floor}")
        if self.k_tiers[0] != 1.0:
            raise ValueError(f"k_tiers[0] must be 1.0 (the ungoverned tier), "
                             f"got {self.k_tiers}")
        if list(self.k_tiers) != sorted(self.k_tiers, reverse=True):
            raise ValueError(f"k_tiers must be descending, got {self.k_tiers}")

    def tier_tokens(self, k: int) -> tuple[int, ...]:
        """The k_eff value of each tier for a k-token selection."""
        return tuple(max(1, int(round(t * k))) for t in self.k_tiers)


class GovernorControls(NamedTuple):
    """Per-slot governor state, slot-major; all data."""

    j_cap: torch.Tensor      # (S,) int32 — recompute slots allowed per frame
    tier: torch.Tensor       # (S,) int32 — index into GovernorSpec.k_tiers
    budget_mw: torch.Tensor  # (S,) float32 — host-allocated budget share
    eps: torch.Tensor        # (S,) float32 — backend snap budget (0 = exact)


def init_controls(capacity: int, j_max: int, device=None) -> GovernorControls:
    """Fresh slots start ungoverned (cap j_max, tier 0, exact backend) and
    unbudgeted, on ``device`` (the GPU by default)."""
    device = resolve_device(device)
    return GovernorControls(
        j_cap=torch.full((capacity,), j_max, dtype=torch.int32, device=device),
        tier=torch.zeros((capacity,), dtype=torch.int32, device=device),
        budget_mw=torch.zeros((capacity,), dtype=torch.float32, device=device),
        eps=torch.zeros((capacity,), dtype=torch.float32, device=device),
    )


def reset_rows(controls: GovernorControls, hit: torch.Tensor, j_max: int) -> GovernorControls:
    """Admit-time reset of the ``hit`` (S,) rows to the ungoverned defaults."""
    return GovernorControls(
        j_cap=torch.where(hit, torch.full_like(controls.j_cap, j_max), controls.j_cap),
        tier=torch.where(hit, torch.zeros_like(controls.tier), controls.tier),
        budget_mw=torch.where(hit, torch.zeros_like(controls.budget_mw), controls.budget_mw),
        eps=torch.where(hit, torch.zeros_like(controls.eps), controls.eps),
    )


def tier_k_eff(spec: GovernorSpec, tier: torch.Tensor, k: int) -> torch.Tensor:
    """(S,) tier indices -> (S,) int32 k_eff token counts; the sign tier
    keeps the finest k tier's count."""
    tokens = const_vector(spec.tier_tokens(k), torch.int32, tier.device)
    return tokens[torch.clamp_max(tier, len(spec.k_tiers) - 1).long()]


def tier_is_sign(spec: GovernorSpec, tier: torch.Tensor) -> torch.Tensor:
    """(S,) bool — slots in the ADC-less sign tier (never, without one)."""
    if not spec.sign_tier:
        return torch.zeros_like(tier, dtype=torch.bool)
    return tier >= len(spec.k_tiers)


def fixed_power_mw(spec_meter: EnergyMeter, n_pixels: float, pixels_per_patch: int,
                   n_vectors: int, k_eff: torch.Tensor, frame_hz: float) -> torch.Tensor:
    """Per-frame power that gating cannot avoid at a token tier (CDS, the
    DAC broadcast, the deselected-patch dumps): the metered events of a
    frame with ``k_eff`` selected and none converted."""
    sel = k_eff.to(torch.float32)
    ev = frontend_frame_events(n_pixels, pixels_per_patch, n_vectors,
                               n_selected_patches=sel,
                               n_converted_patches=torch.zeros_like(sel))
    return spec_meter.power_mw(ev, frame_hz)


def control_update(spec: GovernorSpec, controls: GovernorControls,
                   events_last: EventCounts, active: torch.Tensor,
                   meter: EnergyMeter, frame_hz: float, n_pixels: float,
                   pixels_per_patch: int, n_vectors: int, j_max: int, k: int,
                   backend_mw: float = 0.0) -> GovernorControls:
    """One governor tick from this frame's executed events (inactive slots
    zeroed); the new controls apply from the next frame. ``backend_mw`` is
    the dense backend's per-slot power, the plant model of the eps knob."""
    slot_mw = 1e3 * meter.slot_recompute_power_w(pixels_per_patch, n_vectors, frame_hz)
    measured = meter.power_mw(events_last, frame_hz)
    budget = controls.budget_mw

    # 1. feedforward affordable allocation at the current tier; a true
    # division, as the reference's (PyTorch on CUDA would multiply by the
    # reciprocal and could move the floor by one), and JAX's saturating
    # cast (a budget of 1e8 mW affords more than 2**31 rows)
    k_eff_now = tier_k_eff(spec, controls.tier, k)
    fixed = fixed_power_mw(meter, n_pixels, pixels_per_patch, n_vectors, k_eff_now,
                           frame_hz)
    afford = to_int32(torch.floor(div(budget - fixed, slot_mw)))
    target = torch.clamp(afford, spec.floor, j_max)

    # 2. slew-limited move with a deadband hold
    err = measured - budget
    hold = (torch.abs(err) <= spec.deadband * budget) & (controls.j_cap <= target)
    step = torch.clamp(target - controls.j_cap, -spec.slew, spec.slew)
    j_new = torch.clamp(torch.where(hold, controls.j_cap, controls.j_cap + step),
                        spec.floor, j_max).to(torch.int32)

    # 3. token tier: the first tier refreshable within the horizon; one
    # step per frame; up only with the (1 - deadband) margin
    tiers = const_vector(spec.tier_tokens(k), torch.int32, j_new.device)
    room = (j_new * spec.refresh_horizon)[:, None]
    fits = tiers[None, :] <= room
    fits[:, -1].fill_(True)               # the last tier is always available
    t_target = torch.argmax(fits.to(torch.int32), dim=-1).to(torch.int32)
    fits_up = tiers[None, :] <= room.to(torch.float32) * (1.0 - spec.deadband)
    fits_up[:, -1].fill_(True)
    t_up = torch.argmax(fits_up.to(torch.int32), dim=-1).to(torch.int32)

    # 3b. the sign tier, one rung below the k ladder: entered when the
    # budget cannot cover the finest k tier's floor (its fixed power plus
    # `floor` recompute slots), left only with the (1 - deadband) margin
    if spec.sign_tier:
        n_kt = len(spec.k_tiers)
        k_min = torch.full_like(j_new, spec.tier_tokens(k)[-1])
        fixed_min = fixed_power_mw(meter, n_pixels, pixels_per_patch, n_vectors, k_min,
                                   frame_hz)
        floor_mw = fixed_min + spec.floor * slot_mw
        want_sign = budget < floor_mw
        recover_ok = budget * (1.0 - spec.deadband) >= floor_mw
        t_target = torch.where(want_sign, torch.full_like(t_target, n_kt), t_target)
        t_up = torch.where(recover_ok, t_up, torch.full_like(t_up, n_kt))
    t_cur = controls.tier
    t_new = torch.where(t_target > t_cur, t_cur + 1,
                        torch.where(t_up < t_cur, t_cur - 1, t_cur)).to(torch.int32)

    # 3c. backend eps: engage when the budget cannot fund the frontend
    # floor plus the dense backend, recover with the (1 - deadband) margin
    eps_new = controls.eps
    if spec.backend_eps > 0.0:
        floor_sys = fixed + spec.floor * slot_mw + backend_mw
        want_eps = budget < floor_sys
        recover_eps = budget * (1.0 - spec.deadband) >= floor_sys
        eps_new = torch.where(
            want_eps, torch.full_like(controls.eps, spec.backend_eps),
            torch.where(recover_eps, torch.zeros_like(controls.eps), controls.eps))

    return GovernorControls(
        j_cap=torch.where(active, j_new, controls.j_cap),
        tier=torch.where(active, t_new, controls.tier),
        budget_mw=budget,
        eps=torch.where(active, eps_new, controls.eps),
    )


def allocate_budgets(spec: GovernorSpec, slot_priority: np.ndarray,
                     total_mw: float | None = None) -> np.ndarray:
    """Host-side split of the budget (``total_mw`` or ``spec.budget_mw``)
    over the slots in proportion to ``slot_priority`` (0 on free slots);
    (S,) float32."""
    w = np.asarray(slot_priority, np.float64)
    total = w.sum()
    if total <= 0:
        return np.zeros_like(w, dtype=np.float32)
    pool = spec.budget_mw if total_mw is None else float(total_mw)
    return (pool * w / total).astype(np.float32)
