"""The closed-loop placement/autoscale controller.

An earlier change built the sensor: an elected aggregator folds every worker's
burn rates, queue depths, breakers, and tenant shares into ONE fleet
overview document.  This module closes the loop: an elected controller
consumes that overview each heartbeat and publishes ``plan/fleet`` — a
first-class plan document every worker's watch-fed cache serves at
admission (``FleetPlane.current_plan``):

- **Admission** (``admission.shedBulk``): when the fleet's worst SLO
  burn runs hot on BOTH windows — or the remaining error budget falls
  under the floor — BULK is shed at the admission edge *before* the
  budget exhausts, instead of after the damage (the burn-rate
  ladder, actuated).
- **Scale** (``desiredWorkers`` / ``scale``): queue-depth-driven worker
  count for external autoscalers, hysteresis'd so one bursty beat never
  flaps the fleet (also on ``fleet_desired_workers``).
- **Placement** (``drain``): workers browning out (open dependency
  breakers) are listed for drain — the content router stops deferring
  NEW work toward them, so their queues empty while they recover.

Election and fencing reuse the overview aggregator's discipline: the
plan doc's freshness is the cheap pre-check, the oldest live worker
wins the full election, and every publish is token-CAS — a lost CAS
means a concurrent controller exists and THIS one stands down (the
write token is the fence; no plan is ever clobbered).  ``epoch``
increments on takeover so a resumed stale controller's plan is
recognizably ancient.

Every decision EDGE (shed on/off, drain set changes, desired-worker
moves) is logged, counted on ``fleet_controller_decisions_total`` and
carried in the plan's ``decisions`` tail — the operator reads the whys
from ``GET /v1/fleet/plan``, not from correlating dashboards.

Failure posture: the controller is an optimizer, never a gate.  No
overview, a stale overview, or coordination trouble SKIPS the tick
(counted via the plane's coord-error accounting); workers that see no
fresh plan simply run today's uncontrolled admission.
"""

from __future__ import annotations

import asyncio
import time
from typing import List, Optional

from ..platform.config import cfg_get
from .coord import ABSENT
from .plane import PLAN_KEY

# burn-rate ceiling: shed BULK while ANY objective burns faster than
# this on BOTH windows (the page condition, acted on early)
DEFAULT_SHED_BURN = 2.0
# error-budget floor: shed BULK while ANY objective's remaining budget
# sits under this fraction (shedding BEFORE exhaustion, the design's
# acceptance shape)
DEFAULT_BUDGET_FLOOR = 0.25
# queued jobs one worker is expected to chew through: the scale signal
# is ceil(queueDepth / this), hysteresis'd
DEFAULT_TARGET_DEPTH = 8.0
DEFAULT_MAX_WORKERS = 16
# consecutive ticks a scale move must hold before the plan adopts it
# (flap damping: one bursty beat must not resize the fleet)
DEFAULT_SCALE_HOLD_TICKS = 3
# decision-edge tail carried on the plan doc (bounded: the plan stays
# a few KB; the full history is in logs/metrics)
DECISIONS_LIMIT = 16


class PlacementController:
    """The elected closed-loop controller (one active per fleet)."""

    def __init__(self, plane, *,
                 shed_burn: float = DEFAULT_SHED_BURN,
                 budget_floor: float = DEFAULT_BUDGET_FLOOR,
                 target_depth: float = DEFAULT_TARGET_DEPTH,
                 max_workers: int = DEFAULT_MAX_WORKERS,
                 scale_hold_ticks: int = DEFAULT_SCALE_HOLD_TICKS,
                 metrics=None, logger=None):
        self.plane = plane
        self.shed_burn = float(shed_burn)
        self.budget_floor = float(budget_floor)
        self.target_depth = max(float(target_depth), 1.0)
        self.max_workers = max(int(max_workers), 1)
        self.scale_hold_ticks = max(int(scale_hold_ticks), 1)
        self.metrics = metrics
        self.logger = logger
        self._task: Optional[asyncio.Task] = None
        # hysteresis: (candidate desired count, consecutive ticks held)
        self._scale_candidate: Optional[int] = None
        self._scale_held = 0
        # last adopted values, for decision-EDGE detection
        self._last_shed: Optional[bool] = None
        self._last_drain: frozenset = frozenset()
        self._last_desired: Optional[int] = None
        self._decisions: List[dict] = []
        self.ticks = 0
        self.plans_published = 0

    @classmethod
    def from_config(cls, config, plane, *, metrics=None, logger=None
                    ) -> Optional["PlacementController"]:
        """Build from ``fleet.controller.*``; None when disabled
        (``fleet.controller.enabled``, default True with a fleet) or
        there is no fleet plane to control."""
        if plane is None:
            return None
        if not bool(cfg_get(config, "fleet.controller.enabled", True)):
            return None
        return cls(
            plane,
            shed_burn=float(cfg_get(
                config, "fleet.controller.shed_burn",
                DEFAULT_SHED_BURN)),
            budget_floor=float(cfg_get(
                config, "fleet.controller.budget_floor",
                DEFAULT_BUDGET_FLOOR)),
            target_depth=float(cfg_get(
                config, "fleet.controller.target_depth",
                DEFAULT_TARGET_DEPTH)),
            max_workers=int(cfg_get(
                config, "fleet.controller.max_workers",
                DEFAULT_MAX_WORKERS)),
            scale_hold_ticks=int(cfg_get(
                config, "fleet.controller.scale_hold_ticks",
                DEFAULT_SCALE_HOLD_TICKS)),
            metrics=metrics, logger=logger,
        )

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_event_loop().create_task(
                self._loop(),
                name=f"fleet-controller-{self.plane.worker_id}")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    async def _loop(self) -> None:
        # offset from the heartbeat so a tick consumes the views the
        # beat just refreshed, not the previous generation's
        interval = self.plane.heartbeat_interval
        while True:
            await asyncio.sleep(interval)
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception as err:
                self.plane._note_coord_error("controller", err)

    # -- one control tick -----------------------------------------------
    async def tick(self) -> bool:
        """One closed-loop pass: elect, decide, CAS-publish.  Returns
        True when this worker published the plan this tick."""
        self.ticks += 1
        plane = self.plane
        # cheap election pre-check, the overview aggregator discipline:
        # a FRESH plan someone else wrote means a live controller owns
        # the loop — this worker's tick is free
        entry = await plane.coord.get(PLAN_KEY)
        doc = entry[0] if entry is not None else None
        if doc is not None and doc.get("updatedBy") != plane.worker_id:
            age = time.time() - float(doc.get("updatedAt", 0) or 0)
            if age < 2.0 * plane.heartbeat_interval:
                return False
        workers = await plane.workers()
        if not workers or workers[0].get("workerId") != plane.worker_id:
            return False  # not the oldest live worker: stand down
        overview = plane.cached_overview()
        if overview is None:
            # no fresh fleet evidence: publishing a plan would steer
            # the fleet on history.  Skip — workers degrade to
            # uncontrolled admission once the old plan ages out.
            return False
        plan = self.build_plan(overview, workers, previous=doc)
        # token-CAS publish: the write token is the fence.  A lost race
        # means a concurrent controller exists (split-brain window);
        # stand down and let the freshness pre-check re-elect.
        expect = entry[1] if entry is not None else ABSENT
        token = await plane.coord.put(PLAN_KEY, plan, expect=expect)
        if token is None:
            if self.logger is not None:
                self.logger.warn("fleet controller: plan CAS lost; "
                                 "standing down")
            return False
        self.plans_published += 1
        self._note("plan")
        if self.metrics is not None:
            self.metrics.fleet_desired_workers.set(
                plan["desiredWorkers"])
        # the publisher's own cache serves the new plan immediately
        plane._plan_doc = plan
        return True

    # -- the decision table (pure; unit-tested by hand) -----------------
    def build_plan(self, overview: dict, workers: List[dict],
                   previous: Optional[dict] = None) -> dict:
        """Fold one overview into one plan document.  Pure decision
        logic — no I/O, no clocks beyond the stamp — so the decision
        table is unit-testable against hand-computed cases."""
        totals = overview.get("totals") or {}
        now = time.time()
        # the plan epoch: unchanged while one controller keeps the
        # loop, +1 on takeover — a resumed stale controller's plan is
        # recognizably from a dead epoch
        epoch = 1
        if previous is not None:
            try:
                prev_epoch = int(previous.get("epoch", 0) or 0)
            except (TypeError, ValueError):
                prev_epoch = 0
            takeover = previous.get("updatedBy") != self.plane.worker_id
            epoch = max(prev_epoch + (1 if takeover else 0), 1)

        shed, shed_reason = self._admission_decision(totals)
        drain = self._drain_decision(totals, workers)
        desired, scale = self._scale_decision(totals, workers)

        # decision EDGES -> the bounded tail + metrics + logs
        if shed != self._last_shed:
            self._record_decision(
                "shed_bulk" if shed else "shed_clear",
                shed_reason if shed else "pressure cleared", now)
            self._last_shed = shed
        drain_set = frozenset(drain)
        if drain_set != self._last_drain:
            self._record_decision(
                "drain", ",".join(sorted(drain)) or "none", now)
            self._last_drain = drain_set
        if desired != self._last_desired:
            if self._last_desired is not None:
                self._record_decision(
                    "scale_up" if desired > self._last_desired
                    else "scale_down",
                    f"desired {self._last_desired} -> {desired}", now)
            self._last_desired = desired

        return {
            "updatedAt": round(now, 3),
            "updatedBy": self.plane.worker_id,
            "epoch": epoch,
            "admission": {"shedBulk": shed, "reason": shed_reason},
            "drain": sorted(drain),
            "desiredWorkers": desired,
            "scale": scale,
            "liveWorkers": len(workers),
            "decisions": list(self._decisions),
        }

    def _admission_decision(self, totals: dict):
        """Shed BULK while any objective burns hot on BOTH windows or
        its remaining budget is under the floor — BEFORE exhaustion."""
        for name, rates in (totals.get("burn") or {}).items():
            try:
                fast = float((rates or {}).get("fast", 0.0) or 0.0)
                slow = float((rates or {}).get("slow", 0.0) or 0.0)
            except (TypeError, ValueError):
                continue
            if fast >= self.shed_burn and slow >= self.shed_burn:
                return True, (f"burn {name} fast {fast:.2f} slow "
                              f"{slow:.2f} >= {self.shed_burn:g}")
        for name, remaining in (totals.get("budget") or {}).items():
            try:
                remaining = float(remaining)
            except (TypeError, ValueError):
                continue
            if remaining <= self.budget_floor:
                return True, (f"budget {name} {remaining:.2f} <= "
                              f"floor {self.budget_floor:g}")
        return False, ""

    def _drain_decision(self, totals: dict,
                        workers: List[dict]) -> List[str]:
        """Drain workers with open dependency breakers (browning out):
        new leases steer away so their queue empties while they heal.
        Never drains the whole fleet — with every worker browning out
        there is nowhere better to steer, so nobody drains."""
        open_breakers = totals.get("openBreakers") or {}
        live = {doc.get("workerId") for doc in workers}
        drain = [wid for wid in open_breakers if wid in live]
        if len(drain) >= len(live):
            return []
        return drain

    def _scale_decision(self, totals: dict, workers: List[dict]):
        """ceil(queueDepth / target_depth) clamped to [1, max_workers],
        adopted only after ``scale_hold_ticks`` consecutive agreeing
        ticks (hysteresis) — plus never below the live count while any
        worker still queues work (scale-down is advisory draining, not
        eviction of busy workers)."""
        try:
            depth = int(totals.get("queueDepth", 0) or 0)
            active = int(totals.get("activeJobs", 0) or 0)
        except (TypeError, ValueError):
            depth, active = 0, 0
        live = max(len(workers), 1)
        want = max(1, min(self.max_workers,
                          -(-(depth + active) // int(self.target_depth))
                          if (depth + active) else 1))
        if want == self._scale_candidate:
            self._scale_held += 1
        else:
            self._scale_candidate = want
            self._scale_held = 1
        adopted = self._last_desired if self._last_desired else live
        if self._scale_held >= self.scale_hold_ticks:
            adopted = want
        if adopted > live:
            scale = "up"
        elif adopted < live:
            scale = "down"
        else:
            scale = "hold"
        return adopted, scale

    # -- bookkeeping ----------------------------------------------------
    def _record_decision(self, kind: str, why: str, now: float) -> None:
        self._decisions.append(
            {"kind": kind, "why": why, "at": round(now, 3)})
        del self._decisions[:-DECISIONS_LIMIT]
        self._note(kind)
        if self.logger is not None:
            self.logger.info("fleet controller decision",
                             kind=kind, why=why)

    def _note(self, kind: str) -> None:
        if self.metrics is not None:
            self.metrics.fleet_controller_decisions.labels(
                kind=kind).inc()


__all__ = ["PlacementController"]
