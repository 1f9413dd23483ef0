"""Content-aware routing at the admission edge.

The lease protocol (``plane.coordinate``) already stops duplicate
origin fetches — but it stops them LATE: by the time a worker discovers
a peer's lease it has consumed a delivery, burned admission, queued for
a run slot, and parked a whole job for the leader's publish.  On a
same-content-heavy workload that parks N-1 of the fleet's run slots
behind one download.

:class:`ContentRouter` moves the discovery to admission.  Every lease
doc carries the leader job's ``routeKey`` (a :func:`route_key_for` hash
over the message's source URI — computable from the delivery alone, no
origin probe), and every worker's :class:`~.plane.FleetPlane` maintains
a watch-fed lease view.  At admission the router looks the delivery's
route key up in that view — zero store round trips — and when a LIVE
peer already leads the content, the delivery is handed back to the
broker (park-then-nack, the shed discipline: never FAILED-counted,
never poison-charged) to land on the holder, whose in-process
singleflight coalesces it for free.

Two fleet-level concerns ride the same decision point:

- **Tenant fairness, fleet-wide** — each worker's scheduler only ever
  apportioned its OWN queue.  The router checks a BULK delivery's
  tenant against the fleet-wide queued shares on the overview doc and
  defers tenants hogging the fleet (bounded by ``fairness_factor``
  times their weighted fair share).
- **The controller's plan** — when the placement controller
  (``fleet/controller.py``) publishes ``admission.shedBulk`` (burn-rate
  pressure) the router sheds BULK at the edge, and a holder listed in
  the plan's ``drain`` set is NOT deferred to (new work steers away
  from a browning-out worker; the delivery runs here and coalesces
  through the lease protocol as before).

Failure posture: every input is a cached view that may be stale or
absent — absent view, absent plan, unknown holder all decide ``run``
(exactly today's behavior).  The router can only ever *decline to
optimize*; it never blocks work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

from ..platform.config import cfg_get
from ..store.cache import cache_key

# decision outcomes (``fleet_router_decisions_total{outcome}``)
RUN = "run"                      # no routing concern: admit normally
LOCAL = "local"                  # this worker already leads the content
DEFER = "defer"                  # hand to the current lease holder
FAIRNESS_DEFER = "fairness_defer"  # BULK over its fleet-wide fair share
SHED = "shed"                    # the controller's plan sheds BULK

DEFAULT_FAIRNESS_FACTOR = 2.0
# park-then-nack backoff for a routed delivery: long enough that the
# redelivery usually lands after the holder's next heartbeat refreshed
# every view, short enough that a finished holder's content is re-tried
# promptly (the defer loop is bounded by the lease lifetime — holder
# done => lease gone => shared-tier hit on redelivery)
DEFAULT_DEFER_BACKOFF = 2.0


def route_key_for(source_uri: str) -> Optional[str]:
    """The admission-edge routing identity for a delivery.

    Deliberately NOT the cache key: the http cache key embeds an origin
    validator (ETag/Last-Modified) only known after a HEAD probe, which
    admission must never pay.  A pure hash over the source URI is
    computable by every worker from the message alone and identical on
    both sides — the router here and the lease holder stamping it via
    ``stages/download.py``.  Same content behind two URIs simply
    doesn't route (the lease protocol still coalesces it later).
    """
    if not source_uri:
        return None
    return cache_key("route", source_uri)


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """One admission routing decision (flight-recorder material)."""

    outcome: str
    reason: str = ""
    holder: Optional[str] = None   # worker id the content routed toward
    backoff: float = 0.0           # park before the nack, seconds

    @property
    def settles(self) -> bool:
        """True when the delivery leaves this worker (park+nack)."""
        return self.outcome in (DEFER, FAIRNESS_DEFER, SHED)


class ContentRouter:
    """Per-worker router over the fleet plane's watch-fed views."""

    def __init__(self, plane, tenants=None, *,
                 fairness_factor: float = DEFAULT_FAIRNESS_FACTOR,
                 defer_backoff: float = DEFAULT_DEFER_BACKOFF,
                 metrics=None, logger=None):
        if fairness_factor < 1.0:
            # < 1 would defer a tenant sitting exactly at its fair
            # share — a single-tenant fleet would livelock its own BULK
            raise ValueError(
                f"fleet.router.fairness_factor must be >= 1.0, "
                f"got {fairness_factor}")
        self.plane = plane
        self.tenants = tenants
        self.fairness_factor = float(fairness_factor)
        self.defer_backoff = float(defer_backoff)
        self.metrics = metrics
        self.logger = logger
        # last non-run decision, for the heartbeat digest -> the
        # overview doc's per-worker DECISION column (`cli fleet top`)
        self.last: Optional[dict] = None
        # outcome -> count, the plane-stats idiom (metrics carry the
        # same numbers; this dict is the test/debug surface)
        self.stats: Dict[str, int] = {}

    @classmethod
    def from_config(cls, config, plane, tenants=None, *,
                    metrics=None, logger=None
                    ) -> Optional["ContentRouter"]:
        """Build from ``fleet.router.*``; None when routing is off
        (``fleet.router.enabled``, default True — but only ever called
        with a live fleet plane, so the lone-worker default cost stays
        zero)."""
        if plane is None:
            return None
        if not bool(cfg_get(config, "fleet.router.enabled", True)):
            return None
        return cls(
            plane, tenants,
            fairness_factor=float(cfg_get(
                config, "fleet.router.fairness_factor",
                DEFAULT_FAIRNESS_FACTOR)),
            defer_backoff=float(cfg_get(
                config, "fleet.router.defer_backoff",
                DEFAULT_DEFER_BACKOFF)),
            metrics=metrics, logger=logger,
        )

    # -- the decision ---------------------------------------------------
    def decide(self, source_uri: str, *, priority: str,
               tenant: str = "default") -> RouteDecision:
        """Route one delivery.  Pure reads over cached views — safe on
        the admission hot path, never awaits, never raises."""
        try:
            decision = self._decide(source_uri, priority, tenant)
        except Exception as err:  # a routing bug must not drop intake
            if self.logger is not None:
                self.logger.warn("content router error; admitting",
                                 error=str(err)[:200])
            decision = RouteDecision(RUN, reason="router_error")
        if self.metrics is not None:
            self.metrics.fleet_router_decisions.labels(
                outcome=decision.outcome).inc()
        self.stats[decision.outcome] = (
            self.stats.get(decision.outcome, 0) + 1)
        if decision.outcome != RUN:
            self.last = {"outcome": decision.outcome,
                         "reason": decision.reason,
                         "at": round(time.time(), 3)}
        return decision

    def _decide(self, source_uri: str, priority: str,
                tenant: str) -> RouteDecision:
        plan = self.plane.current_plan()
        # 1) the controller's admission plan: shed BULK at the edge
        #    BEFORE the SLO budget burns (the closed loop's actuator)
        if priority == "BULK" and plan is not None:
            admission = plan.get("admission") or {}
            if admission.get("shedBulk"):
                return RouteDecision(
                    SHED,
                    reason=str(admission.get("reason") or "plan"),
                    backoff=self.defer_backoff)
        # 2) content affinity: a live peer already leads this content
        route_key = route_key_for(source_uri)
        holder = (self.plane.route_holder(route_key)
                  if route_key else None)
        if holder is not None:
            owner = holder.get("owner")
            if owner == self.plane.worker_id:
                # our own lease: admit — the in-process singleflight
                # coalesces this delivery onto the running fetch
                return RouteDecision(LOCAL, reason="own_lease")
            if owner and not self._steer_away(owner, plan):
                return RouteDecision(
                    DEFER, reason="lease_holder", holder=owner,
                    backoff=self.defer_backoff)
            # holder browning out / draining: fall through — today's
            # lease-park coalescing still dedupes the origin fetch
        # 3) fleet-wide tenant fairness (BULK only: user-facing work is
        #    never deferred for queue-share bookkeeping)
        if priority == "BULK":
            over, share, fair = self._over_share(tenant)
            if over:
                return RouteDecision(
                    FAIRNESS_DEFER,
                    reason=(f"tenant {tenant} at {share:.0%} of fleet "
                            f"queue, fair {fair:.0%}"),
                    backoff=self.defer_backoff)
        return RouteDecision(RUN)

    def _steer_away(self, owner: str, plan: Optional[dict]) -> bool:
        """Should NEW work avoid ``owner``?  True when the controller's
        plan drains it (brownout, scale-down) — deferring a delivery TO
        a draining worker would feed the very queue placement is trying
        to empty."""
        if plan is None:
            return False
        drain = plan.get("drain")
        return isinstance(drain, (list, tuple)) and owner in drain

    def _over_share(self, tenant: str):
        """Is ``tenant`` over its fleet-wide weighted fair share of the
        queued backlog?  Returns (over, observed_share, fair_share).
        Absent/stale overview, unlisted tenant, or a trivially small
        backlog all decide False — fairness needs fleet evidence."""
        overview = self.plane.cached_overview()
        if overview is None:
            return False, 0.0, 0.0
        queued = (overview.get("totals") or {}).get("tenantQueued") or {}
        try:
            total = sum(int(v) for v in queued.values())
            mine = int(queued.get(tenant, 0))
        except (TypeError, ValueError):
            return False, 0.0, 0.0
        # a fleet with a near-empty backlog has nothing to apportion;
        # deferring the only queued job to enforce a ratio is absurd
        if total < 4 or mine <= 1:
            return False, 0.0, 0.0
        share = mine / total

        def weight(name: str) -> float:
            if self.tenants is None:
                return 1.0
            try:
                return float(self.tenants.weight(name))
            except Exception:
                return 1.0

        weights = sum(weight(name) for name in queued) or 1.0
        fair = weight(tenant) / weights
        return share > self.fairness_factor * fair, share, fair


__all__ = ["ContentRouter", "RouteDecision", "route_key_for",
           "RUN", "LOCAL", "DEFER", "FAIRNESS_DEFER", "SHED"]
