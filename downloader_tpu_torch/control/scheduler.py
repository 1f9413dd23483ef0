"""Priority-class start-order scheduling for admitted jobs.

The reference starts jobs in raw queue order (upstream lib/main.js:172
consumes FIFO); under mixed traffic a backlog of bulk library imports
delays a user-facing request by the whole backlog.  Here the orchestrator
holds admitted-but-not-started jobs in a small priority queue: when one of
the ``max_concurrent_jobs`` slots frees up, the highest class waiting
starts first (HIGH before NORMAL before BULK).  There is **no mid-job
preemption** — a running bulk job finishes; priority only reorders starts.

Starvation-proofing: a waiter's effective rank improves by one class per
``aging_seconds`` waited, so a BULK job enqueued long ago eventually beats
a just-arrived HIGH job.  Ties break by arrival order (FIFO within class).

Multi-tenant fairness (control/tenancy.py): when a
:class:`~.tenancy.TenantTable` is attached, grants *within* a priority
class are apportioned across tenants by stride scheduling — each grant
advances the winning tenant's virtual pass by ``1/weight``, and the
tenant with the lowest pass wins the next tie — so a tenant with weight
4 gets ~4x the slots of a weight-1 tenant *under contention* while an
uncontended tenant still uses every free slot.  Per-tenant
``max_concurrent`` caps bound how many slots one tenant may hold at
once; a capped tenant's waiters are simply skipped (the slot goes to
the next eligible waiter, or stays free) until one of its jobs
releases.  Without a table every job is the ``default`` tenant and
behavior is exactly the pre-tenancy scheduler.

For the queue to have anything to reorder, the broker must deliver more
jobs than can run: ``instance.scheduler_backlog`` (env
``SCHEDULER_BACKLOG``) adds that many deliveries to the consumer
prefetch.  The default of 0 keeps exact pre-control-plane behavior
(prefetch == run slots, scheduler passes straight through).
"""

from __future__ import annotations

import asyncio
import itertools
import time
from typing import List

from .. import schemas

# start-order rank per priority class; lower starts first
PRIORITY_RANK = {"HIGH": 0, "NORMAL": 1, "BULK": 2}
DEFAULT_AGING_SECONDS = 60.0


def priority_name(value: int) -> str:
    """Wire enum value -> class name; unknown values (a newer producer)
    degrade to NORMAL instead of failing the delivery."""
    try:
        return schemas.JobPriority.Name(value)
    except ValueError:
        return "NORMAL"


def priority_rank(name: str) -> int:
    return PRIORITY_RANK.get(name, PRIORITY_RANK["NORMAL"])


DEFAULT_TENANT = "default"


class _Waiter:
    __slots__ = ("rank", "enqueued", "seq", "fut", "tenant")

    def __init__(self, rank: int, seq: int, tenant: str = DEFAULT_TENANT):
        self.rank = rank
        self.enqueued = time.monotonic()
        self.seq = seq
        self.tenant = tenant
        self.fut: asyncio.Future = asyncio.get_running_loop().create_future()

    def effective(self, now: float, aging: float):
        """Sort key: class rank improved by one per aging interval."""
        bump = int((now - self.enqueued) / aging) if aging > 0 else 0
        return (self.rank - bump, self.seq)


class PriorityScheduler:
    """Counting gate over ``slots`` with priority-ordered, tenant-fair
    grants (see module docstring)."""

    def __init__(self, slots: int,
                 aging_seconds: float = DEFAULT_AGING_SECONDS,
                 tenants=None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.slots = slots
        self.aging_seconds = float(aging_seconds)
        # control/tenancy.TenantTable (or None): weights + concurrency
        # caps for the weighted-fair pick; None = single-tenant behavior
        self.tenants = tenants
        self._free = slots
        self._waiters: List[_Waiter] = []
        self._seq = itertools.count()
        # stride scheduling state: per-tenant virtual pass (advanced by
        # 1/weight per grant) and per-tenant slots currently held
        self._pass: dict = {}
        self._held: dict = {}

    # -- introspection --------------------------------------------------
    @property
    def waiting(self) -> int:
        return len(self._waiters)

    @property
    def in_use(self) -> int:
        return self.slots - self._free

    def held_by_tenant(self) -> dict:
        """Slots currently held, per tenant (GET /v1/tenants)."""
        return {t: n for t, n in self._held.items() if n}

    def waiting_by_tenant(self) -> dict:
        """Queued waiters, per tenant (GET /v1/tenants)."""
        out: dict = {}
        for w in self._waiters:
            out[w.tenant] = out.get(w.tenant, 0) + 1
        return out

    # -- tenant accounting ----------------------------------------------
    def _capped(self, tenant: str) -> bool:
        if self.tenants is None:
            return False
        cap = self.tenants.max_concurrent(tenant)
        return cap is not None and self._held.get(tenant, 0) >= cap

    def _rejoin(self, tenant: str) -> None:
        """Lift a tenant's virtual pass to the ACTIVE floor when it
        enters from idle.

        Stride fairness only holds among tenants that keep competing; a
        tenant idle for a long stretch would otherwise bank unbounded
        credit (its pass frozen far below everyone else's) and
        monopolize grants on return until it "caught up".  The floor is
        the minimum pass among tenants currently holding or waiting —
        the rejoiner itself excluded, and computed BEFORE it becomes
        active, or its own stale pass would anchor the floor and make
        the clamp a no-op.
        """
        if self._held.get(tenant, 0) or any(
                w.tenant == tenant for w in self._waiters):
            return  # already active: its pass is live, not banked
        active = [self._pass[t] for t, n in self._held.items()
                  if n and t != tenant and t in self._pass]
        active += [self._pass[w.tenant] for w in self._waiters
                   if w.tenant != tenant and w.tenant in self._pass]
        if not active:
            return
        floor = min(active)
        current = self._pass.get(tenant)
        if current is None or current < floor:
            self._pass[tenant] = floor

    def _charge(self, tenant: str) -> None:
        self._held[tenant] = self._held.get(tenant, 0) + 1
        weight = (self.tenants.weight(tenant)
                  if self.tenants is not None else 1.0)
        self._pass[tenant] = self._pass.get(tenant, 0.0) + 1.0 / weight

    # -- gate -----------------------------------------------------------
    async def acquire(self, rank: int = 1,
                      tenant: str = DEFAULT_TENANT) -> None:
        """Take a run slot, queueing by ``rank`` (and tenant fairness)
        when none is free or the tenant is at its concurrency cap."""
        self._rejoin(tenant)
        if self._free > 0 and not self._waiters and not self._capped(tenant):
            self._free -= 1
            self._charge(tenant)
            return
        waiter = _Waiter(rank, next(self._seq), tenant)
        self._waiters.append(waiter)
        # a free slot may be grantable to THIS waiter right away (e.g.
        # earlier waiters all belong to capped tenants)
        self._grant()
        try:
            await waiter.fut
        except asyncio.CancelledError:
            try:
                self._waiters.remove(waiter)
            except ValueError:
                if waiter.fut.done() and not waiter.fut.cancelled():
                    # granted in the same tick we were cancelled: return
                    # the slot so it isn't leaked
                    self.release(tenant)
            raise

    def release(self, tenant: str = DEFAULT_TENANT) -> None:
        """Give a slot back and grant it to the best waiter, if any."""
        self._free += 1
        held = self._held.get(tenant, 0)
        if held > 0:
            self._held[tenant] = held - 1
        self._grant()

    def _grant(self) -> None:
        # aging makes the effective key time-dependent, so order is
        # decided at grant time with a plain min() scan — the waiter set
        # is bounded by scheduler_backlog (tens at most), where O(n)
        # beats maintaining any time-invalidated ordered structure
        now = time.monotonic()
        while self._free > 0 and self._waiters:
            eligible = [w for w in self._waiters
                        if not self._capped(w.tenant)]
            if not eligible:
                # every waiting tenant is at its cap: the slot stays
                # free for the next arrival / the next release re-scans
                return
            best = min(
                eligible,
                key=lambda w: (
                    # priority class (with aging) dominates ...
                    w.effective(now, self.aging_seconds)[0],
                    # ... tenants tie-break by stride pass within it
                    # (every waiting tenant has an entry: _rejoin
                    # materializes it at acquire time) ...
                    self._pass.get(w.tenant, 0.0),
                    # ... FIFO within (class, tenant)
                    w.seq,
                ),
            )
            self._waiters.remove(best)
            if best.fut.done():
                # cancelled while queued (guard's task.cancel lands on
                # the future before acquire's except removes the waiter):
                # drop it WITHOUT consuming a slot — set_result on a
                # cancelled future would raise InvalidStateError out of
                # the releasing job's finally and leak the slot
                continue
            self._free -= 1
            self._charge(best.tenant)
            best.fut.set_result(None)


class RunSlot:
    """One job's handle on its priority-scheduler run slot.

    Wraps the acquire/release pair the orchestrator used to manage with
    closure flags, and adds :meth:`reacquire` so a stage that parks for
    a long, idle wait — the fleet plane's lease waiters — can give the
    slot back to runnable jobs and queue for it again (same priority
    rank, normal aging) before resuming.  ``release`` is idempotent:
    the park path releases before its sleep and the processor's finally
    must not double-release.
    """

    __slots__ = ("_scheduler", "_rank", "_tenant", "granted", "released")

    def __init__(self, scheduler: PriorityScheduler, rank: int,
                 tenant: str = DEFAULT_TENANT):
        self._scheduler = scheduler
        self._rank = rank
        self._tenant = tenant
        self.granted = False
        self.released = False

    async def acquire(self) -> None:
        await self._scheduler.acquire(self._rank, self._tenant)
        self.granted = True
        self.released = False

    def release(self) -> None:
        if self.granted and not self.released:
            self.released = True
            self._scheduler.release(self._tenant)

    async def reacquire(self) -> None:
        """Take a slot again after :meth:`release` (no-op when held)."""
        if self.granted and self.released:
            await self._scheduler.acquire(self._rank, self._tenant)
            self.released = False


def backlog_from_config(config) -> int:
    """``instance.scheduler_backlog`` / env SCHEDULER_BACKLOG (extra
    consumer-prefetch deliveries held for start-order reordering)."""
    import os

    from ..platform.config import cfg_get

    raw = os.environ.get("SCHEDULER_BACKLOG")
    if raw is None:
        raw = cfg_get(config, "instance.scheduler_backlog", 0)
    try:
        backlog = int(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"scheduler_backlog must be an integer, got {raw!r}"
        ) from None
    if backlog < 0:
        raise ValueError(f"scheduler_backlog must be >= 0, got {backlog}")
    return backlog


def aging_from_config(config) -> float:
    """``instance.scheduler_aging_seconds`` / env SCHEDULER_AGING_SECONDS
    (seconds per one-class starvation bump; 0 disables aging)."""
    import os

    from ..platform.config import cfg_get

    raw = os.environ.get("SCHEDULER_AGING_SECONDS")
    if raw is None:
        raw = cfg_get(
            config, "instance.scheduler_aging_seconds", DEFAULT_AGING_SECONDS
        )
    try:
        aging = float(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"scheduler_aging_seconds must be a number, got {raw!r}"
        ) from None
    if aging < 0:
        raise ValueError(
            f"scheduler_aging_seconds must be >= 0, got {aging}"
        )
    return aging
