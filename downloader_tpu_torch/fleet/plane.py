"""Fleet plane: worker registry, cross-worker singleflight, shared cache.

Everything before this package coordinates *inside one process*: an earlier change's
singleflight coalesces same-content jobs sharing an orchestrator, and N
independent workers draining ``v1.download`` would still each download
the same hot episode.  :class:`FleetPlane` makes a set of worker
processes behave like one cache-coherent downloader, on top of the
:mod:`.coord` store's conditional-put primitive:

- **Worker registry** — each orchestrator registers
  ``workers/<worker_id>`` and re-heartbeats it every
  ``fleet.heartbeat_interval`` seconds with the autoscale signal trio
  (queue depth, oldest-queued age, disk headroom) plus its fleet stats;
  an entry whose heartbeat is older than ``fleet.liveness_ttl`` is
  considered dead and filtered from :meth:`workers` without any
  operator action.
- **Lease-based cross-worker singleflight** — before touching an
  origin, a worker tries a conditional-put on ``leases/<content_key>``
  (the exact :func:`~..store.cache.cache_key` identity the local cache
  uses).  The winner fetches and keeps the lease renewed; losers park
  their job (the control plane's PARKED state) and poll for the
  leader's shared-tier publish.  A lease whose leader stopped renewing
  (crash, partition) expires after ``fleet.lease_ttl`` and is taken
  over by compare-and-swap — a dead leader's work is reclaimed by
  whichever waiter notices first.
- **Shared cache tier** — on fill, the leader spills its local cache
  entry to ``<shared_prefix><key>/files/...`` in the staging bucket and
  seals it with ``manifest.json`` written LAST (the same
  manifest-publishes-the-entry discipline ``store/cache.py`` uses on
  disk: a torn spill is invisible, never served).  Peers materialize a
  hit by streaming the files into their local cache and hardlink-serving
  from there, so a fleet-wide hot object costs one origin download plus
  N-1 intra-infrastructure copies.

Failure posture (the contract): the coordination store is a
*dependency like any other* — its calls ride the ``coord`` retry policy
and every unrecoverable :class:`~.coord.CoordError` degrades the worker
to plain uncoordinated fetching (counted on
``fleet_coord_errors_total``), never failing or stalling a job.

**Fencing discipline** (Gray–Cheriton leases; the GC-pause split-brain):
a leader stalled past its lease TTL (SIGSTOP, GC pause, VM migration)
wakes believing it still leads while a peer has taken over with
``fence + 1``.  The fence number is therefore *enforced at every
cross-worker write*, not just allocated at takeover: the shared-tier
manifest, the done-marker seal, and telemetry digests all carry the
writer's fence, and a write is rejected — counted on
``fleet_fenced_writes_total{op}`` — when a higher fence has been
observed (lease-doc read + post-write read-back, the same best-effort
CAS posture as the bucket store's nonce verification; damage in the
sub-RTT window is bounded exactly like a conditional-put race).  A
resumed stale leader must lose.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import os
import posixpath
import shutil
import socket
import time
from typing import Any, Callable, Dict, List, Optional

from ..control.cancel import JobCancelled
from ..platform.config import cfg_get
from ..platform.tracing import parse_traceparent
from ..stages.upload import STAGING_BUCKET
from ..store.base import ObjectNotFound
from ..utils.hashing import md5_file_hex
from .coord import (ABSENT, ANY, BucketCoordStore, CasBucketCoordStore,
                    CoordError, CoordStore, CoordWatch, MemoryCoordStore)

# coordination-store key namespaces
WORKERS_PREFIX = "workers/"
LEASES_PREFIX = "leases/"
# per-job trace digests: telemetry/<trace_id>/<worker_id>/<job_id> (on the bucket
# backend that is `.fleet/telemetry/...` in the staging bucket)
TELEMETRY_PREFIX = "telemetry/"
# the one fleet-overview document the elected aggregator folds live
# members into each heartbeat (the first fleet-WIDE view —
# burn rates, breakers, tenant queue shares — any worker can serve)
OVERVIEW_PREFIX = "overview/"
OVERVIEW_KEY = OVERVIEW_PREFIX + "fleet"
# the one placement/autoscale plan document the elected controller
# (fleet/controller.py) publishes each heartbeat; every worker watches
# it and consults the cached copy at admission
PLAN_PREFIX = "plan/"
PLAN_KEY = PLAN_PREFIX + "fleet"
# the fleet-shared origin-health table: per-origin throughput EWMAs
# merged from every worker, seeded into each worker's OriginHealth at
# boot (a worker that watched an origin die spares its peers the probe)
ORIGINS_PREFIX = "origins/"
ORIGIN_HEALTH_KEY = ORIGINS_PREFIX + "health"
# shared-tier object layout in the staging bucket
SHARED_PREFIX = ".fleet-cache/"
MANIFEST_NAME = "manifest.json"


def _fput_supports(store, parameter: str) -> bool:
    """Signature probe for optional fput_object capabilities (tests
    monkeypatch fput freely, so probe per call, not at construction)."""
    try:
        return parameter in inspect.signature(
            store.fput_object).parameters
    except (TypeError, ValueError):
        return False

DEFAULT_HEARTBEAT_INTERVAL = 5.0
DEFAULT_LIVENESS_TTL = 15.0
DEFAULT_LEASE_TTL = 20.0
DEFAULT_POLL_INTERVAL = 0.25
# a waiter parked on a peer's lease gives up coordinating (and fetches
# for itself) after this long — a livelock bound, not a hot-path knob
DEFAULT_MAX_WAIT = 600.0
# shared-tier / tombstone GC (the sweep keeping .fleet-cache/ and
# .fleet/ growth bounded); interval 0 disables the loop entirely
DEFAULT_GC_INTERVAL = 300.0
DEFAULT_SHARED_MAX_AGE = 24 * 3600.0
DEFAULT_SHARED_MAX_BYTES = 0  # 0 = no size budget (age bound only)
# per-job trace digests published at settle live this long before the
# fleet GC reclaims them (0 disables publishing entirely)
DEFAULT_TELEMETRY_TTL = 1800.0
# seconds between merges of this worker's per-origin EWMAs into the
# fleet-shared origin-health table (0 disables sharing)
DEFAULT_ORIGIN_SHARE_INTERVAL = 60.0
# a fleet-shared origin-health row older than this is stale history,
# not a head start: boot seeding skips it
ORIGIN_HEALTH_MAX_AGE = 6 * 3600.0
# events kept in one digest: enough for the lifecycle + failure tail,
# bounded so a digest document stays a few KB
DIGEST_EVENT_LIMIT = 48
# per-read budget on the overview fetch (the trace assembler's
# PEER_TIMEOUT posture): a browned-out coordination store must cost a
# bounded wait and a degraded response, never a hung admin read
OVERVIEW_FETCH_BUDGET = 5.0

# a lease is only treated as dead once expired by this fraction of the
# TTL: lease math compares the WRITER's wall clock against the READER's,
# so modest cross-host clock skew must not let a waiter steal a lease
# its live leader is still renewing (renewals land every ttl/3; skew
# beyond grace + renewal margin needs NTP, which the docs require)
TAKEOVER_GRACE_FRAC = 0.25

# coordinate() outcomes
LED = "led"                     # this worker held the lease and fetched
SHARED = "shared"               # served from the fleet shared tier
UNCOORDINATED = "uncoordinated"  # coordination unavailable: fetch alone

# bound on the per-key observed-fence memo (insertion-order eviction;
# a key's fence re-learns from the lease doc / manifest on next touch)
_FENCE_SEEN_MAX = 1024


def resolve_worker_id(config) -> str:
    """Stable-for-the-process worker identity: env ``WORKER_ID``, config
    ``fleet.worker_id``, else ``<host>-<pid>-<nonce>`` (the nonce keeps
    N orchestrators in one test process distinct)."""
    configured = os.environ.get("WORKER_ID") or cfg_get(
        config, "fleet.worker_id", None
    )
    if configured:
        return str(configured)
    return f"{socket.gethostname()}-{os.getpid()}-{os.urandom(3).hex()}"


class _GcLeaseViewUnavailable(Exception):
    """The GC sweep could not read the lease view (asymmetric
    partition): the shared-tier eviction pass must stand down rather
    than evict keys that may be under a live peer's lease."""


class _Lease:
    """One held lease: its CAS token and the renewal task keeping it."""

    __slots__ = ("key", "token", "fence", "renewer", "trace",
                 "route_key")

    def __init__(self, key: str, token: str, fence: int,
                 trace: Optional[dict] = None,
                 route_key: Optional[str] = None):
        self.key = key
        self.token = token
        self.fence = fence
        # the leading job's W3C trace context, re-stamped on every
        # renewal so waiters always see which trace their wait joins
        self.trace = trace
        # the admission-edge routing identity (cache_key over the
        # source URI) — stamped into the lease doc so every worker's
        # watch-fed lease view can steer same-content deliveries to
        # this holder (the design content-aware routing)
        self.route_key = route_key
        self.renewer: Optional[asyncio.Task] = None


class FleetPlane:
    """One worker's handle on the fleet (see module docstring)."""

    def __init__(
        self,
        coord: CoordStore,
        worker_id: str,
        *,
        store=None,
        shared_bucket: str = STAGING_BUCKET,
        shared_prefix: str = SHARED_PREFIX,
        heartbeat_interval: float = DEFAULT_HEARTBEAT_INTERVAL,
        liveness_ttl: float = DEFAULT_LIVENESS_TTL,
        lease_ttl: float = DEFAULT_LEASE_TTL,
        poll_interval: float = DEFAULT_POLL_INTERVAL,
        max_wait: float = DEFAULT_MAX_WAIT,
        gc_interval: float = DEFAULT_GC_INTERVAL,
        shared_max_age: float = DEFAULT_SHARED_MAX_AGE,
        shared_max_bytes: int = DEFAULT_SHARED_MAX_BYTES,
        telemetry_ttl: float = DEFAULT_TELEMETRY_TTL,
        advertise_url: Optional[str] = None,
        watch_enabled: bool = True,
        origin_share_interval: float = DEFAULT_ORIGIN_SHARE_INTERVAL,
        metrics=None,
        logger=None,
        retrier=None,
        payload_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        digest_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        origin_fn: Optional[Callable[[], Dict[str, Any]]] = None,
    ):
        if liveness_ttl <= heartbeat_interval:
            raise ValueError(
                f"fleet.liveness_ttl ({liveness_ttl}) must exceed "
                f"fleet.heartbeat_interval ({heartbeat_interval})"
            )
        if lease_ttl <= 0 or poll_interval <= 0:
            raise ValueError("fleet lease_ttl/poll_interval must be > 0")
        self.coord = coord
        self.worker_id = worker_id
        self.store = store
        self.shared_bucket = shared_bucket
        self.shared_prefix = shared_prefix
        self.heartbeat_interval = float(heartbeat_interval)
        self.liveness_ttl = float(liveness_ttl)
        self.lease_ttl = float(lease_ttl)
        self.poll_interval = float(poll_interval)
        self.max_wait = float(max_wait)
        self.gc_interval = float(gc_interval)
        self.shared_max_age = float(shared_max_age)
        self.shared_max_bytes = int(shared_max_bytes)
        # cross-worker trace digests (``fleet.telemetry_ttl``; 0 = off):
        # settled jobs publish a compact timeline digest the fleet's
        # trace assembly (control/trace.py) joins across workers
        self.telemetry_ttl = float(telemetry_ttl)
        # this worker's admin-API base URL, advertised in heartbeats so
        # peers can assemble LIVE (pre-settle) trace segments over HTTP
        # (``fleet.advertise_url``; None = digests/local only)
        self.advertise_url = advertise_url
        self.metrics = metrics
        self.logger = logger
        self.retrier = retrier
        self.payload_fn = payload_fn
        # compact SLO/health digest carried in every heartbeat
        # (orchestrator.slo_digest: burn rates, open breakers, top
        # hops, tenant queue shares) — the raw material the elected
        # aggregator folds into the fleet-overview doc.  Optional by
        # contract: a pre-PR-15 worker's heartbeat simply has no
        # digest, and build_overview lists it with ``digest: null``.
        self.digest_fn = digest_fn
        # per-origin throughput snapshot for the fleet-shared
        # origin-health table (orchestrator wires OriginHealth.snapshot;
        # None = this worker does not share)
        self.origin_fn = origin_fn
        self.origin_share_interval = float(origin_share_interval)
        self._origin_shared_mono = 0.0
        # watch/subscribe plane: event-driven on backends
        # that can, snapshot-diff long-poll otherwise, and OFF entirely
        # (pure sleep-poll, the degraded path) when disabled
        self.watch_enabled = bool(watch_enabled)
        self._overview_watch: Optional[CoordWatch] = None
        self._overview_doc: Optional[dict] = None
        self._plan_watch: Optional[CoordWatch] = None
        self._plan_doc: Optional[dict] = None
        self._lease_watch: Optional[CoordWatch] = None
        # lease-doc cache fed by the lease watch (content key -> doc):
        # the content router's holder lookups must not cost a store RTT
        # per delivery
        self._lease_view: Dict[str, dict] = {}
        self._lease_view_ready = False
        # wall-clock ``updatedAt`` of the overview doc this worker last
        # published or read (None until either happens) — the
        # ``fleet_overview_age_seconds`` gauge's source
        self._overview_updated_at: Optional[float] = None
        self.started_at = time.time()
        self._heartbeat_task: Optional[asyncio.Task] = None
        self._gc_task: Optional[asyncio.Task] = None
        self._worker_token: Optional[str] = None
        self._gauge_sampled_mono = 0.0
        self._held: Dict[str, _Lease] = {}
        # shared-tier entries seen manifest-less on the previous sweep:
        # two consecutive manifest-less sightings (>= gc_interval apart)
        # mark a torn/abandoned spill safe to reclaim (listings carry no
        # mtime, so "seen twice" is the age proxy)
        self._gc_manifestless: set = set()
        # manifest "created" stamps memoized across sweeps (immutable
        # once published; pruned to the current listing each sweep)
        self._gc_created: Dict[str, float] = {}
        # highest lease fence OBSERVED per content key (from lease
        # reads, takeovers, and manifest read-backs) — the local half
        # of fencing enforcement: a write whose fence is below this is
        # stale even when the lease doc is already gone.  Bounded
        # (insertion-order eviction past _FENCE_SEEN_MAX).
        self._fence_seen: Dict[str, int] = {}
        # local stats, also carried in every heartbeat payload
        self.stats: Dict[str, int] = {
            "leasesLed": 0, "leaseWaits": 0, "leaseTakeovers": 0,
            "sharedHits": 0, "sharedFills": 0,
            "sharedBytesIn": 0, "sharedBytesOut": 0,
            "sharedCorrupt": 0,
            "coordErrors": 0, "uncoordinatedFallbacks": 0,
            "gcSharedEvicted": 0, "gcTombstonesCompacted": 0,
            "gcBytesReclaimed": 0,
            "telemetryPublished": 0, "gcTelemetryEvicted": 0,
            "fencedWrites": 0, "originHealthShared": 0,
        }

    # -- config ---------------------------------------------------------
    @classmethod
    def from_config(cls, config, *, worker_id: str, store=None, coord=None,
                    metrics=None, logger=None, retrier=None,
                    payload_fn=None, digest_fn=None, origin_fn=None
                    ) -> Optional["FleetPlane"]:
        """Build from ``fleet.*`` / env; None when the fleet is disabled
        (the default — a lone worker pays nothing for this subsystem).

        Knobs: ``FLEET_ENABLED``/``fleet.enabled``, ``fleet.backend``
        (``bucket`` default | ``cas`` | ``memory``),
        ``fleet.heartbeat_interval``, ``fleet.liveness_ttl``,
        ``fleet.lease_ttl``, ``fleet.poll_interval``, ``fleet.max_wait``,
        ``fleet.shared_tier`` (false keeps leases but skips the spill),
        ``fleet.gc_interval`` (0 disables the GC sweep),
        ``fleet.shared_max_age`` / ``fleet.shared_max_bytes`` (shared-
        tier eviction bounds), ``fleet.watch_enabled`` (false pins the
        degraded sleep-poll path), ``fleet.origin_share_interval``
        (0 disables the shared origin-health table).
        """
        enabled = os.environ.get("FLEET_ENABLED")
        if enabled is None:
            enabled = bool(cfg_get(config, "fleet.enabled", False))
        else:
            enabled = enabled.lower() in ("1", "true", "yes")
        if not enabled:
            return None
        if coord is None:
            backend = os.environ.get("FLEET_BACKEND") or cfg_get(
                config, "fleet.backend", "bucket"
            )
            if backend == "memory":
                # hermetic, single-process: workers must SHARE a store
                # to coordinate, so this is for tests/benches that pass
                # their own — a per-worker one coordinates only itself
                coord = MemoryCoordStore()
            elif backend == "bucket":
                if store is None:
                    raise ValueError(
                        "fleet.backend: bucket needs an object store"
                    )
                coord = BucketCoordStore(store)
            elif backend == "cas":
                # real conditional puts (S3 If-Match / If-None-Match):
                # server-arbitrated CAS, no settle delay, no read-back
                if store is None:
                    raise ValueError(
                        "fleet.backend: cas needs an object store"
                    )
                coord = CasBucketCoordStore(store)
            else:
                raise ValueError(
                    f"fleet.backend must be bucket|cas|memory, "
                    f"got {backend!r}"
                )
        shared = bool(cfg_get(config, "fleet.shared_tier", True))
        return cls(
            coord, worker_id,
            store=store if shared else None,
            heartbeat_interval=float(cfg_get(
                config, "fleet.heartbeat_interval",
                DEFAULT_HEARTBEAT_INTERVAL)),
            liveness_ttl=float(cfg_get(
                config, "fleet.liveness_ttl", DEFAULT_LIVENESS_TTL)),
            lease_ttl=float(cfg_get(
                config, "fleet.lease_ttl", DEFAULT_LEASE_TTL)),
            poll_interval=float(cfg_get(
                config, "fleet.poll_interval", DEFAULT_POLL_INTERVAL)),
            max_wait=float(cfg_get(
                config, "fleet.max_wait", DEFAULT_MAX_WAIT)),
            gc_interval=float(cfg_get(
                config, "fleet.gc_interval", DEFAULT_GC_INTERVAL)),
            shared_max_age=float(cfg_get(
                config, "fleet.shared_max_age", DEFAULT_SHARED_MAX_AGE)),
            shared_max_bytes=int(cfg_get(
                config, "fleet.shared_max_bytes",
                DEFAULT_SHARED_MAX_BYTES)),
            telemetry_ttl=float(cfg_get(
                config, "fleet.telemetry_ttl", DEFAULT_TELEMETRY_TTL)),
            advertise_url=cfg_get(config, "fleet.advertise_url", None),
            watch_enabled=bool(cfg_get(
                config, "fleet.watch_enabled", True)),
            origin_share_interval=float(cfg_get(
                config, "fleet.origin_share_interval",
                DEFAULT_ORIGIN_SHARE_INTERVAL)),
            metrics=metrics, logger=logger, retrier=retrier,
            payload_fn=payload_fn, digest_fn=digest_fn,
            origin_fn=origin_fn,
        )

    # -- plumbing -------------------------------------------------------
    def _note_coord_error(self, op: str, err: BaseException) -> None:
        self.stats["coordErrors"] += 1
        if self.metrics is not None:
            self.metrics.fleet_coord_errors.labels(op=op).inc()
        if self.logger is not None:
            self.logger.warn("fleet coordination error",
                             op=op, error=str(err)[:200])

    async def _coord_op(self, seam: str, factory, cancel=None):
        """Run one coordination call under the ``coord`` retry policy
        (when a retrier is attached) so a single store blip does not
        instantly degrade the worker to uncoordinated fetching."""
        if self.retrier is None:
            return await factory()
        return await self.retrier.run(seam, factory, cancel=cancel,
                                      logger=self.logger)

    # -- watch/subscribe plumbing ---------------------------------------
    def _note_watch_wakeup(self, mode: str) -> None:
        """Count one watch-plane wake-up: ``event`` (the watch
        delivered changes), ``timeout`` (bounded long-poll lapsed), or
        ``poll`` (degraded to sleep-poll — watch unavailable/broken)."""
        if self.metrics is not None:
            self.metrics.fleet_watch_wakeups.labels(mode=mode).inc()

    def _open_watch(self, prefix: str) -> Optional[CoordWatch]:
        """A watch on ``prefix``, or None when the watch plane is off
        or the store refused — the caller's poll loop is the fallback."""
        if not self.watch_enabled:
            return None
        try:
            return self.coord.watch(prefix,
                                    poll_interval=self.poll_interval)
        except Exception as err:
            self._note_coord_error("watch_open", err)
            return None

    def telemetry_watch(self) -> Optional[CoordWatch]:
        """A watch over the fleet's per-job telemetry digests — every
        settle publishes one, so a wake here is 'a peer just finished
        something'.  The staged-probe loop (orchestrator) rides this to
        retire recovery placeholders promptly instead of waiting out
        its fallback interval.  None = watch plane off/refused."""
        return self._open_watch(TELEMETRY_PREFIX)

    async def _drain_watch(self, watch: Optional[CoordWatch]
                           ) -> Optional[list]:
        """Non-blocking drain of one maintained watch; None = watch
        unusable this lap (closed/broken), [] = open but quiet."""
        if watch is None:
            return None
        try:
            return await watch.next(0)
        except asyncio.CancelledError:
            raise
        except Exception as err:
            self._note_coord_error("watch", err)
            return None

    async def _waiter_wait(self, watch: Optional[CoordWatch],
                           deadline: float) -> Optional[CoordWatch]:
        """One parked-waiter lap: block until the watched lease doc
        changes (the leader released/renewed, a takeover rewrote it),
        a bounded long-poll lapses, or — no watch — one poll-interval
        sleep, the degraded path.  Returns the watch to keep
        using; None once it broke (sleep-poll from there on)."""
        if watch is None:
            self._note_watch_wakeup("poll")
            await asyncio.sleep(self.poll_interval)
            return None
        # bounded lap: a missed event (brownout, watch races) must not
        # outwait lease EXPIRY — cap at the takeover grace so a dead
        # leader is still noticed promptly; floor at poll_interval so
        # a nearly-due deadline cannot busy-spin the watch
        timeout = max(self.poll_interval,
                      min(self.lease_ttl * TAKEOVER_GRACE_FRAC,
                          deadline - time.monotonic()))
        try:
            events = await watch.next(timeout)
        except asyncio.CancelledError:
            raise
        except Exception as err:
            self._note_coord_error("watch", err)
            watch.close()
            self._note_watch_wakeup("poll")
            await asyncio.sleep(self.poll_interval)
            return None
        self._note_watch_wakeup("event" if events else "timeout")
        return watch

    # -- fencing --------------------------------------------------------
    def _observe_fence(self, key: str, fence) -> None:
        """Max-merge one observed lease fence for ``key`` (bounded memo)."""
        try:
            fence = int(fence)
        except (TypeError, ValueError):
            return
        if fence <= 0:
            return
        if fence > self._fence_seen.get(key, 0):
            self._fence_seen.pop(key, None)
            self._fence_seen[key] = fence
            while len(self._fence_seen) > _FENCE_SEEN_MAX:
                self._fence_seen.pop(next(iter(self._fence_seen)))

    def observed_fence(self, key: str) -> int:
        """Highest fence this worker has seen for ``key`` (0 = none)."""
        return self._fence_seen.get(key, 0)

    def _note_fenced_write(self, op: str, key: str, fence: int,
                           newer: int) -> None:
        """Count one rejected stale write — the split-brain save."""
        self.stats["fencedWrites"] += 1
        if self.metrics is not None:
            self.metrics.fleet_fenced_writes.labels(op=op).inc()
        if self.logger is not None:
            self.logger.warn("fleet: fenced off stale write",
                             op=op, key=key[:16], fence=fence,
                             newer=newer)

    async def fence_holds(self, key: str, fence) -> bool:
        """Is ``fence`` still the write authority for ``key``?

        False once a higher fence has been observed — locally, or by a
        fresh read of the lease doc (the cross-worker observation: a
        resumed stale leader learns of its takeover here).  Best-effort
        like every coordination read: a store failure degrades to the
        local memo (fencing is defense-in-depth on top of content-hash
        resume + manifest-last publish, not the sole correctness line).
        """
        try:
            fence = int(fence)
        except (TypeError, ValueError):
            return True  # no fence context: nothing to enforce
        if fence <= 0:
            return True
        if self.observed_fence(key) > fence:
            return False
        try:
            entry = await self.coord.get(LEASES_PREFIX + key)
        except asyncio.CancelledError:
            raise
        except Exception as err:
            self._note_coord_error("fence_check", err)
            return True  # degrade to the local memo's verdict above
        if entry is not None:
            doc = entry[0]
            self._observe_fence(key, doc.get("fence"))
            doc_fence = doc.get("fence")
            if isinstance(doc_fence, int) and doc_fence > fence:
                return False
        # strictly-greater only: our own claimed fence always came from
        # a lease we held (the leader path is the only place it is
        # stamped), so an EQUAL number elsewhere is cross-epoch reuse
        # after a full release — fencing the healthy later writer there
        # drops real work to save nothing
        return self.observed_fence(key) <= fence

    # -- worker registry ------------------------------------------------
    def _worker_doc(self) -> dict:
        now = time.time()
        doc = {
            "workerId": self.worker_id,
            "startedAt": round(self.started_at, 3),
            "heartbeatAt": round(now, 3),
            "expiresAt": round(now + self.liveness_ttl, 3),
            "leases": sorted(self._held),
            "stats": dict(self.stats),
        }
        if self.advertise_url:
            # peers use this to assemble LIVE cross-worker traces over
            # the admin API (control/trace.py); absent = digests only
            doc["adminUrl"] = self.advertise_url
        if self.payload_fn is not None:
            try:
                doc["signals"] = dict(self.payload_fn())
            except Exception as err:  # a bad signal must not kill beats
                doc["signalsError"] = str(err)[:120]
        if self.digest_fn is not None:
            # the SLO/health digest (burn rates, open breakers, top
            # hops, tenant queue shares) — same failure posture as the
            # autoscale signals: a broken digest must not kill beats
            try:
                doc["digest"] = dict(self.digest_fn())
            except Exception as err:
                doc["digestError"] = str(err)[:120]
        return doc

    async def _beat_once(self) -> None:
        doc = self._worker_doc()
        key = WORKERS_PREFIX + self.worker_id
        token = await self.coord.put(
            key, doc,
            expect=self._worker_token if self._worker_token else ANY,
        )
        if token is None:
            # our entry was replaced (e.g. swept, or an id collision):
            # reclaim it unconditionally — this worker IS the identity
            token = await self.coord.put(key, doc, expect=ANY)
        self._worker_token = token
        # membership enumeration is list + one get per key (including
        # tombstones on the bucket backend), so the gauge samples at a
        # bounded cadence instead of every beat
        now = time.monotonic()
        if (self.metrics is not None and token is not None
                and now - self._gauge_sampled_mono
                >= max(self.heartbeat_interval, 15.0)):
            self._gauge_sampled_mono = now
            try:
                live = len(await self.workers())
                self.metrics.fleet_workers_live.set(live)
            except asyncio.CancelledError:
                raise
            except Exception:
                pass  # the gauge just keeps its last sample

    async def _heartbeat_loop(self) -> None:
        while True:
            try:
                await self._beat_once()
            except CoordError as err:
                self._note_coord_error("heartbeat", err)
            except asyncio.CancelledError:
                raise
            except Exception as err:
                self._note_coord_error("heartbeat", err)
            try:
                # fold (or track) the fleet overview on the same
                # cadence — its own try: overview trouble must never
                # starve the liveness beat above
                await self._overview_tick()
            except asyncio.CancelledError:
                raise
            except Exception as err:
                self._note_coord_error("overview", err)
            try:
                # refresh the watch-fed lease/plan caches the content
                # router consults at admission (same posture: cache
                # trouble degrades routing, never the beat)
                await self._refresh_views()
            except asyncio.CancelledError:
                raise
            except Exception as err:
                self._note_coord_error("views", err)
            try:
                await self._origin_health_tick()
            except asyncio.CancelledError:
                raise
            except Exception as err:
                self._note_coord_error("origin_health", err)
            await asyncio.sleep(self.heartbeat_interval)

    async def start(self) -> None:
        """Register this worker and begin heartbeating (+ GC sweeping)."""
        try:
            await self._beat_once()
        except asyncio.CancelledError:
            raise
        except Exception as err:
            # registration trouble is not fatal: the loop keeps trying
            self._note_coord_error("register", err)
        self._heartbeat_task = asyncio.create_task(
            self._heartbeat_loop(), name=f"fleet-heartbeat-{self.worker_id}"
        )
        if self.gc_interval > 0 and self.store is not None:
            self._gc_task = asyncio.create_task(
                self._gc_loop(), name=f"fleet-gc-{self.worker_id}"
            )

    async def stop(self) -> None:
        """Deregister and release every held lease (clean drain: peers
        see this worker vanish immediately, not after liveness_ttl)."""
        if self._gc_task is not None:
            self._gc_task.cancel()
            try:
                await self._gc_task
            except (asyncio.CancelledError, Exception):
                pass
            self._gc_task = None
        if self._heartbeat_task is not None:
            self._heartbeat_task.cancel()
            try:
                await self._heartbeat_task
            except (asyncio.CancelledError, Exception):
                pass
            self._heartbeat_task = None
        for watch in (self._overview_watch, self._plan_watch,
                      self._lease_watch):
            if watch is not None:
                watch.close()
        self._overview_watch = None
        self._plan_watch = None
        self._lease_watch = None
        for key in list(self._held):
            await self.release_lease(key)
        try:
            await self.coord.delete(WORKERS_PREFIX + self.worker_id)
        except asyncio.CancelledError:
            raise
        except Exception as err:
            # the registry entry simply expires after liveness_ttl
            self._note_coord_error("deregister", err)

    async def _get_all(self, prefix: str) -> "List[tuple[str, dict]]":
        """Live ``(key, document)`` pairs under ``prefix``, resolved
        concurrently (one listing + gathered gets — the bucket backend
        pays one RTT, not one per key; tombstoned keys resolve to None
        and drop out)."""
        keys = await self.coord.list_keys(prefix)
        entries = await asyncio.gather(
            *(self.coord.get(key) for key in keys)
        )
        return [(key, entry[0]) for key, entry in zip(keys, entries)
                if entry is not None]

    async def workers(self) -> List[dict]:
        """Live workers (heartbeat within liveness_ttl), oldest first."""
        now = time.time()
        out = [doc for _key, doc in await self._get_all(WORKERS_PREFIX)
               if float(doc.get("expiresAt", 0)) >= now]
        out.sort(key=lambda d: d.get("startedAt", 0))
        return out

    async def worker(self, worker_id: str) -> Optional[dict]:
        entry = await self.coord.get(WORKERS_PREFIX + worker_id)
        if entry is None:
            return None
        doc = entry[0]
        doc["live"] = float(doc.get("expiresAt", 0)) >= time.time()
        return doc

    async def leases(self) -> List[dict]:
        """Every live lease (owner, fence, expiry) — the stuck-lease
        triage view ``cli fleet list`` renders."""
        now = time.time()
        out = []
        for key, doc in await self._get_all(LEASES_PREFIX):
            doc["key"] = key[len(LEASES_PREFIX):]
            doc["expired"] = float(doc.get("expiresAt", 0)) < now
            out.append(doc)
        return out

    # -- leases ---------------------------------------------------------
    def _trace_context(self, record) -> Optional[dict]:
        """The job's W3C trace context as a small carry-able document —
        what lease docs and shared-tier manifests propagate so the
        cross-worker trace assembly can join waiter and leader."""
        trace_id = getattr(record, "trace_id", None)
        span_id = getattr(record, "span_id", None)
        if not trace_id or not span_id:
            # no span id, no context: an all-zero placeholder would
            # round-trip into a traceparent that parse_traceparent
            # rejects by spec — a silently unfollowable link
            return None
        return {
            "traceparent": f"00-{trace_id}-{span_id}-01",
            "jobId": getattr(record, "job_id", None),
            "worker": self.worker_id,
        }

    def _lease_doc(self, fence: int, trace: Optional[dict] = None,
                   route_key: Optional[str] = None) -> dict:
        now = time.time()
        doc = {
            "owner": self.worker_id,
            "fence": fence,
            "acquiredAt": round(now, 3),
            "expiresAt": round(now + self.lease_ttl, 3),
        }
        if trace:
            # the leading job's traceparent rides the lease: a waiter
            # parked on this key knows exactly which trace (and which
            # worker's fetch) it is waiting on
            doc["trace"] = dict(trace)
        if route_key:
            # the content router's lookup identity: peers consult their
            # watch-fed lease view for this and hand same-content
            # deliveries to the holder instead of parking N-1 workers
            doc["routeKey"] = route_key
        return doc

    async def try_acquire_lease(self, key: str,
                                trace: Optional[dict] = None,
                                route_key: Optional[str] = None
                                ) -> Optional[_Lease]:
        """One conditional-put attempt on ``leases/<key>``.

        Returns the held lease, or None when a live peer holds it.  An
        expired lease is taken over by CAS against the dead leader's
        token — the fence number increments so the takeover is visible
        in the lease history."""
        lease_key = LEASES_PREFIX + key
        entry = await self.coord.get(lease_key)
        if entry is None:
            # seed ABOVE any fence this worker has ever observed for
            # the key: release_lease deletes the doc, so a naive fresh
            # acquire would restart at 1 and the writer would fence
            # ITSELF off against its own memo of the previous epoch.
            # (Cross-worker number reuse after both the doc and the
            # manifest are gone remains possible — the same bounded
            # best-effort window as the bucket store's conditional put;
            # a stale writer's horizon is one job lifetime.)
            fence = self.observed_fence(key) + 1
            token = await self.coord.put(
                lease_key, self._lease_doc(fence, trace, route_key),
                expect=ABSENT
            )
            takeover = False
        else:
            doc, old_token = entry
            self._observe_fence(key, doc.get("fence"))
            # a lease owned by OUR id that we do not hold is orphaned by
            # definition (its renewer died with the previous process —
            # stable worker_ids survive restarts): reclaim immediately
            # instead of waiting out our own TTL
            own_orphan = (doc.get("owner") == self.worker_id
                          and key not in self._held)
            grace = self.lease_ttl * TAKEOVER_GRACE_FRAC
            if not own_orphan and (
                    float(doc.get("expiresAt", 0)) + grace >= time.time()):
                return None  # live (or skew-ambiguous) leader
            # max against the local memo too: the doc's fence is the
            # floor, but this worker may have observed a newer epoch
            # (e.g. a manifest read-back) the doc never carried
            fence = max(int(doc.get("fence", 0)),
                        self.observed_fence(key)) + 1
            token = await self.coord.put(
                lease_key, self._lease_doc(fence, trace, route_key),
                expect=old_token
            )
            takeover = True
        if token is None:
            return None  # lost the race: someone else just took it
        self._observe_fence(key, fence)
        lease = _Lease(key, token, fence, trace=trace,
                       route_key=route_key)
        self._held[key] = lease
        lease.renewer = asyncio.create_task(
            self._renew_loop(lease), name=f"fleet-lease-{key[:12]}"
        )
        if self.metrics is not None:
            self.metrics.fleet_leases_acquired.labels(
                mode="takeover" if takeover else "fresh"
            ).inc()
        if takeover:
            self.stats["leaseTakeovers"] += 1
            if self.logger is not None:
                self.logger.warn("fleet: took over expired lease",
                                 key=key[:16], fence=fence)
        self.stats["leasesLed"] += 1
        return lease

    async def _renew_loop(self, lease: _Lease) -> None:
        """Keep a held lease alive while its fetch runs.  A failed renew
        (store trouble or the lease was stolen) stops renewing but never
        interrupts the fetch — worst case a peer duplicates the
        download, which is the uncoordinated baseline."""
        interval = max(self.lease_ttl / 3.0, 0.05)
        while True:
            await asyncio.sleep(interval)
            try:
                token = await self.coord.put(
                    LEASES_PREFIX + lease.key,
                    self._lease_doc(lease.fence, lease.trace,
                                    lease.route_key),
                    expect=lease.token,
                )
            except asyncio.CancelledError:
                raise
            except Exception as err:
                self._note_coord_error("lease_renew", err)
                return
            if token is None:
                if self.logger is not None:
                    self.logger.warn("fleet: lease renewal lost",
                                     key=lease.key[:16])
                return
            lease.token = token

    async def release_lease(self, key: str) -> None:
        lease = self._held.pop(key, None)
        if lease is None:
            return
        if lease.renewer is not None:
            lease.renewer.cancel()
            try:
                await lease.renewer
            except (asyncio.CancelledError, Exception):
                pass
        try:
            await self.coord.delete(LEASES_PREFIX + key, expect=lease.token)
        except asyncio.CancelledError:
            raise
        except Exception as err:
            # the lease simply expires after its TTL: waiters recover
            self._note_coord_error("lease_release", err)

    def lease_snapshot(self) -> List[str]:
        """Content keys this worker currently leads (for heartbeats and
        the admin API)."""
        return sorted(self._held)

    async def reclaim_own_leases(self) -> int:
        """Release leases a previous incarnation of this worker died
        holding (crash-recovery boot path, orchestrator ``_recover``).

        A lease owned by our ``worker_id`` that this process does not
        hold has no renewer — waiters would otherwise sit out the full
        TTL + takeover grace before failing over.  ``try_acquire_lease``
        already reclaims such an orphan when WE next want the content;
        this sweep handles the case where we never will, deleting the
        doc by CAS token so a racing peer takeover is never clobbered.
        Returns the number reclaimed; coordination trouble just stops
        the sweep (expiry remains the backstop).
        """
        reclaimed = 0
        try:
            for key, doc in await self._get_all(LEASES_PREFIX):
                content_key = key[len(LEASES_PREFIX):]
                if doc.get("owner") != self.worker_id:
                    continue
                if content_key in self._held:
                    continue  # live, renewed by this process
                entry = await self.coord.get(key)
                if entry is None or entry[0].get("owner") != self.worker_id:
                    continue  # raced: expired away or taken over
                if not await self.coord.delete(key, expect=entry[1]):
                    continue  # raced: a peer takeover rewrote the token
                reclaimed += 1
                if self.logger is not None:
                    self.logger.info("fleet: reclaimed orphan lease",
                                     key=content_key[:16])
        except asyncio.CancelledError:
            raise
        except Exception as err:
            self._note_coord_error("lease_reclaim", err)
        return reclaimed

    # -- shared cache tier ----------------------------------------------
    def _shared_name(self, key: str, rel: str = "") -> str:
        if rel:
            return posixpath.join(self.shared_prefix + key, "files", rel)
        return posixpath.join(self.shared_prefix + key, MANIFEST_NAME)

    def shared_name(self, key: str, rel: str = "") -> str:
        """Public object-name resolver for external walkers (the
        integrity scrubber re-hashes shared-tier payloads by name)."""
        return self._shared_name(key, rel)

    async def publish_entry(self, key: str, cache,
                            trace: Optional[dict] = None,
                            fence: Optional[int] = None) -> bool:
        """Spill the local cache entry for ``key`` to the shared tier.

        Payload objects first, ``manifest.json`` LAST — the manifest is
        the publish, exactly like the local cache's rename.  Idempotent:
        an existing manifest means a peer (or an earlier attempt)
        already published this content.  Best-effort: failures are
        logged and counted, never raised into the job.

        ``fence`` is the writer's lease fence.  The spill is FENCED:
        rejected before a single payload byte moves when a higher fence
        has been observed (a peer took over this lease while we were
        stalled — our entry is presumptively stale), stamped into the
        manifest, and read-back-verified after the publish so a
        concurrent newer writer's manifest is never mistaken for ours.
        """
        if self.store is None:
            return False
        try:
            raw = await self.store.get_object(
                self.shared_bucket, self._shared_name(key))
            try:
                self._observe_fence(key, _json_load(raw).get("fence"))
            except (ValueError, KeyError, TypeError):
                pass
            return True  # already published
        except ObjectNotFound:
            pass
        except Exception as err:
            self._note_coord_error("shared_probe", err)
            return False
        if fence is not None and not await self.fence_holds(key, fence):
            # a stale leader must lose BEFORE staging bytes: zero
            # payload objects land, not just a suppressed manifest
            self._note_fenced_write("shared_manifest", key, int(fence),
                                    self.observed_fence(key))
            return False
        try:
            async with cache.pinned(key):
                # pin BEFORE the lookup: the entry cannot be evicted
                # between reading its manifest and streaming its files
                entry = await cache.lookup(key)
                if entry is None:
                    return False
                src_dir = cache.entry_path(key)
                # consume=True where the store takes it: a sealed cache
                # entry is immutable (aliasing is all the contract
                # permits), so a co-located filesystem store ingests the
                # spill by hardlink — O(1) instead of a byte copy per
                # file.  Eviction later just unlinks the cache's name;
                # the store's link keeps the inode alive.
                spill_kwargs = (
                    {"consume": True}
                    if _fput_supports(self.store, "consume") else {})
                for rel in entry.files:
                    await self.store.fput_object(
                        self.shared_bucket, self._shared_name(key, rel),
                        os.path.join(src_dir, *rel.split("/")),
                        **spill_kwargs,
                    )
                manifest = {
                    "key": key,
                    "size": entry.size,
                    "files": list(entry.files),
                    "worker": self.worker_id,
                    "created": round(time.time(), 3),
                }
                if getattr(entry, "digests", None):
                    # per-file landing digests: fetchers verify BEFORE
                    # serving (a corrupt leader copy must not hand out
                    # bytes — or its inode), and the scrubber re-walks
                    # these forever
                    manifest["digests"] = dict(entry.digests)
                if fence is not None:
                    # the writer's authority, carried on the document
                    # so any reader (and the read-back below) can
                    # order competing publishes
                    manifest["fence"] = int(fence)
                if trace:
                    # the filling job's traceparent: peers materializing
                    # this entry can name the exact origin fetch (trace
                    # + worker) their bytes came from
                    manifest["trace"] = dict(trace)
                await self.store.put_object(
                    self.shared_bucket, self._shared_name(key),
                    _json_bytes(manifest),
                )
                if fence is not None:
                    # CAS-style read-verify (the nonce read-back
                    # posture): if a NEWER-fenced manifest shows on the
                    # read-back, our publish lost the race — count the
                    # save and report failure so nobody trusts our spill
                    raw = await self.store.get_object(
                        self.shared_bucket, self._shared_name(key))
                    try:
                        back = _json_load(raw)
                    except ValueError:
                        back = {}
                    back_fence = back.get("fence")
                    self._observe_fence(key, back_fence)
                    if (isinstance(back_fence, int)
                            and back_fence > int(fence)):
                        self._note_fenced_write(
                            "shared_manifest", key, int(fence),
                            back_fence)
                        return False
        except Exception as err:
            self._note_coord_error("shared_publish", err)
            return False
        self.stats["sharedFills"] += 1
        self.stats["sharedBytesOut"] += entry.size
        if self.metrics is not None:
            self.metrics.fleet_shared_fills.inc()
            self.metrics.fleet_shared_bytes.labels(
                direction="out").inc(entry.size)
        if self.logger is not None:
            self.logger.info("fleet: published cache entry to shared tier",
                             key=key[:16], bytes=entry.size)
        return True

    async def fetch_entry(self, key: str, cache, record=None) -> bool:
        """Materialize a shared-tier entry into the LOCAL cache.

        Streams the manifest's files into a pid-tagged staging dir on
        the cache volume (crash-orphans are swept by the cache's own
        startup policy) and fills via :meth:`ContentCache.insert`, so
        the job then hardlink-serves from the local cache like any warm
        hit.  False on miss or any trouble — never raises.
        """
        if self.store is None:
            return False
        try:
            raw = await self.store.get_object(
                self.shared_bucket, self._shared_name(key))
        except ObjectNotFound:
            return False
        except Exception as err:
            self._note_coord_error("shared_probe", err)
            return False
        try:
            manifest = _json_load(raw)
            files = list(manifest["files"])
        except (ValueError, KeyError, TypeError):
            if self.logger is not None:
                self.logger.warn("fleet: corrupt shared-tier manifest",
                                 key=key[:16])
            return False
        # remember the publisher's fence: a later stale write attempt
        # for this key is rejectable from the local memo alone
        self._observe_fence(key, manifest.get("fence"))
        if await cache.lookup(key) is not None:
            return True  # already local (a concurrent fill won)
        staging = os.path.join(
            cache.staging_dir,
            f"{key}.{os.getpid()}.fleet{os.urandom(3).hex()}",
        )
        # peer hardlink tier: a CO-LOCATED store (filesystem-backed,
        # same host/volume fleet) exposes the object's on-disk path —
        # materialize by hardlink, zero bucket round-trip and zero byte
        # movement.  Anything else (remote store, cross-device cache
        # volume, no-hardlink fs) streams a copy exactly as before.
        local_path = getattr(self.store, "local_object_path", None)

        def _materialize_linked(src: str, dst: str) -> bool:
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            try:
                os.link(src, dst)
                return True
            except OSError:
                # EXDEV / EPERM / EMLINK: the streaming path below is
                # the byte-exact fallback
                return False

        digests = manifest.get("digests")
        if not isinstance(digests, dict):
            digests = {}
        try:
            size = 0
            linked = 0
            for rel in files:
                parts = [p for p in rel.split("/")
                         if p not in ("", ".", "..")]
                if not parts:
                    continue
                local = os.path.join(staging, *parts)
                name = self._shared_name(key, rel)
                src = local_path(self.shared_bucket, name) \
                    if local_path is not None else None
                used_link = bool(
                    src is not None and await asyncio.to_thread(
                        _materialize_linked, src, local))
                if used_link:
                    linked += 1
                else:
                    await self.store.fget_object(
                        self.shared_bucket, name, local)
                want = digests.get(rel)
                if want is not None:
                    # integrity gate BEFORE the bytes become servable
                    # (and before cache.insert can hardlink them into
                    # workdirs): a corrupt leader copy falls back to
                    # the origin path, it never hands out its inode
                    mark = time.monotonic()
                    got_md5 = await asyncio.to_thread(md5_file_hex,
                                                      local)
                    if record is not None:
                        record.note_hop("hash", os.path.getsize(local),
                                        time.monotonic() - mark)
                    if got_md5 != want:
                        self.stats["sharedCorrupt"] += 1
                        if record is not None:
                            record.event("shared_corrupt", key=key[:16],
                                         rel=rel, linked=used_link)
                        if self.logger is not None:
                            self.logger.warn(
                                "fleet: shared-tier entry failed digest "
                                "verification, falling back to origin",
                                key=key[:16], rel=rel, linked=used_link)
                        return False
                size += os.path.getsize(local)
            entry = await cache.insert(key, staging, digests=digests)
        except Exception as err:
            self._note_coord_error("shared_fetch", err)
            return False
        finally:
            await asyncio.to_thread(shutil.rmtree, staging, True)
        got = entry.size if entry is not None else size
        if record is not None:
            # byte weight for the shared_fetch hop: coordinate() bills
            # the seconds, this note carries the bytes, and together the
            # ledger gets a real seconds-per-GB for peer materialization
            record.note_hop("shared_fetch", got, 0.0)
        if record is not None:
            # provenance on the waiter's own timeline: whose origin
            # fetch (worker + trace) these bytes actually came from
            origin = {"worker": manifest.get("worker")}
            remote = parse_traceparent(
                (manifest.get("trace") or {}).get("traceparent"))
            if remote is not None:
                origin["originTraceId"] = remote.trace_id
                origin["originJobId"] = (manifest.get("trace")
                                         or {}).get("jobId")
            record.event("shared_origin", key=key[:16], bytes=got,
                         linked=linked, **origin)
        self.stats["sharedHits"] += 1
        self.stats["sharedBytesIn"] += got
        if self.metrics is not None:
            self.metrics.fleet_shared_hits.inc()
            self.metrics.fleet_shared_bytes.labels(
                direction="in").inc(got)
        if self.logger is not None:
            self.logger.info("fleet: materialized shared-tier entry",
                             key=key[:16], bytes=got)
        return True

    # -- cross-worker trace digests -------------------------------------
    def _digest(self, record) -> dict:
        """One settled job's compact timeline digest — the document the
        cross-worker trace assembly (control/trace.py) joins with the
        other workers' segments.  Bounded: the event tail is capped at
        :data:`DIGEST_EVENT_LIMIT` (events are already small, truncated
        dicts), so a digest stays a few KB."""
        hops = getattr(record, "hops", None)
        digest = {
            "traceId": record.trace_id,
            "spanId": record.span_id,
            "jobId": record.job_id,
            "workerId": self.worker_id,
            "state": record.state,
            "stage": record.stage,
            "stageSeconds": {k: round(v, 3)
                             for k, v in record.stage_seconds.items()},
            "hopLedger": hops.summary() if hops is not None and hops
            else None,
            "events": record.recorder.tail(DIGEST_EVENT_LIMIT),
            "settledAt": round(time.time(), 3),
        }
        fence = getattr(record, "fleet_fence", None)
        if fence:
            # the lease fence this job's authority derived from: a
            # stale leader's late digest must not clobber the digest
            # the real (higher-fenced) settle already published
            digest["fence"] = int(fence)
        return digest

    async def publish_telemetry(self, record) -> bool:
        """Publish a settled job's timeline digest to the coordination
        store at ``telemetry/<trace_id>/<worker_id>/<job_id>``.

        Keyed per JOB: a submitter may stamp one traceparent across a
        whole batch, and one worker settling several of those jobs must
        not clobber its earlier digests in a shared per-worker slot.
        Best-effort (a digest is observability, never worth a job or a
        settle delay — the orchestrator fires this as a detached task)
        and bounded: digests age out of the store after
        ``fleet.telemetry_ttl`` via the fleet GC sweep.
        """
        trace_id = getattr(record, "trace_id", None)
        if self.telemetry_ttl <= 0 or not trace_id:
            return False
        key = (f"{TELEMETRY_PREFIX}{trace_id}/{self.worker_id}/"
               f"{record.job_id}")
        fence = getattr(record, "fleet_fence", None)
        content_key = getattr(record, "fleet_fence_key", None)
        if fence and content_key and not await self.fence_holds(
                content_key, fence):
            # a stale leader's settle: its timeline describes work a
            # higher-fenced peer superseded — reject rather than
            # present split-brain observability as truth
            self._note_fenced_write("telemetry", content_key,
                                    int(fence),
                                    self.observed_fence(content_key))
            return False
        try:
            # unconditional otherwise: this worker owns its own digest
            # slot, and a redelivered job's later settle should win
            await self.coord.put(key, self._digest(record), expect=ANY)
        except asyncio.CancelledError:
            raise
        except Exception as err:
            if self.metrics is not None:
                self.metrics.fleet_telemetry.labels(op="error").inc()
            self._note_coord_error("telemetry_publish", err)
            return False
        self.stats["telemetryPublished"] += 1
        if self.metrics is not None:
            self.metrics.fleet_telemetry.labels(op="published").inc()
        return True

    async def fetch_telemetry(self, trace_id: str) -> List[dict]:
        """Every worker's digest for ``trace_id`` (empty when none).
        Coordination trouble RAISES — the trace assembler downgrades to
        its local-only view and says so, instead of silently presenting
        a partial fleet picture as complete."""
        docs = [doc for _key, doc in await self._get_all(
            TELEMETRY_PREFIX + trace_id + "/")]
        if self.metrics is not None and docs:
            self.metrics.fleet_telemetry.labels(
                op="fetched").inc(len(docs))
        return docs

    # -- fleet overview --------------------------------------------------
    def overview_age(self) -> Optional[float]:
        """Seconds since the overview doc this worker last published or
        read was written (wall clocks — heartbeats already compare
        them); None until any overview has been seen.  The
        ``fleet_overview_age_seconds`` gauge's source: in steady state
        every worker refreshes its stamp each heartbeat, so a climbing
        age means the aggregation (or the coordination store) stalled.
        """
        if self._overview_updated_at is None:
            return None
        return max(time.time() - self._overview_updated_at, 0.0)

    def _note_overview(self, doc: Optional[dict]) -> None:
        if doc is None:
            return
        try:
            self._overview_updated_at = float(doc.get("updatedAt", 0))
        except (TypeError, ValueError):
            pass

    async def _overview_tick(self) -> None:
        """One heartbeat's worth of overview work.

        Cheap-by-default election (the GC-sweeper discipline,
        without paying a membership listing on every worker every
        beat): read the one overview doc first — if it is FRESH and
        someone else wrote it, this worker's job is just to note the
        age.  Only when the doc is stale/absent (the aggregator died)
        or this worker wrote it last does it pay the listing, re-check
        the oldest-live-worker election, and fold.  Self-stabilizing:
        an aggregator's death makes the doc stale within ~2 beats,
        every survivor then runs the election, the oldest wins, the
        rest settle back to one GET per beat.
        """
        doc = await self._overview_read_cached()
        self._note_overview(doc)
        if doc is not None and doc.get("updatedBy") != self.worker_id:
            age = time.time() - float(doc.get("updatedAt", 0) or 0)
            if age < 2.0 * self.heartbeat_interval:
                return  # a live aggregator owns it
        workers = await self.workers()
        if not workers or workers[0].get("workerId") != self.worker_id:
            # not the oldest live worker — or an EMPTY liveness view
            # (our own registration failed, or a partition/clock issue
            # expired every heartbeat doc): stand down rather than
            # have every worker "win" the election and publish an
            # empty-members overview each beat mid-incident.  The doc
            # just ages, which the staleness gauge surfaces honestly.
            return
        fresh = build_overview(self.worker_id, workers)
        await self.coord.put(OVERVIEW_KEY, fresh, expect=ANY)
        self._overview_doc = fresh
        self._note_overview(fresh)

    async def _overview_read_cached(self) -> Optional[dict]:
        """The overview doc via the watch plane.

        Drains pending change events into the local cache (free on the
        event-driven backend, one bounded scan on the poll-watch one)
        instead of a fresh GET per read; falls back to the direct GET —
        the degraded poll path, counted on
        ``fleet_watch_wakeups_total{mode="poll"}`` — whenever the watch
        is unavailable or broke.  Store trouble on that fallback RAISES
        exactly like the read this replaced.
        """
        if self._overview_watch is None and self.watch_enabled:
            watch = self._open_watch(OVERVIEW_KEY)
            if watch is not None:
                self._overview_watch = watch
                try:
                    # read-then-watch: arm the snapshot, seed the cache
                    # once, then live on change events alone
                    await watch.next(0)
                    entry = await self.coord.get(OVERVIEW_KEY)
                    self._overview_doc = (entry[0] if entry is not None
                                          else None)
                    return self._overview_doc
                except asyncio.CancelledError:
                    raise
                except Exception as err:
                    self._note_coord_error("watch", err)
                    watch.close()
                    self._overview_watch = None
        events = await self._drain_watch(self._overview_watch)
        if events is None:
            if self._overview_watch is not None:
                self._overview_watch.close()
                self._overview_watch = None
            self._note_watch_wakeup("poll")
            entry = await self.coord.get(OVERVIEW_KEY)
            self._overview_doc = entry[0] if entry is not None else None
            return self._overview_doc
        for event in events:
            if event.key == OVERVIEW_KEY:
                self._overview_doc = event.data
        if events:
            self._note_watch_wakeup("event")
        return self._overview_doc

    async def fetch_overview(self) -> Optional[dict]:
        """The current fleet-overview doc (None when absent), bounded
        by :data:`OVERVIEW_FETCH_BUDGET` — a browned-out coordination
        store costs one bounded wait, never a hung admin read.  Served
        through the watch plane's cache (a quiet watch costs zero store
        round trips on the event-driven backend); raises on
        coordination trouble when the degraded read path has to run
        (incl. the budget expiring): the endpoint downgrades to its
        local view and says so, the trace-assembly degradation
        contract."""
        async with asyncio.timeout(OVERVIEW_FETCH_BUDGET):
            doc = await self._overview_read_cached()
        self._note_overview(doc)
        return doc

    def cached_overview(self, max_age: Optional[float] = None
                        ) -> Optional[dict]:
        """The watch-cached overview doc when fresh enough (default
        bound: 4x the heartbeat interval), else None — the router's
        zero-RTT read; staleness degrades to 'no fleet view', never to
        acting on history."""
        doc = self._overview_doc
        if doc is None:
            return None
        if max_age is None:
            max_age = 4.0 * self.heartbeat_interval
        try:
            age = time.time() - float(doc.get("updatedAt", 0) or 0)
        except (TypeError, ValueError):
            return None
        return doc if age <= max_age else None

    # -- watch-fed views (the router/controller's zero-RTT reads) -------
    async def _refresh_views(self) -> None:
        """One heartbeat's refresh of the lease and plan caches.

        The content router consults both at ADMISSION — once per
        delivery — so they must never cost a store round trip there.
        Instead the heartbeat drains each watch non-blockingly (free on
        the event-driven backend, one bounded scan on the poll-watch
        one) and admission reads plain dicts.  No watch — disabled,
        refused, or broken — degrades to one listing/GET per beat: the
        poll path, counted, never a routing failure.
        """
        await self._refresh_lease_view()
        await self._refresh_plan_view()

    async def _refresh_lease_view(self) -> None:
        opened = False
        if self._lease_watch is None and self.watch_enabled:
            self._lease_watch = self._open_watch(LEASES_PREFIX)
            if self._lease_watch is not None:
                opened = True
                try:
                    await self._lease_watch.next(0)  # arm the snapshot
                except asyncio.CancelledError:
                    raise
                except Exception as err:
                    self._note_coord_error("watch", err)
                    self._lease_watch.close()
                    self._lease_watch = None
                    opened = False
        if not opened and self._lease_watch is not None:
            events = await self._drain_watch(self._lease_watch)
            if events is None:
                self._lease_watch.close()
                self._lease_watch = None
            elif events:
                for event in events:
                    ckey = event.key[len(LEASES_PREFIX):]
                    if event.data is None:
                        self._lease_view.pop(ckey, None)
                    else:
                        self._lease_view[ckey] = event.data
                self._lease_view_ready = True
                self._note_watch_wakeup("event")
                return
            elif self._lease_view_ready:
                return  # watch alive and quiet: the cache is current
        # (re)seed: no watch, a broken one, or one just opened — one
        # listing rebuilds the whole view (read-then-watch / poll path)
        self._lease_view = {
            key[len(LEASES_PREFIX):]: doc
            for key, doc in await self._get_all(LEASES_PREFIX)
        }
        self._lease_view_ready = True
        if self._lease_watch is None:
            self._note_watch_wakeup("poll")

    async def _refresh_plan_view(self) -> None:
        opened = False
        if self._plan_watch is None and self.watch_enabled:
            self._plan_watch = self._open_watch(PLAN_KEY)
            if self._plan_watch is not None:
                opened = True
                try:
                    await self._plan_watch.next(0)  # arm the snapshot
                except asyncio.CancelledError:
                    raise
                except Exception as err:
                    self._note_coord_error("watch", err)
                    self._plan_watch.close()
                    self._plan_watch = None
                    opened = False
        if not opened and self._plan_watch is not None:
            events = await self._drain_watch(self._plan_watch)
            if events is None:
                self._plan_watch.close()
                self._plan_watch = None
            else:
                for event in events:
                    if event.key == PLAN_KEY:
                        self._plan_doc = event.data
                if events:
                    self._note_watch_wakeup("event")
                self._note_plan_age()
                return
        entry = await self.coord.get(PLAN_KEY)
        self._plan_doc = entry[0] if entry is not None else None
        if self._plan_watch is None:
            self._note_watch_wakeup("poll")
        self._note_plan_age()

    def _note_plan_age(self) -> None:
        if self.metrics is None:
            return
        doc = self._plan_doc
        if doc is None:
            self.metrics.fleet_plan_age.set(-1.0)
            return
        try:
            age = max(time.time() - float(doc.get("updatedAt", 0) or 0),
                      0.0)
        except (TypeError, ValueError):
            return
        self.metrics.fleet_plan_age.set(age)

    def current_plan(self, max_age: Optional[float] = None
                     ) -> Optional[dict]:
        """The controller's latest plan doc from the watch-fed cache —
        None when absent or older than ``max_age`` (default 4x the
        heartbeat interval): a controller that stopped planning must
        not steer admission forever on history."""
        doc = self._plan_doc
        if doc is None:
            return None
        if max_age is None:
            max_age = 4.0 * self.heartbeat_interval
        try:
            age = time.time() - float(doc.get("updatedAt", 0) or 0)
        except (TypeError, ValueError):
            return None
        return doc if age <= max_age else None

    def plan_in_force(self) -> Optional[dict]:
        """The plan doc to attribute admissions to: the fresh plan when
        the controller is live, else the last cached doc (a stale plan
        no longer STEERS admission, but it is still the right answer to
        "what plan was in force" for forensic stamping — incident
        bundles and ``slo_breach`` placement context, the design)."""
        fresh = self.current_plan()
        return fresh if fresh is not None else self._plan_doc

    def plan_epoch(self) -> Optional[int]:
        """The epoch of the plan in force, or None before any plan."""
        doc = self.plan_in_force()
        if doc is None:
            return None
        epoch = doc.get("epoch")
        try:
            return int(epoch)
        except (TypeError, ValueError):
            return None

    def route_holder(self, route_key: str) -> Optional[dict]:
        """The live lease doc whose ``routeKey`` matches, served from
        the watch-fed cache (zero store RTTs at admission); None when
        no live holder is known — including before the first view
        refresh, when deferring on a guess would be wrong both ways."""
        if not route_key or not self._lease_view_ready:
            return None
        now = time.time()
        grace = self.lease_ttl * TAKEOVER_GRACE_FRAC
        for ckey, doc in self._lease_view.items():
            if doc.get("routeKey") != route_key:
                continue
            if float(doc.get("expiresAt", 0) or 0) + grace < now:
                continue  # expired: the holder is dead or done
            out = dict(doc)
            out["key"] = ckey
            return out
        return None

    # -- fleet-shared origin-health table -------------------------------
    async def _origin_health_tick(self) -> None:
        """Merge this worker's per-origin EWMAs into the shared table
        every ``fleet.origin_share_interval`` seconds (heartbeat-driven,
        so the cadence floor is the heartbeat interval)."""
        if self.origin_fn is None or self.origin_share_interval <= 0:
            return
        now = time.monotonic()
        if now - self._origin_shared_mono < self.origin_share_interval:
            return
        self._origin_shared_mono = now
        try:
            snapshot = dict(self.origin_fn())
        except Exception as err:  # a bad snapshot must not kill beats
            self._note_coord_error("origin_snapshot", err)
            return
        if snapshot:
            await self.publish_origin_health(snapshot)

    async def publish_origin_health(self, snapshot: Dict[str, dict]
                                    ) -> bool:
        """CAS-merge per-origin throughput rows into ``origins/health``.

        The table has no lease, so the doc's write token IS the fence:
        read, merge newest-observation-wins per origin label, write
        back conditional on the token read.  A lost race re-reads and
        re-merges (bounded laps) — two workers merging concurrently
        both land, neither clobbers.  Best-effort like all coordination:
        False on trouble, never a raised error.
        """
        now = round(time.time(), 3)
        rows: Dict[str, dict] = {}
        for label, row in snapshot.items():
            try:
                rows[str(label)] = {
                    "bps": float(row.get("bps", 0.0) or 0.0),
                    "bytes": int(row.get("bytes", 0) or 0),
                    "at": now,
                    "by": self.worker_id,
                }
            except (TypeError, ValueError, AttributeError):
                continue
        if not rows:
            return False
        try:
            for _ in range(4):
                entry = await self.coord.get(ORIGIN_HEALTH_KEY)
                merged: Dict[str, dict] = {}
                if entry is not None:
                    current = entry[0].get("labels")
                    if isinstance(current, dict):
                        merged.update(current)
                for label, row in rows.items():
                    have = merged.get(label)
                    try:
                        have_at = float((have or {}).get("at", 0) or 0)
                    except (TypeError, ValueError):
                        have_at = 0.0
                    if have is None or have_at <= row["at"]:
                        merged[label] = row
                doc = {"labels": merged, "updatedAt": now,
                       "updatedBy": self.worker_id}
                expect = entry[1] if entry is not None else ABSENT
                if await self.coord.put(ORIGIN_HEALTH_KEY, doc,
                                        expect=expect) is not None:
                    self.stats["originHealthShared"] += 1
                    if self.metrics is not None:
                        self.metrics.fleet_origin_health.labels(
                            op="published").inc()
                    return True
        except asyncio.CancelledError:
            raise
        except Exception as err:
            self._note_coord_error("origin_health", err)
            return False
        self._note_coord_error(
            "origin_health",
            CoordError("origin-health CAS merge: retries exhausted"))
        return False

    async def fetch_origin_health(
            self, max_age: float = ORIGIN_HEALTH_MAX_AGE
    ) -> Dict[str, dict]:
        """Fleet origin-health rows fresh enough to seed a booting
        worker's OriginHealth ({} on any trouble — the seed is a
        best-effort head start, never worth delaying boot)."""
        try:
            entry = await self.coord.get(ORIGIN_HEALTH_KEY)
        except asyncio.CancelledError:
            raise
        except Exception as err:
            self._note_coord_error("origin_health", err)
            return {}
        if entry is None:
            return {}
        labels = entry[0].get("labels")
        if not isinstance(labels, dict):
            return {}
        now = time.time()
        out: Dict[str, dict] = {}
        for label, row in labels.items():
            try:
                if (max_age > 0
                        and now - float(row.get("at", 0) or 0) > max_age):
                    continue  # stale history, not a head start
                out[str(label)] = dict(row)
            except (TypeError, ValueError, AttributeError):
                continue
        if out and self.metrics is not None:
            self.metrics.fleet_origin_health.labels(op="seeded").inc()
        return out

    # -- shared-tier / tombstone GC -------------------------------------
    async def _should_gc(self) -> bool:
        """Elect one sweeper per interval: the OLDEST live worker.

        Every worker running the identical global sweep would multiply
        the same listing + per-key reads N times for no extra garbage
        collected; the registry's liveness view is already a cheap,
        crash-tolerant election (the oldest worker dying just hands the
        sweep to the next-oldest within liveness_ttl).  Solo workers —
        and workers that cannot read the registry at all — sweep: a
        degraded registry must not also mean unbounded garbage.
        """
        try:
            live = await self.workers()
        except Exception:
            return True
        if not live:
            return True
        return live[0].get("workerId") == self.worker_id

    async def _gc_loop(self) -> None:
        while True:
            await asyncio.sleep(self.gc_interval)
            try:
                if await self._should_gc():
                    await self.gc_once()
            except asyncio.CancelledError:
                raise
            except Exception as err:
                self._note_coord_error("gc", err)

    async def _remove_entry(self, key: str, names_sizes) -> int:
        """Evict one shared-tier entry: manifest FIRST (unpublish — a
        reader mid-materialize already holds the file list and tolerates
        missing objects as a failed fetch), then the payload objects.
        Returns the bytes reclaimed."""
        reclaimed = 0
        manifest_name = self._shared_name(key)
        ordered = sorted(names_sizes, key=lambda ns: ns[0] != manifest_name)
        for name, size in ordered:
            await self.store.remove_object(self.shared_bucket, name)
            reclaimed += size
        return reclaimed

    async def gc_once(self) -> dict:
        """One bounded sweep over the shared tier + coordination prefix.

        - evicts ``.fleet-cache/<key>/`` entries whose manifest is older
          than ``fleet.shared_max_age``, then (oldest first) until total
          size fits ``fleet.shared_max_bytes`` (0 = age bound only);
        - reclaims manifest-less entries (torn spills) seen on two
          consecutive sweeps — listings carry no mtime, so "survived a
          full gc_interval without a manifest" is the abandonment proxy;
        - compacts aged ``.fleet/`` tombstones on the bucket coordination
          backend (deletes there only tombstone, so churned lease/worker
          keys otherwise accrete forever).

        Never raises on store backends without delete support — the
        sweep is then a no-op.  Entries under a live content lease —
        this worker's or a peer's (a slow multi-GB spill is manifest-
        less for its whole upload) — are skipped.
        """
        out = {"shared_evicted": 0, "bytes_reclaimed": 0, "tombstones": 0,
               "telemetry": 0}
        if self.store is not None:
            try:
                entries: Dict[str, list] = {}
                async for info in self.store.list_objects(
                        self.shared_bucket, self.shared_prefix):
                    rest = info.name[len(self.shared_prefix):]
                    key = rest.split("/", 1)[0]
                    if key:
                        entries.setdefault(key, []).append(
                            (info.name, info.size))
                # keys under a LIVE content lease are being re-fetched /
                # re-published by some worker right now: never reclaim
                # them mid-flight (the torn-spill heuristic especially —
                # a peer's slow multi-GB spill is manifest-less for its
                # whole upload).  Lease trouble — e.g. an asymmetric
                # partition where shared-tier reads work but the
                # coordination prefix does not — means we CANNOT know
                # what peers hold: skip this sweep's eviction pass
                # entirely rather than treat every key as unleased and
                # evict a live peer's in-flight spill.  Garbage waits
                # one interval; destroyed peer work does not come back.
                try:
                    leased = {doc.get("key") for doc in await self.leases()
                              if not doc.get("expired")}
                except asyncio.CancelledError:
                    raise
                except Exception as err:
                    self._note_coord_error("gc_lease_view", err)
                    raise _GcLeaseViewUnavailable from err
                now = time.time()
                # manifest "created" stamps are immutable once published:
                # remember them across sweeps so a steady-state sweep is
                # one LIST + GETs only for newly-appeared keys
                created_memo = self._gc_created
                aged: "List[tuple[float, str]]" = []  # (created, key)
                manifestless: set = set()
                for key, names_sizes in entries.items():
                    if key in self._held or key in leased:
                        continue  # mid-publish (ours or a peer's)
                    manifest_name = self._shared_name(key)
                    if not any(n == manifest_name for n, _s in names_sizes):
                        manifestless.add(key)
                        continue
                    created = created_memo.get(key)
                    if created is None:
                        try:
                            manifest = _json_load(
                                await self.store.get_object(
                                    self.shared_bucket, manifest_name))
                            created = float(manifest.get("created", 0.0))
                        except (ValueError, KeyError, TypeError):
                            created = 0.0  # CORRUPT manifest: ancient
                        except Exception:
                            # store trouble reading a healthy-looking
                            # manifest must not read as "ancient" and
                            # evict good bytes: skip it this sweep
                            continue
                        created_memo[key] = created
                    aged.append((created, key))
                # drop memo entries for keys no longer listed
                self._gc_created = {k: v for k, v in created_memo.items()
                                    if k in entries}
                evict: List[str] = []
                kept: List[tuple] = []
                for created, key in sorted(aged):
                    if (self.shared_max_age > 0
                            and now - created >= self.shared_max_age):
                        evict.append(key)
                    else:
                        kept.append((created, key))
                if self.shared_max_bytes > 0:
                    total = sum(
                        sum(s for _n, s in entries[key])
                        for _c, key in kept
                    )
                    for _created, key in kept:  # oldest first
                        if total <= self.shared_max_bytes:
                            break
                        evict.append(key)
                        total -= sum(s for _n, s in entries[key])
                # torn spills: reclaim only on the second consecutive
                # manifest-less sighting
                evict.extend(k for k in manifestless
                             if k in self._gc_manifestless)
                self._gc_manifestless = manifestless
                for key in evict:
                    try:
                        reclaimed = await self._remove_entry(
                            key, entries[key])
                    except NotImplementedError:
                        break  # backend cannot delete: GC is a no-op
                    out["shared_evicted"] += 1
                    out["bytes_reclaimed"] += reclaimed
                    if self.logger is not None:
                        self.logger.info("fleet gc: evicted shared entry",
                                         key=key[:16], bytes=reclaimed)
            except asyncio.CancelledError:
                raise
            except _GcLeaseViewUnavailable:
                pass  # noted as gc_lease_view; eviction waits a sweep
            except Exception as err:
                self._note_coord_error("gc_shared", err)
        # per-job trace digests: every settled job writes one, so without
        # this sweep the telemetry prefix grows one doc per job forever.
        # A digest's useful life is an incident window, not an archive —
        # aged ones are deleted (token-CAS, so a concurrent republish
        # from a redelivery is never clobbered).  Swept at the DEFAULT
        # ttl even by a worker whose own publishing is off
        # (telemetry_ttl 0): peers may still publish, and the elected
        # sweeper is the only one who ever cleans up after them.
        telemetry_ttl = (self.telemetry_ttl if self.telemetry_ttl > 0
                         else DEFAULT_TELEMETRY_TTL)
        try:
            now = time.time()
            for key in await self.coord.list_keys(TELEMETRY_PREFIX):
                entry = await self.coord.get(key)
                if entry is None:
                    continue
                doc, token = entry
                if now - float(doc.get("settledAt", 0) or 0) \
                        < telemetry_ttl:
                    continue
                if await self.coord.delete(key, expect=token):
                    out["telemetry"] += 1
        except asyncio.CancelledError:
            raise
        except Exception as err:
            self._note_coord_error("gc_telemetry", err)
        # coordination-store census (``fleet_coord_docs_total{prefix}``):
        # sampled here — post-sweep, by the elected sweeper only — so the
        # growth gauges cost list RTTs once per gc_interval, never per
        # scrape.  A census failure degrades to stale gauges, not a
        # failed sweep.
        if self.metrics is not None:
            for prefix in (WORKERS_PREFIX, LEASES_PREFIX,
                           TELEMETRY_PREFIX):
                try:
                    docs = len(await self.coord.list_keys(prefix))
                except asyncio.CancelledError:
                    raise
                except Exception as err:
                    self._note_coord_error("gc_census", err)
                    break
                self.metrics.coord_docs.labels(
                    prefix=prefix.rstrip("/")).set(docs)
        sweep = getattr(self.coord, "sweep_tombstones", None)
        if sweep is not None:
            # a tombstone is compactable once every CAS that could have
            # referenced its token has aged out with the lease/liveness
            # TTLs; 4x the larger one is comfortably past any skew grace
            try:
                out["tombstones"] = await sweep(
                    max(self.lease_ttl, self.liveness_ttl) * 4
                )
            except asyncio.CancelledError:
                raise
            except Exception as err:
                self._note_coord_error("gc_tombstones", err)
        self.stats["gcSharedEvicted"] += out["shared_evicted"]
        self.stats["gcBytesReclaimed"] += out["bytes_reclaimed"]
        self.stats["gcTombstonesCompacted"] += out["tombstones"]
        self.stats["gcTelemetryEvicted"] += out["telemetry"]
        if self.metrics is not None:
            if out["shared_evicted"]:
                self.metrics.fleet_gc_removed.labels(
                    kind="shared_entry").inc(out["shared_evicted"])
            if out["tombstones"]:
                self.metrics.fleet_gc_removed.labels(
                    kind="tombstone").inc(out["tombstones"])
            if out["telemetry"]:
                self.metrics.fleet_gc_removed.labels(
                    kind="telemetry").inc(out["telemetry"])
            if out["bytes_reclaimed"]:
                self.metrics.fleet_gc_bytes.inc(out["bytes_reclaimed"])
        return out

    # -- the cross-worker singleflight protocol -------------------------
    async def coordinate(self, key: str, cache, origin_fill, *,
                         cancel=None, record=None, registry=None,
                         slot=None, logger=None,
                         route_key: Optional[str] = None) -> str:
        """Fetch-or-wait for content ``key`` fleet-wide.

        ``origin_fill`` is the caller's fetch-and-fill-local-cache
        coroutine factory; it runs iff this worker wins the lease.
        Returns :data:`LED` (we fetched and spilled), :data:`SHARED`
        (a peer's bytes are now in the LOCAL cache — the caller
        materializes from there), or :data:`UNCOORDINATED`
        (coordination unavailable / wait bound hit: the caller fetches
        alone).  Coordination-store trouble can never raise out of
        here; ``origin_fill``'s own errors propagate (they are job
        errors, and the lease is released so a peer takes over).

        A waiter is pure idle time, so alongside the PARKED transition
        it gives back its run slot (``slot`` — a
        :class:`~..control.scheduler.RunSlot`) for runnable jobs and
        reacquires it before resuming.  The *delivery* stays unsettled
        throughout: with ``scheduler_backlog`` 0 and one run slot the
        broker's prefetch window still serializes behind the waiter —
        fan-in deployments size ``max_concurrent_jobs``/backlog for it.
        """
        log = logger or self.logger
        # the livelock bound is a per-JOB budget, not per-attempt: a
        # flapping coordination store used to re-park every redelivery
        # with a fresh max_wait, so the bound never bound.  The record
        # carries the cumulative parked time across coordination errors
        # and redeliveries; an exhausted budget skips parking entirely.
        already_waited = float(getattr(record, "fleet_waited_s", 0.0)
                               or 0.0)
        deadline = time.monotonic() + max(
            self.max_wait - already_waited, 0.0)
        # coordination attribution (the soak's hop-ledger
        # reconciliation flushed this out): lease acquire/release, the
        # shared-entry probe, and shared-tier transfers are real
        # wall-clock inside the download stage — unbilled, they made a
        # coordinated job's ledger account for a fraction of its stage
        # wall.  Three seconds-only hops, by what the time actually
        # was: ``coord`` = the lease ceremony + probe misses (moves no
        # payload bytes, like origin_wait), ``shared_fetch`` = a
        # waiter materializing a peer's content from the shared tier,
        # ``shared_spill`` = the leader publishing its entry there
        # (byte counts for both ride fleet_shared_tier_bytes_total).
        hop_seconds: Dict[str, float] = {}

        def _bill(hop: str, seconds: float) -> None:
            hop_seconds[hop] = hop_seconds.get(hop, 0.0) + seconds

        async def _billed(coro, hop="coord"):
            t0 = time.monotonic()
            try:
                return await coro
            finally:
                _bill(hop, time.monotonic() - t0)

        # the job's W3C trace context rides the lease doc and the
        # shared-tier manifest, so waiters (and later trace assembly)
        # can join this fetch to the trace that caused it
        trace = self._trace_context(record)
        try:
            return await self._coordinate(
                key, cache, origin_fill, cancel=cancel, record=record,
                registry=registry, slot=slot, log=log,
                deadline=deadline, trace=trace, billed=_billed,
                bill=_bill, route_key=route_key)
        finally:
            if record is not None:
                for hop, seconds in hop_seconds.items():
                    if seconds > 0:
                        record.note_hop(hop, 0, seconds)

    async def _coordinate(self, key, cache, origin_fill, *, cancel,
                          record, registry, slot, log, deadline, trace,
                          billed, bill, route_key=None):
        parked = False
        waited = False
        wait_started = None  # first parked wait: the aging clock starts
        lease_watch: Optional[CoordWatch] = None
        try:
            while True:
                try:
                    # 1) a finished leader's bytes beat any lease dance
                    # (a HIT transfers the peer's content — billed as
                    # shared_fetch, not coordination ceremony; the
                    # cheap miss probe stays on the coord hop)
                    probe_started = time.monotonic()
                    hit = await self.fetch_entry(key, cache,
                                                 record=record)
                    bill("shared_fetch" if hit else "coord",
                         time.monotonic() - probe_started)
                    if hit:
                        if record is not None:
                            record.event("fleet", outcome="shared",
                                         key=key[:16])
                        return SHARED
                    # 2) contend for the content lease
                    lease = await billed(self._coord_op(
                        "coord.lease",
                        lambda: self.try_acquire_lease(
                            key, trace, route_key=route_key),
                        cancel=cancel,
                    ))
                except (JobCancelled, asyncio.CancelledError):
                    raise  # cancellation settles the job, not the fleet
                except Exception as err:
                    # CoordError, an open "coord" breaker, anything the
                    # store threw raw: degrade, never fail the job
                    self._note_coord_error("lease_acquire", err)
                    self.stats["uncoordinatedFallbacks"] += 1
                    if record is not None:
                        record.event("fleet", outcome="uncoordinated",
                                     key=key[:16])
                    return UNCOORDINATED
                if lease is not None:
                    break  # we lead
                # 3) a live peer leads: park and poll for its publish
                if not waited:
                    waited = True
                    self.stats["leaseWaits"] += 1
                    if self.metrics is not None:
                        self.metrics.fleet_lease_waits.inc()
                    if record is not None:
                        # name the leader this wait is actually behind:
                        # its worker id and — when the lease doc carries
                        # a traceparent — the leader job's trace id, the
                        # link GET /v1/trace follows to merge the
                        # leader's fetch into this waiter's timeline
                        leader_fields: Dict[str, Any] = {}
                        try:
                            entry = await self.coord.get(
                                LEASES_PREFIX + key)
                        except Exception:
                            entry = None  # wait event still emits bare
                        if entry is not None:
                            doc = entry[0]
                            self._observe_fence(key, doc.get("fence"))
                            leader_fields["leaderWorker"] = doc.get(
                                "owner")
                            remote = parse_traceparent(
                                (doc.get("trace") or {}).get(
                                    "traceparent"))
                            if remote is not None:
                                leader_fields["leaderTraceId"] = \
                                    remote.trace_id
                                leader_fields["leaderJobId"] = (
                                    doc.get("trace") or {}).get("jobId")
                        record.event("fleet", outcome="wait",
                                     key=key[:16], **leader_fields)
                if not parked and record is not None and registry is not None:
                    parked = True
                    if self.metrics is not None:
                        self.metrics.jobs_parked.labels(reason="fleet").inc()
                    registry.transition(
                        record, "PARKED",
                        reason=f"fleet_lease_wait: {key[:16]}",
                    )
                    if slot is not None:
                        # idle wait: a runnable job must not queue
                        # behind it (same discipline as the delayed-
                        # redelivery park)
                        slot.release()
                if time.monotonic() >= deadline:
                    if log is not None:
                        log.warn("fleet: lease wait bound hit, fetching "
                                 "uncoordinated", key=key[:16])
                    self.stats["uncoordinatedFallbacks"] += 1
                    if record is not None:
                        record.event("fleet", outcome="wait_timeout",
                                     key=key[:16])
                    return UNCOORDINATED
                if wait_started is None:
                    wait_started = time.monotonic()
                    if self.watch_enabled and lease_watch is None:
                        # subscribe to the ONE lease doc this wait is
                        # parked on: the leader's release wakes the
                        # waiter immediately instead of on the next
                        # poll lap (None = watch refused: sleep-poll)
                        lease_watch = self._open_watch(
                            LEASES_PREFIX + key)
                waiter = self._waiter_wait(lease_watch, deadline)
                if cancel is not None:
                    lease_watch = await cancel.guard(waiter)
                else:
                    lease_watch = await waiter
        finally:
            if lease_watch is not None:
                lease_watch.close()
            if record is not None and wait_started is not None:
                # age the per-job wait budget on EVERY exit — lease won,
                # degraded to uncoordinated, timed out, cancelled — so
                # the next attempt (after a flap or redelivery) resumes
                # the countdown instead of restarting it
                record.fleet_waited_s = (
                    float(getattr(record, "fleet_waited_s", 0.0) or 0.0)
                    + (time.monotonic() - wait_started))
            if parked:
                try:
                    if slot is not None:
                        # queue for a run slot again (priority + aging
                        # apply as usual) before resuming the stage; a
                        # cancellation here still closes the record via
                        # the transition below + the orchestrator
                        if cancel is not None:
                            await cancel.guard(slot.reacquire())
                        else:
                            await slot.reacquire()
                finally:
                    # back to RUNNING under the stage we parked in (the
                    # PARKED -> RUNNING edge exists for exactly this
                    # resume)
                    registry.transition(record, "RUNNING",
                                        stage=record.stage)
        # -- leader path --------------------------------------------------
        if record is not None:
            # the fence this job's write authority derives from: rides
            # the record into the shared-tier spill, the done-marker
            # seal (stages/upload.py), and the telemetry digest
            record.fleet_fence = lease.fence
            record.fleet_fence_key = key
            record.event("fleet", outcome="lead", key=key[:16],
                         fence=lease.fence)
        try:
            await origin_fill()
            await billed(self.publish_entry(key, cache, trace=trace,
                                            fence=lease.fence),
                         "shared_spill")
        finally:
            await billed(self.release_lease(key))
        return LED


def build_overview(worker_id: str, workers: List[dict]) -> dict:
    """Fold live worker heartbeat docs into the one fleet-overview doc.

    Pure (unit-testable without a store).  Rolling-upgrade tolerant by
    contract: a worker publishing the pre-digest heartbeat shape is
    listed with ``digest: null`` and simply contributes nothing to the
    digest-derived totals — a mixed fleet aggregates, never errors.

    Totals:
    - ``queueDepth``/``activeJobs`` — summed autoscale signals;
    - ``tenantQueued``/``tenantShares`` — the first fleet-WIDE tenant
      fairness view (each worker only ever saw its own apportionment);
    - ``burn`` (worst-of-fleet per objective/window) and ``budget``
      (min-of-fleet) — one sick worker must show, not average away;
    - ``openBreakers`` — per worker, with open reasons;
    - ``topHops`` — fleet seconds-per-GB per hop (summed seconds over
      summed bytes), worst three: where the fleet's gigabyte-time goes;
    - ``cpuSPerGb`` — the fleet's staging copy cost (summed COPY_HOPS
      seconds over the widest copy hop's bytes): the zero-copy
      ratchet's live headline, null until enough bytes moved;
    - ``hopReconcileRatioMixed`` — summed hop seconds over summed
      stage seconds across the fleet (the soak's unguarded mixed-phase
      attribution stat, surfaced live so drift is at least visible);
    - ``scrub`` — summed integrity-scrubber verdict counters
      (clean/repaired/quarantined) across the fleet: repaired/
      quarantined climbing is a disk going bad somewhere.
    """
    from ..control.slo import top_hops

    members: List[dict] = []
    tenant_queued: Dict[str, int] = {}
    burn: Dict[str, Dict[str, float]] = {}
    budget: Dict[str, float] = {}
    open_breakers: Dict[str, dict] = {}
    hop_totals: Dict[str, dict] = {}
    queue_depth = 0
    active_jobs = 0
    hop_seconds_sum = 0.0
    stage_seconds_sum = 0.0
    scrub_totals = {"clean": 0, "repaired": 0, "quarantined": 0}
    for doc in workers:
        wid = doc.get("workerId")
        signals = doc.get("signals")
        digest = doc.get("digest")
        if not isinstance(digest, dict):
            digest = None  # pre-PR-15 heartbeat shape: listed, null
        members.append({
            "workerId": wid,
            "startedAt": doc.get("startedAt"),
            "heartbeatAt": doc.get("heartbeatAt"),
            "leases": len(doc.get("leases") or []),
            "signals": dict(signals) if isinstance(signals, dict)
            else None,
            "digest": digest,
        })
        if isinstance(signals, dict):
            queue_depth += int(signals.get("queue_depth", 0) or 0)
            active_jobs += int(signals.get("active_jobs", 0) or 0)
        if digest is None:
            continue
        for name, rates in (digest.get("burn") or {}).items():
            worst = burn.setdefault(name, {"fast": 0.0, "slow": 0.0})
            for window in ("fast", "slow"):
                try:
                    worst[window] = max(
                        worst[window],
                        float((rates or {}).get(window, 0.0) or 0.0))
                except (TypeError, ValueError):
                    pass
        for name, remaining in (digest.get("budget") or {}).items():
            try:
                remaining = float(remaining)
            except (TypeError, ValueError):
                continue
            budget[name] = min(budget.get(name, 1.0), remaining)
        breakers = digest.get("openBreakers") or {}
        if breakers:
            open_breakers[wid] = dict(breakers)
        for tenant, depth in (digest.get("tenantQueued") or {}).items():
            try:
                tenant_queued[tenant] = (tenant_queued.get(tenant, 0)
                                         + int(depth))
            except (TypeError, ValueError):
                pass
        scrub_doc = digest.get("scrub")
        if isinstance(scrub_doc, dict):
            for outcome in ("clean", "repaired", "quarantined"):
                try:
                    scrub_totals[outcome] += int(
                        scrub_doc.get(outcome, 0) or 0)
                except (TypeError, ValueError):
                    pass
        for hop, entry in (digest.get("hops") or {}).items():
            if not isinstance(entry, dict):
                continue
            total = hop_totals.setdefault(
                hop, {"bytes": 0, "seconds": 0.0})
            try:
                total["bytes"] += int(entry.get("bytes", 0) or 0)
                total["seconds"] += float(entry.get("seconds", 0.0)
                                          or 0.0)
            except (TypeError, ValueError):
                pass
        try:
            hop_seconds_sum += float(digest.get("hopSeconds", 0.0)
                                     or 0.0)
            stage_seconds_sum += float(digest.get("stageSeconds", 0.0)
                                       or 0.0)
        except (TypeError, ValueError):
            pass
    # fleet staging copy cost: same COPY_HOPS/widest-hop discipline as
    # HopLedger.copy_seconds_per_gb, over the fleet-summed totals
    from ..platform.obs import COPY_HOPS, HopLedger

    copy_seconds = 0.0
    copy_weight = 0
    for hop, entry in hop_totals.items():
        if hop in COPY_HOPS:
            copy_seconds += entry["seconds"]
            copy_weight = max(copy_weight, entry["bytes"])
    cpu_s_per_gb = (
        round(copy_seconds / (copy_weight / 1e9), 3)
        if copy_weight >= HopLedger.MIN_OBSERVE_BYTES else None
    )
    total_queued = sum(tenant_queued.values())
    tenant_shares = {
        tenant: round(depth / total_queued, 4)
        for tenant, depth in sorted(tenant_queued.items())
    } if total_queued else {}
    return {
        "updatedAt": round(time.time(), 3),
        "updatedBy": worker_id,
        "workers": members,
        "totals": {
            "workers": len(members),
            "queueDepth": queue_depth,
            "activeJobs": active_jobs,
            "tenantQueued": tenant_queued,
            "tenantShares": tenant_shares,
            "burn": burn,
            "budget": budget,
            "openBreakers": open_breakers,
            "topHops": top_hops(hop_totals),
            "cpuSPerGb": cpu_s_per_gb,
            "scrub": scrub_totals,
            "hopReconcileRatioMixed": round(
                hop_seconds_sum / stage_seconds_sum, 4)
            if stage_seconds_sum > 0 else None,
        },
    }


def _json_bytes(doc: dict) -> bytes:
    return json.dumps(doc, sort_keys=True).encode("utf-8")


def _json_load(raw: bytes) -> dict:
    return json.loads(raw.decode("utf-8"))


# re-exported for callers that build planes by hand (tests, bench)
__all__ = [
    "FleetPlane", "resolve_worker_id", "MemoryCoordStore",
    "BucketCoordStore", "CasBucketCoordStore", "CoordError",
    "LED", "SHARED", "UNCOORDINATED",
    "build_overview", "OVERVIEW_KEY", "PLAN_KEY", "ORIGIN_HEALTH_KEY",
]
