"""Soak profiles and the deterministic mixed-workload schedule.

The workload is the union of every traffic shape the repo has built a
subsystem for, interleaved so they contend the way production traffic
does: cache-hot fan-in (many jobs, one content key — the fleet lease
singleflight's regime), multi-origin racing (mirrors), segment-manifest
ingest (the streaming pipeline's live feed), multi-tenant BULK pressure
with deadlines (the overload layer's regime), and plain per-job HTTP
fetches.  The schedule is a pure function of the profile and the
injected origin endpoints — no randomness, so a failing soak replays
exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ..platform.config import cfg_get
# ONE priority-class tuple repo-wide (the percentile discipline): the
# soak's p99 guards and the live SLO tracker must agree on which
# classes exist — re-exported here under the soak's historical name
from ..control.slo import PRIORITY_CLASSES

# job kinds (the ``kind`` of each JobSpec; job ids carry them too)
HOT = "hot"            # cache-hot fan-in: every hot job shares one URI
RACING = "racing"      # primary + mirror(s): the racing RangeScheduler
MANIFEST = "manifest"  # HLS-style segment playlist ingest
BULK = "bulk"          # BULK priority, deadline-carrying batch tenant
PLAIN = "plain"        # one ordinary HTTP fetch per job
#: the post-workload attribution probe: fresh-content single-stream
#: jobs run SEQUENTIALLY on a quiescent fleet, where stage wall is
#: attributable — the set the hop-ledger reconciliation guard judges
#: (the mixed phase's wall is contention-dominated by design: dozens
#: of concurrent jobs inflate each other's wall clock, which no
#: per-job ledger can or should account for)
PROBE = "probe"

__all__ = ["PRIORITY_CLASSES", "SoakProfile", "WorkloadOrigin",
           "SoakEndpoints", "JobSpec", "SoakWorkload", "download_msg",
           "HOT", "RACING", "MANIFEST", "BULK", "PLAIN", "PROBE"]


@dataclass(frozen=True)
class SoakProfile:
    """One soak run's shape: scale, chaos cadence, and SLO bounds.

    ``smoke`` must stay tier-1 safe (≤ ~60 s wall, single host); the
    ``full`` profile is the slow-marked capacity run.  ``from_config``
    lets operators resize either via the ``soak.*`` knobs without
    editing code (docs/OPERATIONS.md "Capacity & SLOs").
    """

    jobs: int = 60
    workers: int = 2
    #: seconds between SIGKILLs of a round-robin worker (0 = no chaos)
    kill_interval: float = 2.5
    #: SIGKILLs to deliver over the run
    kills: int = 1
    #: SIGSTOP/SIGCONT stall chaos (the degraded profile's regime): a
    #: worker frozen past the lease TTL is a *stalled* leader — alive,
    #: lease expired, resumed mid-takeover — the split-brain shape the
    #: fencing layer exists for.  0 stalls = off.
    stalls: int = 0
    stall_interval: float = 3.0
    stall_duration: float = 0.0
    #: fleet content-lease TTL written into worker configs (the
    #: degraded profile shrinks it so a stall overruns it quickly)
    lease_ttl: float = 8.0
    #: extra ``breakers`` config section for the workers (the degraded
    #: profile arms the store slow-call policy here)
    breakers: Dict[str, dict] = field(default_factory=dict)
    #: extra ``slo`` config section for the workers (tests tighten
    #: objectives so a browned-out worker's burn rate visibly rises)
    slo: Dict[str, dict] = field(default_factory=dict)
    #: ``retry`` config overrides merged over the rig defaults (the
    #: disk profile paces redelivery so a full-disk window can't burn
    #: a job's poison budget before the window closes)
    retry: Dict[str, dict] = field(default_factory=dict)
    #: extra ``scrub`` config section for the workers (the disk
    #: profile shrinks the pass interval so repairs land in-run)
    scrub: Dict[str, object] = field(default_factory=dict)
    #: shared `.fleet-cache/` entry max age written into worker
    #: configs (the disk profile stretches it so the scrubber's
    #: repair source outlives the bit-rot phase)
    shared_max_age: float = 30.0
    #: cache-entry files to bit-rot AFTER the workload drains (the
    #: scrubber must repair every one from the shared tier) — 0 = off
    corrupt_files: int = 0
    #: max seconds to wait for the scrubber to account for the seeds
    scrub_wall: float = 25.0
    #: wall-clock offset (seconds after worker 0 installs its fault
    #: plan) at which the profile's brownout window opens — kept in
    #: sync with ``fault_plan`` so the rig can anchor the
    #: ``brownout_shed_ms`` measurement
    brownout_start_s: float = 0.0
    #: sampler cadence
    sample_interval: float = 0.5
    #: hard wall for the workload phase (publish -> all jobs resolved)
    max_wall: float = 150.0
    #: per-worker concurrency / prefetch shape
    max_concurrent_jobs: int = 3
    scheduler_backlog: int = 6
    #: journal compaction bound the growth guard is armed against
    journal_max_bytes: int = 256 << 10
    #: fleet GC cadence + telemetry digest TTL (seconds)
    gc_interval: float = 1.25
    telemetry_ttl: float = 3.0
    #: shared `.fleet-cache/` eviction budget (bytes)
    shared_max_bytes: int = 8 << 20
    #: BULK deadline (seconds from receipt; generous — the smoke guards
    #: completion, the deadline machinery rides along armed)
    bulk_ttl: float = 120.0
    #: workload mix (fractions of ``jobs``; manifest is a fixed count —
    #: each manifest job is a multi-segment pipeline, not one fetch)
    hot_fraction: float = 0.25
    racing_fraction: float = 0.15
    bulk_fraction: float = 0.25
    manifest_jobs: int = 2
    #: sequential quiescent-fleet jobs for the hop reconciliation guard
    probe_jobs: int = 3
    #: open-loop arrival rate, jobs/s (0 = publish the whole schedule
    #: up front).  Long profiles MUST pace: with a burst publish, p99
    #: time-to-staged measures queue-drain time (jobs / throughput),
    #: not service under load — the guard would just re-derive the
    #: schedule length
    publish_rate: float = 0.0
    #: transient store faults injected on worker 0's first generation
    #: (exercises the retry/poison counter across the kill chaos)
    fault_plan: str = (
        '[{"seam": "store.put", "kind": "error", "count": 2,'
        ' "after": 4, "fault": "transient"}]'
    )
    # -- SLO bounds -----------------------------------------------------
    #: p99 time-to-staged ceiling per priority class, seconds — sized
    #: for the worst legitimate stall the chaos can cause (kill ->
    #: restart -> redelivery, or a dead lease-holder's takeover at
    #: lease_ttl * 1.25) plus CI-host margin
    p99_ceiling: Dict[str, float] = field(default_factory=lambda: {
        "HIGH": 25.0, "NORMAL": 35.0, "BULK": 60.0,
    })
    #: journal file peak across the run (compaction must hold the line)
    journal_peak_limit: int = 1 << 20
    #: RSS growth ceiling, MB per 1000 completed jobs (max over workers)
    rss_slope_limit_mb_per_kjob: float = 2000.0
    #: `.fleet-cache/` peak bytes (GC budget + one in-flight entry)
    shared_cache_limit: int = 12 << 20
    #: coordination docs at drain: telemetry left unswept (fraction of
    #: jobs) and worker-doc slack over the configured worker count
    telemetry_final_fraction: float = 0.5
    #: |1 - sum(hop seconds)/sum(stage seconds)| tolerance over the
    #: reconciliation set (DONE jobs that fetched their own bytes)
    hop_reconcile_tolerance: float = 0.10

    @classmethod
    def smoke(cls, **overrides) -> "SoakProfile":
        """The tier-1-safe profile (``make soak-smoke``)."""
        return cls(**overrides)

    @classmethod
    def full(cls, **overrides) -> "SoakProfile":
        """The slow-marked capacity profile (``make soak``)."""
        params = dict(
            jobs=300, workers=3, kill_interval=10.0, kills=3,
            max_wall=600.0, manifest_jobs=6, publish_rate=7.0,
            rss_slope_limit_mb_per_kjob=400.0,
        )
        params.update(overrides)
        return cls(**params)

    @classmethod
    def degraded(cls, **overrides) -> "SoakProfile":
        """The degraded-world profile (``make degraded`` / bench v19
        ``--degraded``): no SIGKILLs — instead a SIGSTOP/SIGCONT stall
        that overruns the (shortened) lease TTL, a store brownout
        window on worker 0, and the slow-call breaker policy armed.
        Guards the brownout sheds (breaker opens on ``slow``) and that
        split-brain staged no stale byte."""
        params = dict(
            jobs=18, workers=2, kill_interval=0.0, kills=0,
            stalls=1, stall_interval=2.0, stall_duration=4.0,
            lease_ttl=2.0,
            max_wall=110.0, publish_rate=2.5,
            # hot fan-in dominates so the stall lands on a lease
            # holder; racing/manifest lanes sit this profile out
            hot_fraction=0.5, racing_fraction=0.0, manifest_jobs=0,
            bulk_fraction=0.25,
            # the reconciliation probe measures a quiescent fleet —
            # out of scope for a deliberately-degraded one
            probe_jobs=0,
            # worker 0: latency-only store brownout (zero errors) —
            # the slow-call policy, not the failure counter, must trip.
            # The window opens almost immediately and spans the first
            # workload wave, so worker 0's store calls are reliably
            # inside it; it CLOSES so the post-window half-open probe
            # restores full-speed drain
            fault_plan=(
                '[{"seam": "store.*", "kind": "brownout",'
                ' "start_s": 1.0, "window_s": 6.0,'
                ' "latency_ms": 250, "jitter_ms": 100}]'
            ),
            brownout_start_s=1.0,
            breakers={"store": {"slow_threshold_ms": 120,
                                "slow_ratio": 0.5, "slow_window": 8,
                                "slow_min_calls": 4, "reset": 1.5}},
            # stall + brownout both inflate the tail legitimately
            p99_ceiling={"HIGH": 35.0, "NORMAL": 45.0, "BULK": 80.0},
            # breaker-shed jobs legitimately settle on BOTH workers
            # (park-then-nack on the browned-out one, completion on the
            # peer — digests key per worker+job), and the stall defers
            # the elected GC sweeper, so the final telemetry census
            # runs up to ~2x jobs before aging out; the bound still
            # caps growth, just sized for this profile's chaos
            telemetry_final_fraction=2.5,
        )
        params.update(overrides)
        return cls(**params)

    @classmethod
    def disk(cls, **overrides) -> "SoakProfile":
        """The storage-fault profile (``make bench-disk`` / bench v25
        ``--disk``): no kill/stall chaos — instead worker 0's landing
        writes hit a windowed ENOSPC (the disk is full for a few
        seconds, then an operator frees space), and AFTER the workload
        drains the rig flips one byte in several cache-entry files
        whose keys have healthy shared-tier replicas.  Guards: every
        job settles despite the full disk (zero FAILED/poisoned),
        every staged byte is exact (zero corrupt bytes served), and
        the scrubber's repair count equals the seeded corruption
        count — measured, not projected."""
        params = dict(
            jobs=18, workers=2, kill_interval=0.0, kills=0,
            max_wall=110.0, publish_rate=2.5,
            # hot fan-in dominates so cache entries AND their shared-
            # tier replicas exist for the bit-rot phase to corrupt and
            # the scrubber to repair from
            hot_fraction=0.5, racing_fraction=0.0, manifest_jobs=0,
            bulk_fraction=0.25, probe_jobs=0,
            # worker 0: the disk is full from t=1s for 6 s of landing
            # writes, then space "frees up" (transient classification:
            # redeliveries after the window land clean)
            fault_plan=(
                '[{"seam": "disk.write", "kind": "disk",'
                ' "disk_mode": "enospc", "fault": "transient",'
                ' "start_s": 1.0, "window_s": 6.0}]'
            ),
            brownout_start_s=1.0,
            # pace redelivery at operator timescales: a full disk does
            # not heal in 50 ms, and fast-looping redeliveries could
            # burn the 5-failure poison budget inside the window
            retry={"redelivery": {"base": 0.5, "cap": 2.5}},
            corrupt_files=3,
            scrub={"interval": 1.0, "rate_mb_s": 512},
            # the repair source must outlive the bit-rot phase
            shared_max_age=300.0,
            # the full-disk window inflates worker 0's tail
            # legitimately (paced redeliveries ride it out)
            p99_ceiling={"HIGH": 35.0, "NORMAL": 45.0, "BULK": 80.0},
            # breaker-shed jobs settle on both workers (see degraded)
            telemetry_final_fraction=2.5,
        )
        params.update(overrides)
        return cls(**params)

    @classmethod
    def from_config(cls, config, base: "Optional[SoakProfile]" = None,
                    **overrides) -> "SoakProfile":
        """Resize ``base`` (default: smoke) from the ``soak.*`` knobs."""
        base = base or cls()
        params = dict(
            jobs=int(cfg_get(config, "soak.jobs", base.jobs)),
            workers=int(cfg_get(config, "soak.workers", base.workers)),
            kill_interval=float(cfg_get(
                config, "soak.kill_interval", base.kill_interval)),
            stalls=int(cfg_get(config, "soak.stalls", base.stalls)),
            stall_interval=float(cfg_get(
                config, "soak.stall_interval", base.stall_interval)),
            stall_duration=float(cfg_get(
                config, "soak.stall_duration", base.stall_duration)),
        )
        params.update(overrides)
        from dataclasses import replace

        return replace(base, **params)


@dataclass(frozen=True)
class WorkloadOrigin:
    """One submittable origin: a URI plus the staged set it must yield.

    ``files`` is the expected staged artifact set ``(basename, bytes)``
    — the byte-identity oracle the rig verifies a sample of jobs
    against (every byte that reaches the staging store must match what
    the origin served, kills or not).
    """

    uri: str
    files: Tuple[Tuple[str, bytes], ...]
    mirrors: Tuple[str, ...] = ()
    source_kind: str = "AUTO"


@dataclass(frozen=True)
class SoakEndpoints:
    """The origin fleet the caller stood up, one pool per job kind."""

    hot: Tuple[WorkloadOrigin, ...]
    plain: Tuple[WorkloadOrigin, ...]
    racing: Tuple[WorkloadOrigin, ...] = ()
    manifest: Tuple[WorkloadOrigin, ...] = ()
    #: fresh-content, transfer-dominated origins (rate-limited so the
    #: splice dwarfs the coordination ceremony) — one per probe job
    probe: Tuple[WorkloadOrigin, ...] = ()


@dataclass(frozen=True)
class JobSpec:
    """One scheduled job: identity, class, and its origin contract."""

    job_id: str
    kind: str
    origin: WorkloadOrigin
    priority: str = "NORMAL"
    tenant: str = ""
    ttl_seconds: float = 0.0


def download_msg(spec: JobSpec) -> bytes:
    """Encode one spec as the wire ``Download`` message."""
    from .. import schemas

    msg = schemas.Download(media=schemas.Media(
        id=spec.job_id,
        creator_id=f"soak-{spec.kind}",
        name=f"soak {spec.kind} {spec.job_id}",
        type=schemas.MediaType.Value("MOVIE"),
        source=schemas.SourceType.Value("HTTP"),
        source_uri=spec.origin.uri,
    ))
    msg.priority = schemas.JobPriority.Value(spec.priority)
    if spec.tenant:
        msg.tenant = spec.tenant
    if spec.ttl_seconds:
        msg.ttl_seconds = spec.ttl_seconds
    if spec.origin.mirrors:
        msg.mirrors.extend(spec.origin.mirrors)
    if spec.origin.source_kind != "AUTO":
        msg.source_kind = schemas.SourceKind.Value(spec.origin.source_kind)
    return schemas.encode(msg)


class SoakWorkload:
    """The deterministic job schedule for one profile + endpoint set."""

    def __init__(self, profile: SoakProfile, endpoints: SoakEndpoints):
        self.profile = profile
        self.endpoints = endpoints
        self.specs: List[JobSpec] = self._build()
        # published one at a time AFTER the mixed phase drains (the
        # rig's attribution-probe step), not part of the mixed schedule
        self.probe_specs: List[JobSpec] = [
            JobSpec(f"soak-probe-{i:04d}", PROBE,
                    self.endpoints.probe[i % len(self.endpoints.probe)])
            for i in range(profile.probe_jobs
                           if self.endpoints.probe else 0)
        ]

    def _build(self) -> List[JobSpec]:
        profile = self.profile
        hot_n = max(int(profile.jobs * profile.hot_fraction), 0)
        racing_n = max(int(profile.jobs * profile.racing_fraction), 0)
        manifest_n = min(profile.manifest_jobs, profile.jobs)
        bulk_n = max(int(profile.jobs * profile.bulk_fraction), 0)
        if not self.endpoints.racing:
            racing_n = 0
        if not self.endpoints.manifest:
            manifest_n = 0
        plain_n = max(
            profile.jobs - hot_n - racing_n - manifest_n - bulk_n, 0)

        def pool(origins, index):
            return origins[index % len(origins)]

        lanes: List[List[JobSpec]] = []
        # hot fan-in: one shared content key, vip tenant, HIGH/NORMAL
        # alternating so the p99 guard sees fan-in in both classes
        lanes.append([
            JobSpec(f"soak-hot-{i:04d}", HOT,
                    pool(self.endpoints.hot, 0),
                    priority="HIGH" if i % 2 == 0 else "NORMAL",
                    tenant="vip" if i % 2 == 0 else "")
            for i in range(hot_n)
        ])
        lanes.append([
            JobSpec(f"soak-racing-{i:04d}", RACING,
                    pool(self.endpoints.racing, i))
            for i in range(racing_n)
        ])
        lanes.append([
            JobSpec(f"soak-manifest-{i:04d}", MANIFEST,
                    pool(self.endpoints.manifest, i))
            for i in range(manifest_n)
        ])
        lanes.append([
            JobSpec(f"soak-bulk-{i:04d}", BULK,
                    pool(self.endpoints.plain, i),
                    priority="BULK", tenant="batch",
                    ttl_seconds=profile.bulk_ttl)
            for i in range(bulk_n)
        ])
        lanes.append([
            JobSpec(f"soak-plain-{i:04d}", PLAIN,
                    pool(self.endpoints.plain, i + 3))
            for i in range(plain_n)
        ])
        # round-robin interleave: every kind is in flight from the
        # start, so the chaos window always lands on mixed traffic
        out: List[JobSpec] = []
        cursor = 0
        while any(lanes):
            lane = lanes[cursor % len(lanes)]
            if lane:
                out.append(lane.pop(0))
            lanes = [ln for ln in lanes if ln]
            cursor += 1
        return out

    def by_kind(self, kind: str) -> List[JobSpec]:
        return [spec for spec in self.specs if spec.kind == kind]

    def priority_class(self, spec: JobSpec) -> str:
        return spec.priority if spec.priority in PRIORITY_CLASSES \
            else "NORMAL"
