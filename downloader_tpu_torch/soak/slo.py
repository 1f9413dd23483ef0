"""SLO guard math and the soak verdict report.

Everything here is pure: the rig hands over job outcomes, the growth
sampler's time series, and the end-of-run world census; this module
turns them into named guards with hard bounds.  A guard failing names
the guilty subsystem (journal compaction, fleet GC, lease plane,
scheduler fairness, hop ledger) — the soak's whole point is that a
capacity regression arrives with attribution, not as a vibe.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

# THE percentile: one implementation shared with the in-process SLO
# plane (control/slo.py), so `make soak` and the production /readyz
# block report the same statistic by construction (re-exported here —
# the soak's public name)
from ..control.slo import percentile
from .workload import PRIORITY_CLASSES


def fit_slope(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Least-squares slope of ``ys`` over ``xs`` (0.0 when degenerate)."""
    n = len(xs)
    if n < 2 or n != len(ys):
        return 0.0
    mean_x = sum(xs) / n
    mean_y = sum(ys) / n
    var = sum((x - mean_x) ** 2 for x in xs)
    if var <= 0.0:
        return 0.0
    cov = sum((x - mean_x) * (y - mean_y) for x, y in zip(xs, ys))
    return cov / var


@dataclass
class Guard:
    """One SLO verdict: a measured value against a hard bound."""

    name: str
    value: float
    bound: float
    ok: bool
    #: which way the bound cuts ("<=" for ceilings, "==" for exacts)
    op: str = "<="
    detail: str = ""

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "value": round(self.value, 4),
            "bound": self.bound,
            "op": self.op,
            "ok": self.ok,
            "detail": self.detail,
        }


@dataclass
class SoakReport:
    """Every guard plus the headline stats one soak run produced."""

    guards: List[Guard] = field(default_factory=list)
    stats: Dict[str, float] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(guard.ok for guard in self.guards)

    def failures(self) -> List[Guard]:
        return [guard for guard in self.guards if not guard.ok]

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "guards": [guard.to_dict() for guard in self.guards],
            "stats": self.stats,
        }

    def summary(self) -> str:
        # the mixed-phase attribution ratio rides the narrative even
        # though it stays unguarded by design (contention-dominated
        # wall): drift in WHERE the time went should be read in every
        # report, not discovered after a quarter of silent rot.  The
        # same number is live on the fleet overview
        # (totals.hopReconcileRatioMixed).
        mixed = self.stats.get("hop_reconcile_ratio_mixed")
        tail = (f" [hop_reconcile_ratio_mixed={mixed:.3f}, unguarded]"
                if mixed else "")
        failed = self.failures()
        if not failed:
            return f"soak OK: {len(self.guards)} guards green{tail}"
        names = ", ".join(
            f"{g.name}={g.value:.3f}!{g.op}{g.bound}" for g in failed)
        return (f"soak FAILED {len(failed)}/{len(self.guards)}: "
                f"{names}{tail}")


def _ceiling(name: str, value: float, bound: float,
             detail: str = "") -> Guard:
    return Guard(name, float(value), float(bound),
                 float(value) <= float(bound), "<=", detail)


def _exact_zero(name: str, value: float, detail: str = "") -> Guard:
    return Guard(name, float(value), 0.0, float(value) == 0.0, "==",
                 detail)


def evaluate(profile, outcomes, samples, world) -> SoakReport:
    """Build the report for one finished run.

    ``outcomes``: the rig's per-job results (``JobOutcome``); every
    published job must appear.  ``samples``: the
    :class:`~.sampler.GrowthSampler` series.  ``world``: the rig's
    end-of-run census (:class:`~.rig.SoakWorld`).
    """
    report = SoakReport()
    guards = report.guards
    stats = report.stats

    # -- completion & outcome hygiene ----------------------------------
    unresolved = [o for o in outcomes if o.resolved_mono is None]
    guards.append(_exact_zero(
        "unresolved_jobs", len(unresolved),
        ", ".join(o.spec.job_id for o in unresolved[:8])))
    bad = [o for o in outcomes
           if o.terminal_state in ("FAILED", "DROPPED_POISON")]
    # zero FAILED / DROPPED_POISON despite injected transient faults
    # and SIGKILLs == the poison budget stayed monotone and never
    # crossed its threshold from counting the same failure twice
    guards.append(_exact_zero(
        "failed_or_poisoned_jobs", len(bad),
        ", ".join(f"{o.spec.job_id}={o.terminal_state}"
                  for o in bad[:8])))
    expired = [o for o in outcomes if o.terminal_state == "EXPIRED"]
    non_bulk_expired = [o for o in expired if o.spec.priority != "BULK"]
    guards.append(_exact_zero(
        "non_bulk_expired_jobs", len(non_bulk_expired),
        "only deadline-carrying BULK work may expire"))
    stats["jobs"] = float(len(outcomes))
    stats["expired_bulk"] = float(len(expired) - len(non_bulk_expired))

    # -- p99 time-to-staged per priority class -------------------------
    by_class: Dict[str, List[float]] = {}
    for outcome in outcomes:
        if outcome.staged_mono is None:
            continue
        cls = outcome.spec.priority if outcome.spec.priority \
            in PRIORITY_CLASSES else "NORMAL"
        by_class.setdefault(cls, []).append(
            outcome.staged_mono - outcome.published_mono)
    for cls in PRIORITY_CLASSES:
        walls = by_class.get(cls, [])
        if not walls:
            continue
        p99 = percentile(walls, 99.0)
        stats[f"p99_{cls.lower()}_s"] = round(p99, 3)
        stats[f"p50_{cls.lower()}_s"] = round(
            percentile(walls, 50.0), 3)
        guards.append(_ceiling(
            f"p99_time_to_staged_{cls.lower()}", p99,
            profile.p99_ceiling.get(cls, 60.0),
            f"{len(walls)} jobs"))

    # -- bounded growth: journal ---------------------------------------
    journal_peak = 0
    for sample in samples:
        for size in sample.journal_bytes.values():
            journal_peak = max(journal_peak, size)
    for size in world.journal_final_bytes.values():
        journal_peak = max(journal_peak, size)
    stats["journal_peak_bytes"] = float(journal_peak)
    guards.append(_ceiling(
        "journal_peak_bytes", journal_peak, profile.journal_peak_limit,
        f"journal.max_bytes={profile.journal_max_bytes}"))

    # -- bounded growth: coordination store ----------------------------
    # finals judge LIVE docs (tombstones resolved away — a tombstone
    # already reads as absent and is compacted by the slower tombstone
    # sweep); the per-sample peaks track raw objects, disk reality
    telemetry_peak = max(
        (s.coord_docs.get("telemetry", 0) for s in samples), default=0)
    stats["coord_telemetry_peak_raw"] = float(telemetry_peak)
    telemetry_final = world.coord_live.get("telemetry", 0)
    stats["coord_telemetry_final"] = float(telemetry_final)
    guards.append(_ceiling(
        "coord_telemetry_docs_final", telemetry_final,
        max(profile.telemetry_final_fraction * len(outcomes), 4.0),
        f"raw peak {telemetry_peak}; fleet GC must age digests out"))
    guards.append(_ceiling(
        "coord_worker_docs_final", world.coord_live.get("workers", 0),
        profile.workers + 2,
        "dead generations must age out of the registry"))
    guards.append(_exact_zero(
        "leaked_leases_at_drain", len(world.leaked_leases),
        ", ".join(world.leaked_leases[:4])))

    # -- bounded growth: shared cache tier -----------------------------
    shared_peak = max((s.shared_cache_bytes for s in samples), default=0)
    stats["shared_cache_peak_bytes"] = float(shared_peak)
    guards.append(_ceiling(
        "shared_cache_peak_bytes", shared_peak,
        profile.shared_cache_limit,
        f"fleet.shared_max_bytes={profile.shared_max_bytes}"))

    # -- bounded growth: worker RSS ------------------------------------
    slope = rss_slope_mb_per_kjob(samples)
    stats["rss_slope_mb_per_kjob"] = round(slope, 3)
    guards.append(_ceiling(
        "rss_slope_mb_per_kjob", slope,
        profile.rss_slope_limit_mb_per_kjob,
        "max over worker generations"))

    # -- drain hygiene -------------------------------------------------
    orphans = [f"w{idx}:{name}"
               for idx, names in world.orphan_workdirs.items()
               for name in names]
    guards.append(_exact_zero(
        "orphan_workdirs_at_drain", len(orphans),
        ", ".join(orphans[:6])))
    guards.append(_exact_zero(
        "staged_byte_mismatches", len(world.byte_mismatches),
        ", ".join(world.byte_mismatches[:6])))
    guards.append(_exact_zero(
        "unsettled_journal_jobs_at_drain",
        len(world.unsettled_journal_jobs),
        ", ".join(world.unsettled_journal_jobs[:6])))
    # a kill OR a stall can each strand at most one in-flight scrape
    # (the sampler skips not-ready workers, but a freeze can land mid-
    # request) — both count toward the allowance
    chaos_events = (world.kills_delivered
                    + getattr(world, "stalls_delivered", 0))
    guards.append(_exact_zero(
        "sampler_scrape_failures_beyond_kills",
        max(world.scrape_failures - chaos_events, 0),
        f"{world.scrape_failures} failures, "
        f"{world.kills_delivered} kills, "
        f"{getattr(world, 'stalls_delivered', 0)} stalls"))
    stats["kills_delivered"] = float(world.kills_delivered)
    stats["stalls_delivered"] = float(
        getattr(world, "stalls_delivered", 0))

    # -- hop-ledger vs wall-clock reconciliation -----------------------
    # judged over the QUIESCENT attribution-probe jobs: sequential,
    # fresh-content, single-stream, transfer-dominated — the regime
    # where stage wall is attributable to I/O at all.  The mixed
    # phase's wall is contention (dozens of concurrent jobs inflate
    # each other's clocks) and racing/manifest jobs bill concurrent
    # origin connections > wall by design; both stay visible as the
    # ``hop_reconcile_ratio_mixed`` stat, unguarded.
    probe_ids = {o.spec.job_id for o in outcomes
                 if o.spec.kind == "probe"}
    ratio, eligible = hop_reconciliation(world.records, probe_ids)
    stats["hop_reconcile_ratio"] = round(ratio, 4)
    stats["hop_reconcile_jobs"] = float(eligible)
    mixed_ids = {o.spec.job_id for o in outcomes
                 if o.spec.kind in ("plain", "hot", "bulk")}
    mixed_ratio, mixed_n = hop_reconciliation(world.records, mixed_ids)
    stats["hop_reconcile_ratio_mixed"] = round(mixed_ratio, 4)
    stats["hop_reconcile_jobs_mixed"] = float(mixed_n)
    if not probe_ids:
        # no probe was scheduled (probe_jobs=0 / no probe endpoints):
        # the guard is out of scope, not vacuously green or red
        return report
    if eligible >= len(probe_ids):
        guards.append(_ceiling(
            "hop_reconcile_error", abs(1.0 - ratio),
            profile.hop_reconcile_tolerance,
            f"{eligible} probe jobs, sum(hop)/sum(stage)={ratio:.3f}"))
    else:
        guards.append(Guard(
            "hop_reconcile_error", 1.0, profile.hop_reconcile_tolerance,
            False, "<=",
            f"only {eligible}/{len(probe_ids)} probe jobs reconcilable "
            "— ledger coverage collapsed (vacuous pass refused)"))
    return report


def rss_slope_mb_per_kjob(samples) -> float:
    """Max RSS growth slope across worker generations.

    x = completed jobs (thousands) at sample time, y = that
    generation's RSS in MB.  The first quarter of each generation's
    series is dropped — a freshly-started interpreter ramps from ~20
    to ~45 MB while it warms caches and arenas, and fitting that ramp
    reads as a catastrophic "leak" (the soak's first full run measured
    1.1 GB/kjob of pure warmup).  A generation votes only with ≥ 8
    post-warmup samples spanning ≥ 20 jobs of progress.
    """
    series: Dict[tuple, List[tuple]] = {}
    for sample in samples:
        for (idx, generation), rss in sample.rss_bytes.items():
            if rss <= 0:
                continue
            series.setdefault((idx, generation), []).append(
                (sample.done_jobs / 1000.0, rss / 1e6))
    worst = 0.0
    for points in series.values():
        points = points[len(points) // 4:]
        if len(points) < 8:
            continue
        xs = [p[0] for p in points]
        ys = [p[1] for p in points]
        if (max(xs) - min(xs)) * 1000.0 < 20.0:
            continue
        worst = max(worst, fit_slope(xs, ys))
    return worst


def brownout_shed_seconds(samples, start_mono: float,
                          dependency: str = "store"
                          ) -> Optional[float]:
    """Seconds from the brownout window opening to the FIRST sample
    showing ``dependency``'s breaker away from closed on any worker —
    the shed latency the degraded profile guards (``brownout_shed_ms``).
    None when no sample ever saw the breaker leave closed."""
    selector = f'dependency="{dependency}"'
    for sample in samples:
        if sample.t_mono < start_mono:
            continue
        for index in sample.scraped:
            value = sample.metric(index, "breaker_state", selector)
            if value is not None and value >= 1.0:
                return sample.t_mono - start_mono
    return None


def slow_opens_total(samples, dependency: str = "store") -> float:
    """Total ``breaker_opened_total{reason="slow"}`` opens for
    ``dependency`` across workers, from each worker's LAST scrape —
    proves the brownout tripped the slow-call policy, not the failure
    counter."""
    latest: Dict[int, float] = {}
    selector = (f'dependency="{dependency}"', 'reason="slow"')
    for sample in samples:
        for index, scraped in sample.scraped.items():
            for name, value in scraped.items():
                family = name.split("{", 1)[0]
                if not family.endswith("breaker_opened_total"):
                    continue
                if all(part in name for part in selector):
                    latest[index] = value
    return sum(latest.values())


def fenced_writes_total(samples) -> float:
    """Total ``fleet_fenced_writes_total`` across workers and ops, from
    each worker's last scrape — the split-brain writes the fence
    rejected over the run."""
    latest: Dict[tuple, float] = {}
    for sample in samples:
        for index, scraped in sample.scraped.items():
            for name, value in scraped.items():
                family = name.split("{", 1)[0]
                if family.endswith("fleet_fenced_writes_total"):
                    latest[(index, name)] = value
    return sum(latest.values())


def hop_reconciliation(records: List[dict],
                       eligible_ids: Optional[set] = None
                       ) -> "tuple[float, int]":
    """``(sum(hop seconds)/sum(stage seconds), eligible jobs)`` over
    DONE records that fetched their own bytes (``bytes.downloaded`` >
    0) and carry a hop ledger — the set whose RUNNING wall is transfer
    work, so the ledger must account for it.  Coalesced waiters and
    cache hits idle inside their stage by design and are excluded;
    ``eligible_ids`` further restricts to single-stream jobs (parallel
    range fetchers bill concurrent hop seconds > wall by design).
    """
    hop_total = 0.0
    stage_total = 0.0
    eligible = 0
    for record in records:
        if record.get("state") != "DONE":
            continue
        if (eligible_ids is not None
                and record.get("id") not in eligible_ids):
            continue
        if not (record.get("bytes") or {}).get("downloaded"):
            continue
        ledger = record.get("hopLedger") or {}
        stage_seconds = record.get("stageSeconds") or {}
        if not ledger or not stage_seconds:
            continue
        hops = sum(float(entry.get("seconds", 0.0))
                   for entry in ledger.values())
        wall = sum(float(s) for s in stage_seconds.values())
        if wall <= 0.0:
            continue
        eligible += 1
        hop_total += hops
        stage_total += wall
    if stage_total <= 0.0:
        return 0.0, eligible
    return hop_total / stage_total, eligible
