"""In-process SLO accounting: burn rates, error budgets, hop budgets.

The service's whole job is meeting a staging deadline for the
downstream converter, and now the repo can *measure* that SLO —
but only inside the soak harness, after the fact.  This module is the
standing, in-production half:

- **Objectives** come from config (``slo.objectives.<class>.p99_ms`` +
  ``.availability``), keyed by priority class.  A key matching a
  configured tenant name creates a tenant-scoped objective too, so a
  vip tenant can carry a tighter target than its class.
- **Every settled delivery** is classified at the single settle seam
  the orchestrator already funnels through (``_journal_settle``):
  an acked ``done``/``staged_elsewhere`` inside its objective's target
  latency is *good*; an acked failure (permanent, poison, stalled,
  deadline) or a latency breach is *bad*; nacks are redelivery
  attempts, not resolutions, and cancels are operator actions —
  neither burns budget.  A bad resolution stamps an ``slo_breach``
  flight-recorder event on the job before it retires, so the breach
  rides the timeline, the debug bundle, and the fleet trace digest.
- **Multi-window burn rates** (the SRE alerting math): per objective,
  ``burn = bad_fraction(window) / (1 - availability)`` over a fast
  (~5 m) and a slow (~1 h) window — burn 1.0 spends the budget exactly
  at the allowed rate; 14x on both windows is the classic page.
  Tracked on the monotonic clock in one bounded ring per objective
  (the slow-call-ring discipline: ``slo.max_events`` caps
  memory no matter the job rate), scanned only at scrape/snapshot
  time behind a short memo.
- **Exports**: ``slo_burn_rate{class,window}`` +
  ``slo_error_budget_remaining{class}`` gauges, the ``slo`` block on
  ``/readyz``, and the compact digest the fleet heartbeat carries so
  the elected sweeper can aggregate a fleet-wide view
  (fleet/plane.py ``build_overview``).

Percentile math is shared WITH the soak harness (soak/slo.py imports
:func:`percentile` from here), so ``make soak`` and the production
``/readyz`` block report the same statistic by construction.

**Per-hop regression budgets** (tentpole piece 3) live here too:
:func:`evaluate_hop_budgets` asserts a measured per-hop
``seconds_per_gb`` summary against the checked-in calibration baseline
(BASELINE_HOPS.json), failing with the guilty hop named — the ratchet
ROADMAP item 2's zero-copy work lands against (bench.py v20 ``--slo``).
"""

from __future__ import annotations

import collections
import math
import time
from typing import Any, Dict, List, Optional, Sequence

from ..platform.config import cfg_get

# objective classes always tracked (JobPriority enum names); unknown
# priorities resolve to NORMAL, the control plane's usual posture
PRIORITY_CLASSES = ("HIGH", "NORMAL", "BULK")

# workload classes: orthogonal to priority — a job that exercised a
# chip-bound subsystem (record.workload, stamped by the stage) ALSO
# counts against that subsystem's objective, so compute is a
# first-class worker class on the same burn-rate plane as downloads
WORKLOAD_CLASSES = ("UPSCALE",)

# default per-class objectives: p99 time-to-staged target (ms) and
# availability target.  Sized like the soak ceilings: interactive HIGH
# work is the tight one, BULK is deliberately loose (it is the class
# the overload layer sheds by design).
DEFAULT_OBJECTIVES: Dict[str, "tuple[float, float]"] = {
    "HIGH": (30_000.0, 0.999),
    "NORMAL": (60_000.0, 0.999),
    "BULK": (300_000.0, 0.99),
}

# upscale jobs decode + infer + encode whole videos: minutes-scale by
# nature, and a faulted compute seam should page well before the
# generic availability floor would
DEFAULT_WORKLOAD_OBJECTIVES: Dict[str, "tuple[float, float]"] = {
    "UPSCALE": (120_000.0, 0.99),
}

DEFAULT_FAST_WINDOW = 300.0      # ~5 m: the page-fast window
DEFAULT_SLOW_WINDOW = 3600.0     # ~1 h: the page-slow window
DEFAULT_BUDGET_WINDOW = 86400.0  # error budget accounted over a day
# bounded per-objective event ring (the slow-call-ring posture):
# at 10 jobs/s one objective still holds ~14 min of history
DEFAULT_MAX_EVENTS = 8192
# snapshot memo: /metrics + /readyz + heartbeat digest share one scan
SNAPSHOT_MEMO_S = 0.5

# settle whys that are a SUCCESSFUL resolution (good iff inside target)
_GOOD_WHYS = frozenset({"done", "staged_elsewhere"})
# whys excluded from the SLO entirely: operator actions, not service
# failures (a cancel is the submitter changing their mind)
_EXCLUDED_WHYS = frozenset({"cancelled"})

# per-GB observations below this weight are noise — the same floor the
# HopLedger applies (platform/obs.py MIN_OBSERVE_BYTES)
_MIN_HOP_BYTES = 1 << 20


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in 0..100); 0.0 on empty input.

    THE percentile used repo-wide: the soak harness (soak/slo.py), the
    live ``/readyz`` SLO block, and bench v20's hop-budget calibration
    all call this one function, so their numbers agree by construction.
    """
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(int(math.ceil(q / 100.0 * len(ordered))) - 1, 0)
    return float(ordered[min(rank, len(ordered) - 1)])


class Objective:
    """One SLO: a latency target + an availability target."""

    __slots__ = ("name", "p99_ms", "availability")

    def __init__(self, name: str, p99_ms: float, availability: float):
        if not 0.0 < availability < 1.0:
            raise ValueError(
                f"slo.objectives.{name}.availability must be in (0, 1), "
                f"got {availability!r}")
        if p99_ms <= 0:
            raise ValueError(
                f"slo.objectives.{name}.p99_ms must be > 0, "
                f"got {p99_ms!r}")
        self.name = name
        self.p99_ms = float(p99_ms)
        self.availability = float(availability)

    @property
    def budget_fraction(self) -> float:
        """The fraction of resolutions allowed to be bad (1 - avail)."""
        return 1.0 - self.availability


class _Series:
    """One objective's bounded event ring: ``(mono_t, good, latency_s)``."""

    __slots__ = ("ring", "good_total", "bad_total")

    def __init__(self, max_events: int):
        self.ring: "collections.deque[tuple]" = collections.deque(
            maxlen=max(int(max_events), 16))
        self.good_total = 0
        self.bad_total = 0

    def add(self, now: float, good: bool, latency_s: float) -> None:
        self.ring.append((now, good, latency_s))
        if good:
            self.good_total += 1
        else:
            self.bad_total += 1

    def window_counts(self, now: float,
                      window_s: float) -> "tuple[int, int]":
        """``(good, bad)`` inside the window.  The ring is time-ordered,
        so scan from the newest end and stop at the horizon."""
        horizon = now - window_s
        good = bad = 0
        for t, ok, _lat in reversed(self.ring):
            if t < horizon:
                break
            if ok:
                good += 1
            else:
                bad += 1
        return good, bad

    def window_latencies(self, now: float,
                         window_s: float) -> List[float]:
        horizon = now - window_s
        out = []
        for t, _ok, lat in reversed(self.ring):
            if t < horizon:
                break
            out.append(lat)
        return out


class SloTracker:
    """Live SLO accounting for one worker (see module docstring).

    Cheap by construction: :meth:`note_settle` is a deque append plus a
    handful of dict adds (the ``slo_overhead_ms`` bench guard keeps it
    under 1 ms/job); all window math happens at snapshot time, behind a
    short memo, over bounded rings.
    """

    def __init__(self, objectives: Dict[str, Objective], *,
                 fast_window: float = DEFAULT_FAST_WINDOW,
                 slow_window: float = DEFAULT_SLOW_WINDOW,
                 budget_window: float = DEFAULT_BUDGET_WINDOW,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 tenant_objectives: Optional[Dict[str, Objective]] = None,
                 workload_objectives: Optional[Dict[str, Objective]] = None,
                 clock=time.monotonic):
        self.objectives = dict(objectives)
        # tenant-scoped objectives: fed ALONGSIDE the class objective
        # (a vip job counts against both vip's target and HIGH's)
        self.tenant_objectives = dict(tenant_objectives or {})
        # workload-scoped objectives (UPSCALE): fed alongside too, keyed
        # by record.workload — chips get their own burn rate
        self.workload_objectives = dict(workload_objectives or {})
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        self.budget_window = float(budget_window)
        self.clock = clock
        self._series: Dict[str, _Series] = {
            name: _Series(max_events)
            for name in (list(self.objectives)
                         + list(self.tenant_objectives)
                         + list(self.workload_objectives))
        }
        # cumulative per-hop totals + stage wall across settled jobs:
        # the live (mixed-traffic) attribution the fleet digest carries
        # — topHops by seconds-per-GB plus the hop/stage reconcile
        # ratio the soak leaves unguarded by design
        # (``hop_reconcile_ratio_mixed``: here it is at least VISIBLE)
        self._hop_totals: Dict[str, list] = {}
        self._stage_seconds_total = 0.0
        self._memo = {"at": -1e9, "snap": None}

    # -- config ---------------------------------------------------------
    @classmethod
    def from_config(cls, config,
                    tenant_names: Sequence[str] = ()
                    ) -> Optional["SloTracker"]:
        """Build from ``slo.*`` (None when ``slo.enabled`` is false).

        Objectives: every priority class gets a default objective,
        overridable via ``slo.objectives.<class>.p99_ms`` /
        ``slo.objectives.<class>.availability``.  An objectives key
        matching a configured tenant name (the ``tenants`` table)
        creates a tenant-scoped objective with the same knobs.
        """
        if not bool(cfg_get(config, "slo.enabled", True)):
            return None

        def objective(name: str, default_p99: float,
                      default_avail: float) -> Objective:
            return Objective(
                name,
                float(cfg_get(config, f"slo.objectives.{name}.p99_ms",
                              default_p99)),
                float(cfg_get(config,
                              f"slo.objectives.{name}.availability",
                              default_avail)),
            )

        objectives = {
            name: objective(name, p99, avail)
            for name, (p99, avail) in DEFAULT_OBJECTIVES.items()
        }
        workload_objectives = {
            name: objective(name, p99, avail)
            for name, (p99, avail) in DEFAULT_WORKLOAD_OBJECTIVES.items()
        }
        tenant_objectives: Dict[str, Objective] = {}
        configured = cfg_get(config, "slo.objectives", None)
        for name in list(configured) if configured is not None else []:
            if name in objectives or name in workload_objectives:
                continue
            if name not in tenant_names:
                # neither a class nor a configured tenant: a typo'd key
                # must not silently track nothing
                raise ValueError(
                    f"slo.objectives.{name!r} is neither a priority "
                    f"class {PRIORITY_CLASSES}, a workload class "
                    f"{WORKLOAD_CLASSES}, nor a configured tenant")
            # tenant objectives default to NORMAL's bounds — the
            # RESOLVED ones, so a configured NORMAL override carries
            # into tenants that don't pin their own numbers
            base = objectives["NORMAL"]
            tenant_objectives[name] = objective(
                name, base.p99_ms, base.availability)
        return cls(
            objectives,
            tenant_objectives=tenant_objectives,
            workload_objectives=workload_objectives,
            fast_window=float(cfg_get(
                config, "slo.fast_window", DEFAULT_FAST_WINDOW)),
            slow_window=float(cfg_get(
                config, "slo.slow_window", DEFAULT_SLOW_WINDOW)),
            budget_window=float(cfg_get(
                config, "slo.budget_window", DEFAULT_BUDGET_WINDOW)),
            max_events=int(cfg_get(
                config, "slo.max_events", DEFAULT_MAX_EVENTS)),
        )

    # -- the settle seam -------------------------------------------------
    def resolve_class(self, priority: Optional[str]) -> str:
        return priority if priority in self.objectives else "NORMAL"

    def note_settle(self, record, mode: str, why: str) -> bool:
        """Classify one settled delivery (the orchestrator calls this
        from its single settle funnel, for every ack AND nack).

        Nacks are redelivery attempts — the job is not over — and
        cancels are operator decisions; neither is a resolution.
        Everything else resolves good (acked done/staged inside the
        latency target) or bad (acked failure, or a latency breach).
        Returns True when the resolution burned error budget (an
        ``slo_breach`` was stamped) — the incident plane's auto-export
        trigger (downloader_tpu_torch/incident).
        """
        if mode != "ack" or why in _EXCLUDED_WHYS:
            return False
        now = self.clock()
        latency_s = max(
            now - getattr(record, "_created_mono", now), 0.0)
        cls = self.resolve_class(getattr(record, "priority", None))
        target = self.objectives[cls]
        succeeded = why in _GOOD_WHYS
        good = succeeded and latency_s * 1000.0 <= target.p99_ms
        self._series[cls].add(now, good, latency_s)
        tenant = getattr(record, "tenant", None)
        tenant_obj = self.tenant_objectives.get(tenant)
        if tenant_obj is not None:
            self._series[tenant].add(
                now,
                succeeded and latency_s * 1000.0 <= tenant_obj.p99_ms,
                latency_s)
        # workload class (UPSCALE): stamped by the stage that ran the
        # chip path, so compute burns its own budget alongside the
        # priority class's
        workload = getattr(record, "workload", None)
        workload_obj = self.workload_objectives.get(workload)
        if workload_obj is not None:
            self._series[workload].add(
                now,
                succeeded and latency_s * 1000.0 <= workload_obj.p99_ms,
                latency_s)
        if not good:
            # the breach rides the job's own timeline (and from there
            # the debug bundle + the fleet trace digest) BEFORE the
            # record retires — with the placement context in force
            # (route key, router decision, plan epoch), so a
            # bundle explains WHERE the job was when it burned
            try:
                record.event(
                    "slo_breach", objective=cls, why=why,
                    latency_ms=round(latency_s * 1000.0, 1),
                    target_ms=target.p99_ms,
                    breach=("availability" if not succeeded
                            else "latency"),
                    routeKey=getattr(record, "route_key", None),
                    routeDecision=getattr(record, "route_decision", None),
                    planEpoch=getattr(record, "plan_epoch", None))
            except Exception:
                pass  # accounting must never fail a settle
        # hop/stage accumulation for the fleet digest (mixed-traffic
        # attribution): two bounded dict walks per settled job
        hops = getattr(record, "hops", None)
        if hops is not None and hops:
            for hop, nbytes, seconds in hops.iter_hops():
                entry = self._hop_totals.get(hop)
                if entry is None:
                    self._hop_totals[hop] = [int(nbytes), float(seconds)]
                else:
                    entry[0] += int(nbytes)
                    entry[1] += seconds
        stage_seconds = getattr(record, "stage_seconds", None)
        if stage_seconds:
            self._stage_seconds_total += sum(stage_seconds.values())
        return not good

    # -- window math -----------------------------------------------------
    def burn_rate(self, name: str, window_s: float,
                  now: Optional[float] = None) -> float:
        """``bad_fraction(window) / budget_fraction`` — 1.0 spends the
        error budget exactly at the allowed rate; 0.0 with no events."""
        series = self._series.get(name)
        objective = (self.objectives.get(name)
                     or self.tenant_objectives.get(name)
                     or self.workload_objectives.get(name))
        if series is None or objective is None:
            return 0.0
        good, bad = series.window_counts(
            self.clock() if now is None else now, window_s)
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / objective.budget_fraction

    def budget_remaining(self, name: str,
                         now: Optional[float] = None) -> float:
        """Error budget left over the budget window, 1.0 (untouched) to
        0.0 (exhausted — clamped: spending PAST the budget still reads
        0, the actionable floor)."""
        series = self._series.get(name)
        objective = (self.objectives.get(name)
                     or self.tenant_objectives.get(name)
                     or self.workload_objectives.get(name))
        if series is None or objective is None:
            return 1.0
        good, bad = series.window_counts(
            self.clock() if now is None else now, self.budget_window)
        total = good + bad
        if total == 0:
            return 1.0
        allowed = total * objective.budget_fraction
        if allowed <= 0.0:
            return 0.0 if bad else 1.0
        return max(1.0 - bad / allowed, 0.0)

    # -- surfaces --------------------------------------------------------
    def objective_names(self) -> List[str]:
        return (list(self.objectives) + list(self.tenant_objectives)
                + list(self.workload_objectives))

    def snapshot(self) -> dict:
        """The ``/readyz`` ``slo`` block (memoized: /metrics, /readyz,
        and the heartbeat digest share one ring scan per half second)."""
        now = self.clock()
        memo = self._memo
        if memo["snap"] is not None and now - memo["at"] < SNAPSHOT_MEMO_S:
            return memo["snap"]
        out: Dict[str, Any] = {}
        for name in self.objective_names():
            objective = (self.objectives.get(name)
                         or self.tenant_objectives.get(name)
                         or self.workload_objectives[name])
            series = self._series[name]
            fast = self.burn_rate(name, self.fast_window, now)
            slow = self.burn_rate(name, self.slow_window, now)
            latencies = series.window_latencies(now, self.slow_window)
            entry = {
                "targetP99Ms": objective.p99_ms,
                "availability": objective.availability,
                "burnFast": round(fast, 3),
                "burnSlow": round(slow, 3),
                "budgetRemaining": round(
                    self.budget_remaining(name, now), 4),
                "resolved": series.good_total + series.bad_total,
                "bad": series.bad_total,
                # the same nearest-rank percentile the soak reports
                "p99Ms": round(
                    percentile(latencies, 99.0) * 1000.0, 1),
                "p50Ms": round(
                    percentile(latencies, 50.0) * 1000.0, 1),
                # the classic multiwindow condition: burning on BOTH
                # windows means the breach is real and still happening
                "breached": fast > 1.0 and slow > 1.0,
            }
            out[name] = entry
        snap = {"objectives": out,
                "windows": {"fastS": self.fast_window,
                            "slowS": self.slow_window,
                            "budgetS": self.budget_window}}
        memo["snap"] = snap
        memo["at"] = now
        return snap

    def digest(self) -> dict:
        """The compact SLO block the fleet heartbeat carries (a few
        hundred bytes: burn/budget per objective + hop totals)."""
        snap = self.snapshot()
        hops = {
            hop: {"bytes": nbytes, "seconds": round(seconds, 3)}
            for hop, (nbytes, seconds) in sorted(
                self._hop_totals.items())
        }
        hop_seconds = sum(v[1] for v in self._hop_totals.values())
        stage_seconds = self._stage_seconds_total
        return {
            "burn": {name: {"fast": entry["burnFast"],
                            "slow": entry["burnSlow"]}
                     for name, entry in snap["objectives"].items()},
            "budget": {name: entry["budgetRemaining"]
                       for name, entry in snap["objectives"].items()},
            "breached": sorted(
                name for name, entry in snap["objectives"].items()
                if entry["breached"]),
            "hops": hops,
            "hopSeconds": round(hop_seconds, 3),
            "stageSeconds": round(stage_seconds, 3),
            # mixed-phase attribution ratio (soak stat
            # ``hop_reconcile_ratio_mixed``): unguarded by design —
            # concurrent jobs inflate each other's wall — but visible,
            # so attribution DRIFT at least shows on the overview
            "hopReconcileRatio": round(
                hop_seconds / stage_seconds, 4) if stage_seconds > 0
            else None,
        }


def top_hops(hop_totals: Dict[str, dict], count: int = 3) -> List[dict]:
    """The ``count`` worst hops by seconds-per-GB from ``{hop:
    {bytes, seconds}}`` totals — only hops that moved enough bytes for
    the rate to mean anything (the HopLedger floor)."""
    rows = []
    for hop, entry in hop_totals.items():
        nbytes = int(entry.get("bytes", 0) or 0)
        seconds = float(entry.get("seconds", 0.0) or 0.0)
        if nbytes < _MIN_HOP_BYTES:
            continue
        rows.append({
            "hop": hop,
            "secondsPerGb": round(seconds / (nbytes / 1e9), 3),
            "bytes": nbytes,
        })
    rows.sort(key=lambda r: -r["secondsPerGb"])
    return rows[:count]


# -- per-hop regression budgets (BASELINE_HOPS.json) --------------------

def evaluate_hop_budgets(measured: Dict[str, float],
                         baseline: dict) -> "tuple[bool, List[str]]":
    """Assert measured per-hop ``seconds_per_gb`` against the
    calibration baseline's budgets.

    ``measured``: ``{hop: seconds_per_gb}`` from a calibration-shaped
    run (bench v20 ``--slo`` measures the same workload the baseline
    was calibrated on).  ``baseline``: the parsed BASELINE_HOPS.json —
    ``{"hops": {hop: {"budget_s_per_gb": ...}}}``.

    Returns ``(ok, failures)`` where each failure NAMES the guilty hop
    — the whole point: a cpu_s_per_gb regression arrives with the hop
    that caused it, not as an aggregate vibe.  A baseline hop missing
    from the measurement fails too (a renamed/dropped hop is attribution
    drift, not a win).
    """
    failures: List[str] = []
    budgets = baseline.get("hops", {})
    for hop in sorted(budgets):
        budget = float(budgets[hop].get("budget_s_per_gb", 0.0) or 0.0)
        if budget <= 0:
            continue
        got = measured.get(hop)
        if got is None:
            failures.append(
                f"hop '{hop}' missing from the measured ledger "
                f"(baseline expects <= {budget:g} s/GB) — attribution "
                "drift or a renamed hop")
            continue
        if got > budget:
            failures.append(
                f"hop '{hop}' spent {got:.3f} s/GB, budget "
                f"{budget:g} s/GB (baseline p99 "
                f"{budgets[hop].get('p99_s_per_gb', '?')}) — this hop "
                "is the regression")
    return not failures, failures


def hop_budget_baseline(samples: Dict[str, List[float]],
                        headroom: float = 4.0) -> dict:
    """Build the BASELINE_HOPS.json ``hops`` payload from calibration
    samples: ``{hop: [seconds_per_gb, ...]}`` over repeated runs.

    ``budget_s_per_gb`` = p99 x ``headroom``: wide enough that CI-host
    noise never trips it, tight enough that a hop doubling its cost
    (the regressions ROADMAP item 2 hunts) fails naming the hop.
    """
    hops = {}
    for hop, values in sorted(samples.items()):
        if not values:
            continue
        p50 = percentile(values, 50.0)
        p99 = percentile(values, 99.0)
        hops[hop] = {
            "p50_s_per_gb": round(p50, 4),
            "p99_s_per_gb": round(p99, 4),
            "budget_s_per_gb": round(p99 * headroom, 4),
            "samples": len(values),
        }
    return {"headroom": headroom, "hops": hops}
