"""Pure bundle -> replay-scenario compiler.

``compile_bundle`` turns an incident bundle into a deterministic chaos
scenario: a ``FAULT_PLAN`` (the degradation windows that were in force,
re-anchored to replay t0) plus a ``SoakProfile`` parameter set that
reproduces the same job mix, relative timing, priority classes, and
breaker/SLO policy — so the soak machinery (SoakWorkload +
SoakRig) drives the replay unchanged.

PURITY CONTRACT: this module never reads the clock, the environment, or
any RNG.  Compiling the same bundle twice yields byte-identical
scenarios (tests/test_incident.py::test_compile_bundle_is_pure), which
is what makes "replay twice, same signature" a meaningful guard rather
than a coin flip.  Window re-anchoring is arithmetic on the bundle's
own ``start_s`` values: the windowed kinds are already expressed
relative to injector install, so the replay keeps every relative offset
and merely floors ``start_s`` at ``lead_s`` (the replay fleet needs a
beat to come up before the first window opens).
"""

import json
from typing import Any, Dict, List

from ..platform.faults import RULE_FIELDS, WINDOWED_KINDS
from .bundle import load_bundle
from .replay import bundle_signature

#: the replay fleet needs this long to boot before the first window
DEFAULT_LEAD_S = 1.0
#: replay job-count clamp: enough jobs to reproduce a mix-dependent
#: breach, few enough that `incident replay` stays minutes not hours
REPLAY_JOB_FLOOR = 6
REPLAY_JOB_CAP = 24
#: publish-rate clamp (jobs/s) when deriving relative timing from the
#: bundle's observed wall
MIN_PUBLISH_RATE = 1.0
MAX_PUBLISH_RATE = 6.0
DEFAULT_PUBLISH_RATE = 2.5
#: replay wall guard — generous vs the clamped job count
REPLAY_MAX_WALL_S = 110.0

DEFAULT_LEASE_TTL_S = 2.0


def _reanchor_rule(raw: dict, lead_s: float) -> dict:
    """One fault rule, re-anchored to replay t0.

    Keeps only the declarative RULE_FIELDS (a bundle from a newer
    version may carry keys this version's FaultRule would reject) and
    floors windowed starts at ``lead_s`` while preserving every
    relative offset between windows.
    """
    rule = {k: raw[k] for k in RULE_FIELDS if k in raw}
    if rule.get("kind") in WINDOWED_KINDS:
        try:
            start = float(rule.get("start_s", 0.0))
        except (TypeError, ValueError):
            start = 0.0
        rule["start_s"] = max(start, lead_s)
    return rule


def _derive_fractions(workload: dict) -> Dict[str, Any]:
    """Job mix -> SoakWorkload lane fractions.

    The hot lane alternates HIGH/NORMAL priorities, so reproducing N
    HIGH jobs takes a hot lane of ~2N; the bulk lane is 1:1 with BULK
    records.  Everything left lands in the plain NORMAL lane.
    """
    mix = workload.get("mix") or {}
    total = sum(int(v) for v in mix.values() if isinstance(v, int))
    if total <= 0:
        # empty census (e.g. a truncated bundle): fall back to the
        # degraded-profile defaults rather than a zero-job replay
        return {"hot_fraction": 0.5, "bulk_fraction": 0.25}
    high = int(mix.get("HIGH", 0))
    bulk = int(mix.get("BULK", 0))
    hot = min(round(2.0 * high / total, 3), 0.6)
    return {
        "hot_fraction": hot,
        "bulk_fraction": min(round(bulk / total, 3), 0.5),
    }


def _derive_publish_rate(workload: dict) -> float:
    """Relative timing: the bundle's observed jobs-over-wall, clamped.
    A bundle without a usable wall replays at the degraded default."""
    jobs = workload.get("jobs") or 0
    wall = workload.get("wallS") or 0.0
    try:
        jobs, wall = int(jobs), float(wall)
    except (TypeError, ValueError):
        return DEFAULT_PUBLISH_RATE
    if jobs <= 0 or wall <= 0.0:
        return DEFAULT_PUBLISH_RATE
    return round(min(max(jobs / wall, MIN_PUBLISH_RATE), MAX_PUBLISH_RATE), 2)


def compile_bundle(bundle: dict, *, lead_s: float = DEFAULT_LEAD_S) -> dict:
    """Compile an incident bundle into a replayable scenario (pure).

    Returns a plain JSON-able dict::

        {
          "schema":     bundle schema the scenario was compiled from,
          "source":     bundleId,
          "signature":  the original breach signature (the diff target),
          "faultPlan":  [rule dicts]  # FAULT_PLAN, re-anchored to t0
          "profile":    {SoakProfile.degraded(**profile) overrides},
          "leadS":      the re-anchor floor used,
        }
    """
    bundle = load_bundle(bundle)
    workload = bundle.get("workload") or {}
    fleet_stats = bundle.get("fleetStats") or {}

    fault_plan: List[dict] = [
        _reanchor_rule(r, lead_s)
        for r in (bundle.get("faultPlan") or []) if isinstance(r, dict)
    ]
    brownout_starts = [
        float(r.get("start_s", 0.0)) for r in fault_plan
        if r.get("kind") == "brownout"
    ]

    try:
        lease_ttl = float(fleet_stats.get("leaseTtl") or DEFAULT_LEASE_TTL_S)
    except (TypeError, ValueError):
        lease_ttl = DEFAULT_LEASE_TTL_S
    lease_ttl = min(max(lease_ttl, 1.0), 8.0)

    # a fenced write in the original means a stalled/stale leader lost
    # a race: replay re-creates it with one SIGSTOP stall held past the
    # lease TTL (the stalled-leader drill)
    fenced = int(fleet_stats.get("fencedWrites") or 0)
    stalls = 1 if fenced > 0 else 0

    jobs = workload.get("jobs") or 0
    try:
        jobs = int(jobs)
    except (TypeError, ValueError):
        jobs = 0
    profile: Dict[str, Any] = {
        "jobs": min(max(jobs, REPLAY_JOB_FLOOR), REPLAY_JOB_CAP),
        "publish_rate": _derive_publish_rate(workload),
        "lease_ttl": lease_ttl,
        "stalls": stalls,
        "stall_interval": round(lead_s * 2.0, 3),
        "stall_duration": round(lease_ttl * 2.0, 3),
        "fault_plan": json.dumps(fault_plan, sort_keys=True),
        "brownout_start_s": min(brownout_starts) if brownout_starts else 0.0,
        "max_wall": REPLAY_MAX_WALL_S,
        **_derive_fractions(workload),
    }
    # the original breaker/SLO policy verbatim: the replay must trip
    # the same slow-call policy and burn the same budgets
    if bundle.get("breakerPolicy"):
        profile["breakers"] = bundle["breakerPolicy"]
    if bundle.get("sloPolicy"):
        profile["slo"] = bundle["sloPolicy"]

    return {
        "schema": bundle.get("schema"),
        "source": bundle.get("bundleId"),
        "signature": bundle_signature(bundle),
        "faultPlan": fault_plan,
        "profile": profile,
        "leadS": lead_s,
    }


def scenario_fault_plan_json(scenario: dict) -> str:
    """The scenario's FAULT_PLAN as the env-var JSON the injector reads."""
    return json.dumps(scenario.get("faultPlan") or [], sort_keys=True)


def scenario_profile(scenario: dict, **overrides):
    """Materialize the scenario as a SoakProfile (degraded-world base +
    the compiled overrides).  Imported lazily so compile_bundle stays
    usable without the soak package on the path."""
    from ..soak import SoakProfile

    params = dict(scenario.get("profile") or {})
    params.update(overrides)
    return SoakProfile.degraded(**params)
