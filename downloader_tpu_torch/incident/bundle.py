"""Incident bundles: versioned trace -> replay snapshots.

A bundle is the forensic record of one job's breach: the flight-recorder
timeline, the job's journal lines, the ``slo_breach`` events with their
burn/budget context, the hop ledger, open-breaker reasons, the fleet
plan epoch + routing decision in force, the fault plan that was active,
and a config fingerprint.  It is self-describing (``schema``) and the
shipped field set is FROZEN like the proto wire table
(tests/test_incident.py::test_bundle_field_numbers_frozen): fields are
only ever *added*, never renumbered or retyped, so a bundle exported by
an old worker keeps loading and compiling on every later version.

Bundles are exported two ways: automatically when a settle stamps an
``slo_breach`` event (trigger ``breach``, bounded ring sized by
``incident.max_bundles``), or on demand through the admin API / CLI
(trigger ``manual``).  ``downloader_tpu_torch.incident.compiler`` turns a
bundle into a replayable chaos scenario.
"""

import hashlib
import json
import time
from collections.abc import Mapping
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

from ..platform.config import cfg_get

SCHEMA_VERSION = 1

# FROZEN wire table (name -> (field number, type label)).  Mirrors the
# proto discipline in tests/test_wire_freeze.py: numbers and types below
# never change; new fields take the next free number.  Unknown fields in
# a newer bundle are preserved by load_bundle (forward compat).
BUNDLE_FIELDS = {
    "schema": (1, "int"),
    "bundleId": (2, "str"),
    "exportedAt": (3, "str"),
    "trigger": (4, "str"),
    "workerId": (5, "str"),
    "job": (6, "object"),
    "timeline": (7, "list"),
    "timelineDropped": (8, "int"),
    "journal": (9, "list"),
    "breaches": (10, "list"),
    "slo": (11, "object"),
    "digest": (12, "object"),
    "hopLedger": (13, "object"),
    "openBreakers": (14, "object"),
    "placement": (15, "object"),
    "plan": (16, "object"),
    "faultPlan": (17, "list"),
    "fleetStats": (18, "object"),
    "breakerPolicy": (19, "object"),
    "sloPolicy": (20, "object"),
    "workload": (21, "object"),
    "configFingerprint": (22, "str"),
}

# the minimal set a bundle must carry to load; everything else degrades
# to an empty value so a truncated bundle still compiles best-effort
REQUIRED_FIELDS = ("schema", "bundleId", "job")

_TYPE_CHECKS = {
    "int": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "str": lambda v: isinstance(v, str),
    "list": lambda v: isinstance(v, list),
    "object": lambda v: isinstance(v, dict),
}

MAX_JOURNAL_LINES = 2000          # per-bundle bound on journal replay
MAX_JOURNAL_BYTES = 1 << 20       # never read more than 1 MiB of journal

DEFAULT_MAX_BUNDLES = 8

TRIGGER_BREACH = "breach"
TRIGGER_MANUAL = "manual"


class BundleError(ValueError):
    """Raised when a document cannot be loaded as an incident bundle."""


def _utc_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


def _plain(value: Any):
    """Deep-coerce to plain JSON data.  Config sections arrive as
    Mapping views (ConfigNode), and recorder events may carry arbitrary
    kwargs; a bundle must serialize wherever it lands (the ring, the
    admin API, a file), so anything exotic degrades to ``str``."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, Mapping):
        return {str(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return [_plain(v) for v in value]
    return str(value)


def config_fingerprint(config) -> str:
    """Stable digest of the effective config, so a replay can assert it
    ran against the same knobs (or show exactly that it did not)."""
    try:
        blob = json.dumps(config, sort_keys=True, default=str)
    except Exception:
        blob = repr(config)
    return hashlib.sha256(blob.encode("utf-8", "replace")).hexdigest()[:16]


def journal_lines_for(path: Optional[str], job_id: str,
                      max_lines: int = MAX_JOURNAL_LINES) -> List[dict]:
    """This job's journal lines (bounded, torn-tail tolerant).

    Reads at most the last MAX_JOURNAL_BYTES of the journal so a breach
    settle never stalls on a huge file; the journal's own rotation keeps
    the live segment far below that in practice.
    """
    if not path or not job_id:
        return []
    lines: List[dict] = []
    try:
        with open(path, "rb") as fh:
            fh.seek(0, 2)
            size = fh.tell()
            fh.seek(max(0, size - MAX_JOURNAL_BYTES))
            raw = fh.read(MAX_JOURNAL_BYTES)
    except OSError:
        return []
    for line in raw.splitlines():
        try:
            doc = json.loads(line)
        except (ValueError, UnicodeDecodeError):
            continue  # torn/partial line: same tolerance as journal.replay
        if isinstance(doc, dict) and doc.get("id") == job_id:
            lines.append(doc)
    return lines[-max_lines:]


def _workload_census(registry, now_mono: float) -> dict:
    """Job-mix context for the compiler: how many jobs of each priority
    class were in flight (or recently settled) when the breach fired,
    which tenants, and over what wall — enough to rebuild an equivalent
    SoakWorkload without shipping every record."""
    mix: Dict[str, int] = {}
    tenants = set()
    earliest = None
    records = []
    try:
        records = registry.jobs()
    except Exception:
        pass
    for rec in records:
        prio = getattr(rec, "priority", "NORMAL") or "NORMAL"
        mix[prio] = mix.get(prio, 0) + 1
        tenant = getattr(rec, "tenant", "") or ""
        if tenant:
            tenants.add(tenant)
        created = getattr(rec, "_created_mono", None)
        if created is not None:
            earliest = created if earliest is None else min(earliest, created)
    wall = round(now_mono - earliest, 3) if earliest is not None else 0.0
    return {
        "jobs": len(records),
        "mix": mix,
        "tenants": sorted(tenants),
        "wallS": max(wall, 0.0),
    }


def _open_breakers(breakers) -> dict:
    """Same shape as orchestrator.slo_digest()'s openBreakers block."""
    out: Dict[str, dict] = {}
    if breakers is None:
        return out
    try:
        reasons = breakers.open_reasons()
        for dep, state in breakers.states().items():
            if state != "closed":
                out[dep] = {"state": state, "reason": reasons.get(dep)}
    except Exception:
        pass
    return out


def _active_fault_plan(injector) -> List[dict]:
    rules = []
    if injector is None or not getattr(injector, "rules", None):
        return rules
    for rule in injector.rules:
        try:
            rules.append(rule.to_dict())
        except Exception:
            continue
    return rules


def _plan_in_force(fleet) -> Optional[dict]:
    if fleet is None:
        return None
    try:
        return fleet.plan_in_force()
    except Exception:
        return None


def build_bundle(orchestrator, record, *, trigger: str = TRIGGER_MANUAL) -> dict:
    """Snapshot one job's forensic state into a schema-v1 bundle.

    Synchronous and best-effort by design: it runs inside the settle
    path on auto-export, so every ingredient degrades to an empty value
    rather than raising.
    """
    recorder = getattr(record, "recorder", None)
    timeline = list(recorder.events()) if recorder is not None else []
    dropped = int(getattr(recorder, "dropped", 0) or 0) if recorder else 0
    breaches = [e for e in timeline if e.get("kind") == "slo_breach"]

    slo = getattr(orchestrator, "slo", None)
    slo_snapshot: dict = {}
    slo_digest: dict = {}
    if slo is not None:
        try:
            slo_snapshot = slo.snapshot()
            slo_digest = slo.digest()
        except Exception:
            pass

    journal = getattr(orchestrator, "journal", None)
    journal_path = getattr(journal, "path", None) if journal else None

    fleet = getattr(orchestrator, "fleet", None)
    fleet_stats: dict = {}
    if fleet is not None:
        try:
            fleet_stats = {
                "fencedWrites": int(fleet.stats.get("fencedWrites", 0)),
                "leaseTtl": float(getattr(fleet, "lease_ttl", 0.0)),
            }
        except Exception:
            fleet_stats = {}

    try:
        hop_ledger = record.hops.summary()
    except Exception:
        hop_ledger = {}

    config = getattr(orchestrator, "config", None) or {}
    job_id = getattr(record, "job_id", "") or ""
    exported_at = _utc_iso()
    seed = f"{job_id}|{exported_at}|{trigger}".encode("utf-8", "replace")
    bundle_id = "inc-" + hashlib.sha256(seed).hexdigest()[:12]

    return _plain({
        "schema": SCHEMA_VERSION,
        "bundleId": bundle_id,
        "exportedAt": exported_at,
        "trigger": trigger,
        "workerId": getattr(orchestrator, "worker_id", "") or "",
        "job": record.to_dict(),
        "timeline": timeline,
        "timelineDropped": dropped,
        "journal": journal_lines_for(journal_path, job_id),
        "breaches": breaches,
        "slo": slo_snapshot,
        "digest": slo_digest,
        "hopLedger": hop_ledger,
        "openBreakers": _open_breakers(getattr(orchestrator, "breakers", None)),
        "placement": {
            "routeKey": getattr(record, "route_key", None),
            "routeDecision": getattr(record, "route_decision", None),
            "planEpoch": getattr(record, "plan_epoch", None),
        },
        "plan": _plan_in_force(fleet),
        "faultPlan": _active_fault_plan(
            getattr(orchestrator, "_fault_injector", None)),
        "fleetStats": fleet_stats,
        "breakerPolicy": dict(cfg_get(config, "breakers", {}) or {}),
        "sloPolicy": dict(cfg_get(config, "slo", {}) or {}),
        "workload": _workload_census(
            getattr(orchestrator, "registry", None), time.monotonic())
        if getattr(orchestrator, "registry", None) is not None else {},
        "configFingerprint": config_fingerprint(config),
    })


def load_bundle(raw: Any) -> dict:
    """Validate a document as an incident bundle, tolerating unknown
    fields (forward compat) and missing optional ones (truncation)."""
    if not isinstance(raw, dict):
        raise BundleError("incident bundle must be a JSON object")
    for field in REQUIRED_FIELDS:
        if field not in raw:
            raise BundleError(f"incident bundle missing field {field!r}")
    schema = raw.get("schema")
    if not isinstance(schema, int) or schema < 1:
        raise BundleError(f"unsupported bundle schema {schema!r}")
    for name, (_num, type_label) in BUNDLE_FIELDS.items():
        if name in raw and raw[name] is not None:
            if not _TYPE_CHECKS[type_label](raw[name]):
                raise BundleError(
                    f"bundle field {name!r} must be {type_label}, "
                    f"got {type(raw[name]).__name__}")
    return dict(raw)  # unknown fields ride along untouched


def bundle_summary(bundle: dict) -> dict:
    """One ring/API row per bundle — enough to pick one to pull."""
    job = bundle.get("job") or {}
    breaches = bundle.get("breaches") or []
    objectives = sorted({
        str(e.get("objective")) for e in breaches if e.get("objective")})
    return {
        "bundleId": bundle.get("bundleId"),
        "schema": bundle.get("schema"),
        "exportedAt": bundle.get("exportedAt"),
        "trigger": bundle.get("trigger"),
        "jobId": job.get("id"),
        "traceId": job.get("traceId"),
        "state": job.get("state"),
        "breaches": len(breaches),
        "objectives": objectives,
        "planEpoch": (bundle.get("placement") or {}).get("planEpoch"),
    }


class IncidentStore:
    """Bounded in-memory ring of exported bundles, newest last.

    The ring (``incident.max_bundles``) bounds worst-case memory the
    same way the registry's terminal ring does: a breach storm evicts
    the oldest bundles instead of growing without bound.
    """

    def __init__(self, *, max_bundles: int = DEFAULT_MAX_BUNDLES,
                 auto_export: bool = True, metrics=None, logger=None):
        self.max_bundles = max(1, int(max_bundles))
        self.auto_export = bool(auto_export)
        self.metrics = metrics
        self.logger = logger
        self._ring: List[dict] = []
        self.exported_total = 0
        #: the latest replay verdict posted back to this worker
        #: (POST /v1/incidents/verdict) — surfaced on the listing
        self.last_verdict: Optional[dict] = None

    @classmethod
    def from_config(cls, config, *, metrics=None,
                    logger=None) -> Optional["IncidentStore"]:
        if not cfg_get(config, "incident.enabled", True):
            return None
        return cls(
            max_bundles=int(cfg_get(
                config, "incident.max_bundles", DEFAULT_MAX_BUNDLES)),
            auto_export=bool(cfg_get(config, "incident.auto_export", True)),
            metrics=metrics, logger=logger,
        )

    def __len__(self) -> int:
        return len(self._ring)

    def add(self, bundle: dict, *, trigger: Optional[str] = None) -> dict:
        trigger = trigger or bundle.get("trigger") or TRIGGER_MANUAL
        self._ring.append(bundle)
        evicted = len(self._ring) - self.max_bundles
        if evicted > 0:
            del self._ring[:evicted]
        self.exported_total += 1
        if self.metrics is not None:
            try:
                self.metrics.incident_bundles.labels(trigger=trigger).inc()
            except Exception:
                pass
        if self.logger is not None:
            try:
                self.logger.info(
                    "incident bundle exported",
                    bundleId=bundle.get("bundleId"), trigger=trigger,
                    jobId=(bundle.get("job") or {}).get("id"),
                    ringSize=len(self._ring))
            except Exception:
                pass
        return bundle_summary(bundle)

    def summaries(self) -> List[dict]:
        return [bundle_summary(b) for b in reversed(self._ring)]

    def get(self, ident: str) -> Optional[dict]:
        """Look a bundle up by bundleId, job id, or trace id (newest
        match wins)."""
        if not ident:
            return None
        for bundle in reversed(self._ring):
            job = bundle.get("job") or {}
            if ident in (bundle.get("bundleId"), job.get("id"),
                         job.get("traceId")):
                return bundle
        return None


def find_record(registry, ident: str):
    """Resolve a job id OR trace id to a registry record."""
    if registry is None or not ident:
        return None
    record = registry.get(ident)
    if record is not None:
        return record
    try:
        for rec in registry.jobs():
            if getattr(rec, "trace_id", None) == ident:
                return rec
    except Exception:
        pass
    return None


def export_incident(orchestrator, ident: str, *,
                    trigger: str = TRIGGER_MANUAL) -> Optional[dict]:
    """Export a bundle for a live or recently-settled job by job id or
    trace id; stores it in the ring when one is configured."""
    record = find_record(getattr(orchestrator, "registry", None), ident)
    if record is None:
        return None
    bundle = build_bundle(orchestrator, record, trigger=trigger)
    store = getattr(orchestrator, "incidents", None)
    if store is not None:
        store.add(bundle, trigger=trigger)
    return bundle
