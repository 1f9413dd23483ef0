"""Incident plane.

Every forensic ingredient grown since the fault-tolerance layer — the
durable per-job journal, the flight recorder + cross-worker trace
assembly, ``slo_breach`` events with burn/budget context,
the windowed fault plane, and the SoakRig — existed as a
silo.  This package is the join: any production trace becomes a
repeatable, guard-checked chaos scenario.

- :mod:`~.bundle` — versioned (schema v1, frozen field table) forensic
  bundles: timeline, journal lines, breaches, hop ledger, open-breaker
  reasons, placement context, fault plan, config fingerprint.
  Auto-exported on breach into a bounded ring (``incident.max_bundles``)
  and served on ``GET /v1/incidents``.
- :mod:`~.compiler` — the PURE bundle -> scenario compiler: a
  ``FAULT_PLAN`` with degradation windows re-anchored to replay t0 plus
  ``SoakProfile`` overrides reproducing the job mix, relative timing and
  policy, driven by the soak machinery unchanged.
- :mod:`~.replay` — breach signatures (`objective classes, open-breaker
  dependency+reason, guilty hop, fencing`), replay-fleet bundle
  collection, and ``diff_signatures`` — same signature => reproduced; a
  replay that comes back green after a fix is a verified fix.
- :mod:`~.fuzz` — the deterministic scenario fuzzer behind
  ``make fuzz-scenarios`` (opt-in, deliberately not CI): seeded
  mutations of a compiled plan hunting for NEW breach signatures.
"""

from .bundle import (BUNDLE_FIELDS, SCHEMA_VERSION, TRIGGER_BREACH,
                     TRIGGER_MANUAL, BundleError, IncidentStore,
                     build_bundle, bundle_summary, config_fingerprint,
                     export_incident, find_record, load_bundle)
from .compiler import compile_bundle, scenario_fault_plan_json, \
    scenario_profile
from .fuzz import fuzz_scenarios, mutate_scenario
from .replay import (EMPTY_SIGNATURE, SIGNATURE_FIELDS, bundle_signature,
                     collect_incidents, diff_signatures,
                     signature_from_incidents)

__all__ = [
    "BUNDLE_FIELDS", "SCHEMA_VERSION", "TRIGGER_BREACH", "TRIGGER_MANUAL",
    "BundleError", "IncidentStore", "build_bundle", "bundle_summary",
    "config_fingerprint", "export_incident", "find_record", "load_bundle",
    "compile_bundle", "scenario_fault_plan_json", "scenario_profile",
    "fuzz_scenarios", "mutate_scenario",
    "EMPTY_SIGNATURE", "SIGNATURE_FIELDS", "bundle_signature",
    "collect_incidents", "diff_signatures", "signature_from_incidents",
]
