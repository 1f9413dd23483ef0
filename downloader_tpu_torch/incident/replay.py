"""Breach signatures, replay collection, and the incident diff.

A **breach signature** is the compact identity of an incident — the
fields that must match for a replay to count as a reproduction
: the breached objective classes, the open-breaker
dependency + reason, the guilty hop, and whether cross-worker fencing
fired.  ``bundle_signature`` derives it from a bundle;
``signature_from_incidents`` picks the signature out of a replay
fleet's own auto-exported bundles (the replay runs the same incident
plane, so original and replay are compared bundle-to-bundle).

``diff_signatures`` is the triage verdict: ``match`` per field and
overall.  Same signature => the scenario reproduces the incident; a
later PR whose replay comes back green (no breach exported) is a
verified fix.
"""

from typing import Dict, List, Optional

#: what a breach-free run (or an empty ring) reduces to
EMPTY_SIGNATURE: Dict[str, object] = {
    "objectives": [],
    "breachKinds": [],
    "breaker": None,
    "guiltyHop": None,
    "fenced": False,
}

#: signature fields compared by diff_signatures, in triage order —
#: objective class first (what burned), then the breaker (what was
#: shedding), then attribution (where the time went / who fenced)
SIGNATURE_FIELDS = ("objectives", "breachKinds", "breaker", "guiltyHop",
                    "fenced")


def _guilty_hop(bundle: dict) -> Optional[str]:
    """The hop carrying the most wall seconds — first from the job's
    own ledger, falling back to the tracker-wide digest."""
    ledger = bundle.get("hopLedger") or {}
    hops = ledger.get("hops") if isinstance(ledger.get("hops"), dict) else ledger
    best, best_seconds = None, 0.0
    if isinstance(hops, dict):
        for name, doc in hops.items():
            seconds = doc.get("seconds", 0.0) if isinstance(doc, dict) else 0.0
            try:
                seconds = float(seconds)
            except (TypeError, ValueError):
                continue
            if seconds > best_seconds:
                best, best_seconds = name, seconds
    if best is not None:
        return best
    digest_hops = (bundle.get("digest") or {}).get("hops") or {}
    for name, doc in digest_hops.items():
        seconds = doc.get("seconds", 0.0) if isinstance(doc, dict) else 0.0
        try:
            seconds = float(seconds)
        except (TypeError, ValueError):
            continue
        if seconds > best_seconds:
            best, best_seconds = name, seconds
    return best


def bundle_signature(bundle: dict) -> dict:
    """Derive the breach signature from a bundle (pure)."""
    breaches = bundle.get("breaches") or []
    objectives = sorted({
        str(e.get("objective")) for e in breaches if e.get("objective")})
    kinds = sorted({
        str(e.get("breach")) for e in breaches if e.get("breach")})
    breaker = None
    open_breakers = bundle.get("openBreakers") or {}
    for dep in sorted(open_breakers):
        doc = open_breakers[dep] or {}
        breaker = {"dependency": dep, "reason": doc.get("reason")}
        break
    fenced = int((bundle.get("fleetStats") or {}).get("fencedWrites") or 0)
    return {
        "objectives": objectives,
        "breachKinds": kinds,
        "breaker": breaker,
        "guiltyHop": _guilty_hop(bundle),
        "fenced": fenced > 0,
    }


def signature_from_incidents(bundles: List[dict]) -> dict:
    """The replay side of the diff: given the bundles a replay fleet
    exported, return the signature of the newest breach-carrying one
    (EMPTY_SIGNATURE when the replay came back green)."""
    for bundle in reversed(bundles):
        if bundle.get("breaches"):
            return bundle_signature(bundle)
    return dict(EMPTY_SIGNATURE)


def diff_signatures(original: dict, replay: dict) -> dict:
    """Field-by-field signature comparison; ``match`` = reproduced."""
    fields = {}
    for name in SIGNATURE_FIELDS:
        a, b = original.get(name), replay.get(name)
        fields[name] = {"original": a, "replay": b, "match": a == b}
    return {
        "match": all(f["match"] for f in fields.values()),
        "fields": fields,
    }


async def collect_incidents(urls: List[str], *,
                            timeout: float = 5.0) -> List[dict]:
    """Pull full bundles from a fleet's ``/v1/incidents`` endpoints
    (best-effort: an unreachable worker contributes nothing, matching
    the degradation contract of the endpoint itself)."""
    import aiohttp

    bundles: List[dict] = []
    client_timeout = aiohttp.ClientTimeout(total=timeout)
    async with aiohttp.ClientSession(timeout=client_timeout) as session:
        for base in urls:
            try:
                async with session.get(base + "/v1/incidents") as resp:
                    if resp.status != 200:
                        continue
                    listing = await resp.json()
            except Exception:
                continue
            for summary in listing.get("incidents") or []:
                bundle_id = summary.get("bundleId")
                if not bundle_id:
                    continue
                try:
                    async with session.get(
                            f"{base}/v1/incidents/{bundle_id}") as resp:
                        if resp.status != 200:
                            continue
                        bundles.append(await resp.json())
                except Exception:
                    continue
    # oldest-first by export stamp so signature_from_incidents's
    # "newest breach wins" holds across workers
    bundles.sort(key=lambda b: str(b.get("exportedAt") or ""))
    return bundles
