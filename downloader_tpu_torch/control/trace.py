"""Cross-worker trace assembly: one timeline for one trace id.

An earlier change gave every job a W3C trace id that joins its log lines, OTLP span,
and flight-recorder timeline — *inside one worker*.  An earlier change made the
system a fleet, and the trace stopped dead at the worker boundary: a
lease waiter's timeline showed only ``fleet_lease_wait`` while the fetch
it was actually waiting on ran (invisibly) on the leader.  This module
is the join:

- **Local segments** — every registry record (live + terminal ring)
  carrying the trace id, with its full event timeline and hop ledger.
- **Digest segments** — other workers' per-job digests published to the
  coordination store at ``telemetry/<trace_id>/<worker_id>/<job_id>``
  (fleet/plane.py, written at settle, GC'd after
  ``fleet.telemetry_ttl``).
- **Linked traces** — a waiter's ``fleet`` wait event names the leader
  job's trace id (carried on the lease document); the assembler follows
  those links so the leader's origin fetch appears in the waiter's
  assembled view, attributed to the leader's worker.
- **Live peers** — workers advertising an ``adminUrl`` in their
  heartbeat are queried over ``GET /v1/trace/{id}?scope=local`` for
  still-running (not-yet-digested) segments.

Degradation contract (the posture): coordination-store or peer
trouble can never fail the assembly — the response downgrades to
whatever was reachable, flags ``degraded: true``, and lists the errors.
A local-only view is always available.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List, Optional

# bound on lease-leader trace links followed per assembly (a waiter has
# at most one leader per content key; this caps pathological fan-out)
MAX_LINKED_TRACES = 8
# per-peer admin-API budget: trace assembly is an operator read, but it
# must never hang behind one wedged peer
PEER_TIMEOUT = 5.0


def _segment_from_record(record, worker_id: Optional[str]) -> dict:
    hops = getattr(record, "hops", None)
    return {
        "workerId": record.worker_id or worker_id,
        "jobId": record.job_id,
        "traceId": record.trace_id,
        "spanId": record.span_id,
        "state": record.state,
        "stage": record.stage,
        "stageSeconds": {k: round(v, 3)
                         for k, v in record.stage_seconds.items()},
        "hopLedger": (hops.summary()
                      if hops is not None and hops else None),
        "events": record.recorder.events(),
        "source": "local",
    }


def local_segments(orchestrator, trace_id: str) -> List[dict]:
    """Segments this worker can answer for without any I/O."""
    registry = getattr(orchestrator, "registry", None)
    if registry is None:
        return []
    worker_id = getattr(orchestrator, "worker_id", None)
    return [
        _segment_from_record(record, worker_id)
        for record in registry.jobs()
        if record.trace_id == trace_id
    ]


def local_spans(orchestrator, trace_id: str) -> List[dict]:
    """Finished spans in the local tracer buffer for this trace."""
    tracer = getattr(orchestrator, "tracer", None)
    if tracer is None:
        return []
    try:
        spans = tracer.spans()
    except Exception:
        return []
    worker_id = getattr(orchestrator, "worker_id", None)
    out = []
    for span in spans:
        if span.trace_id != trace_id:
            continue
        doc = span.to_dict()
        doc["workerId"] = worker_id
        out.append(doc)
    return out


def linked_trace_ids(segments: List[dict]) -> Dict[str, str]:
    """Trace ids referenced by fleet wait / shared-origin events — the
    cross-trace links the assembler follows — mapped to the link label
    the merged segments are stamped with (``lease_leader`` /
    ``shared_origin``, naming the event field the link came from)."""
    out: Dict[str, str] = {}
    for segment in segments:
        for event in segment.get("events") or []:
            for field, label in (("leaderTraceId", "lease_leader"),
                                 ("originTraceId", "shared_origin")):
                linked = event.get(field)
                if linked and linked != segment.get("traceId") \
                        and linked not in out:
                    out[linked] = label
    return out


async def assemble(orchestrator, trace_id: str, *,
                   remote: bool = True) -> dict:
    """The ``GET /v1/trace/{id}`` document (see module docstring).

    ``remote=False`` (the ``?scope=local`` form peers use on each other)
    skips the coordination store and peer hops — no recursion, no
    cross-fleet amplification.
    """
    worker_id = getattr(orchestrator, "worker_id", None)
    segments = local_segments(orchestrator, trace_id)
    spans = local_spans(orchestrator, trace_id)
    errors: List[str] = []
    degraded = False
    fleet = getattr(orchestrator, "fleet", None)

    if remote and fleet is not None:
        seen = {(s.get("workerId"), s.get("jobId")) for s in segments}

        async def _merge_digests(tid: str, link: Optional[str]) -> None:
            nonlocal degraded
            try:
                digests = await fleet.fetch_telemetry(tid)
            except asyncio.CancelledError:
                raise
            except Exception as err:
                degraded = True
                errors.append(f"coord telemetry {tid[:8]}: {err}"[:200])
                return
            for doc in digests:
                key = (doc.get("workerId"), doc.get("jobId"))
                if key in seen:
                    continue  # local view wins over its own digest
                seen.add(key)
                segments.append({
                    "workerId": doc.get("workerId"),
                    "jobId": doc.get("jobId"),
                    "traceId": doc.get("traceId"),
                    "spanId": doc.get("spanId"),
                    "state": doc.get("state"),
                    "stage": doc.get("stage"),
                    "stageSeconds": doc.get("stageSeconds") or {},
                    "hopLedger": doc.get("hopLedger"),
                    "events": doc.get("events") or [],
                    "source": "digest",
                    **({"link": link} if link else {}),
                })

        await _merge_digests(trace_id, None)
        # follow lease-leader / shared-origin links discovered in the
        # segments so far: the waiter's view pulls in the leader's fetch
        linked_ids = list(
            linked_trace_ids(segments).items())[:MAX_LINKED_TRACES]
        for linked, label in linked_ids:
            await _merge_digests(linked, label)

        # live peers: segments for jobs still running (no digest yet).
        # Queried for the linked leader traces too — mid-incident the
        # leader's fetch has no digest (published only at settle), and
        # on the peer that fetch runs under ITS OWN trace id, so asking
        # only for ours would 404 and hide exactly the segment a parked
        # waiter's triage needs.
        peers: List[dict] = []
        try:
            peers = [
                w for w in await fleet.workers()
                if w.get("adminUrl") and w.get("workerId") != worker_id
            ]
        except asyncio.CancelledError:
            raise
        except Exception as err:
            degraded = True
            errors.append(f"coord workers: {err}"[:200])
        if peers:
            import aiohttp

            timeout = aiohttp.ClientTimeout(total=PEER_TIMEOUT)
            span_ids = {s.get("spanId") for s in spans}

            async def _ask_peer(session, peer, tid, link):
                url = peer["adminUrl"].rstrip("/") + f"/v1/trace/{tid}"
                try:
                    async with session.get(
                        url, params={"scope": "local"}
                    ) as resp:
                        if resp.status == 404:
                            return None  # peer knows nothing: fine
                        if resp.status != 200:
                            raise RuntimeError(f"HTTP {resp.status}")
                        return peer, link, await resp.json()
                except asyncio.CancelledError:
                    raise
                except Exception as err:
                    return peer, link, err

            async with aiohttp.ClientSession(timeout=timeout) as session:
                # concurrent: a wedged peer costs PEER_TIMEOUT once,
                # not once per peer per trace id
                answers = await asyncio.gather(*[
                    _ask_peer(session, peer, tid, link)
                    for peer in peers
                    for tid, link in [(trace_id, None)] + linked_ids
                ])
            for answer in answers:
                if answer is None:
                    continue
                peer, link, body = answer
                if isinstance(body, Exception):
                    degraded = True
                    errors.append(
                        f"peer {peer.get('workerId')}: {body}"[:200])
                    continue
                for segment in body.get("segments") or []:
                    key = (segment.get("workerId"), segment.get("jobId"))
                    if key in seen:
                        continue
                    seen.add(key)
                    segment = dict(segment)
                    segment["source"] = "peer"
                    if link:
                        segment["link"] = link
                    segments.append(segment)
                for span in body.get("spans") or []:
                    if span.get("spanId") in span_ids:
                        continue
                    span_ids.add(span.get("spanId"))
                    spans.append(span)

    workers: List[Any] = sorted(
        {s.get("workerId") for s in segments if s.get("workerId")}
    )
    return {
        "traceId": trace_id,
        "workerId": worker_id,
        "workers": workers,
        "segments": segments,
        "spans": spans,
        "degraded": degraded,
        "errors": errors,
    }


def merged_timeline(document: dict) -> List[dict]:
    """All segments' events in one wall-clock-ordered list, each stamped
    with its segment's worker/job identity (the ``cli trace show``
    rendering; also handy for tests)."""
    out: List[Dict[str, Any]] = []
    for segment in document.get("segments") or []:
        for event in segment.get("events") or []:
            row = dict(event)
            row.setdefault("workerId", segment.get("workerId"))
            row["jobId"] = segment.get("jobId")
            out.append(row)
    out.sort(key=lambda e: e.get("t") or 0)
    return out
