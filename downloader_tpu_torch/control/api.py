"""Admin API: the control plane's HTTP surface.

Mounted on the same aiohttp app as ``/health`` (health.py), so one port
serves probes, metrics, and operations:

    GET  /v1/jobs                   list live + recently-terminal jobs
    GET  /v1/jobs/{id}              one job's record
    GET  /v1/jobs/{id}/events       the job's flight-recorder timeline
                                    (state transitions, waits, throughput
                                    samples, cache/retry/settle decisions,
                                    correlation ids)
    POST /v1/jobs/{id}/cancel       fire the job's cancel token
    GET  /v1/trace/{trace_id}       cross-worker timeline for one trace:
                                    local segments + peer digests from
                                    the coordination store + live peer
                                    admin APIs (?scope=local = this
                                    worker only; fleet trouble degrades
                                    to the local view, never an error)
    GET  /v1/fleet                  fleet membership: live workers (with
                                    heartbeat payloads), live content
                                    leases, this worker's fleet stats
    GET  /v1/fleet/overview         the aggregated fleet overview doc
                                    (burn rates, breakers, tenant queue
                                    shares, top hops) the elected
                                    aggregator folds each heartbeat;
                                    coord trouble degrades to the local
                                    view (degraded: true), never a 5xx
    GET  /v1/fleet/plan             the placement controller's plan doc
                                    (admission shed, drain set, desired
                                    workers, bounded decision tail) as
                                    this worker's watch-fed cache holds
                                    it; always 200 — absent/stale plan
                                    just reads as plan: null/fresh:false
    GET  /v1/fleet/{id}             one worker's latest heartbeat doc
    GET  /v1/tenants                tenancy + overload posture: per-
                                    tenant weight/caps/quotas, live queue
                                    depth and slot occupancy, saturation
                                    snapshot
    GET  /v1/incidents              exported incident-bundle summaries
                                    (the bounded auto-export ring +
                                    manual exports); disabled plane
                                    reads as enabled:false, never a 5xx
    GET  /v1/incidents/{id}         one full bundle by bundleId, job id,
                                    or trace id
    POST /v1/incidents/{id}/export  snapshot a live/recent job into the
                                    ring now (trigger=manual)
    POST /v1/incidents/verdict      record an incident-replay verdict
                                    (sets incident_replay_signature_match)
    POST /v1/intake/pause           stop pulling deliveries (in-flight
                                    work keeps running; /readyz -> 503)
    POST /v1/intake/resume          start pulling again
    POST /v1/drain?grace=30         pause intake + wait for in-flight
                                    jobs (programmatic shutdown grace)
    GET  /debug/tasks               live asyncio tasks (name, coroutine,
                                    stack top) + loop-lag stats
    GET  /debug/stacks              every thread's and task's current
                                    stack (the SIGUSR1 dump, over HTTP)

Mutating endpoints (POST) are gated by an optional bearer token from
``control.token`` / env ``CONTROL_TOKEN``; reads stay open like
``/metrics``.  Without a token configured every caller is allowed — the
parity posture for a service that previously had no API at all.
"""

from __future__ import annotations

import asyncio
import hmac
import os
import time
from typing import Optional

from aiohttp import web

from ..incident.bundle import TRIGGER_MANUAL, export_incident
from ..platform.config import cfg_get
from ..platform.obs import dump_stacks, dump_tasks
from . import registry as reg


def resolve_token(config) -> Optional[str]:
    return os.environ.get("CONTROL_TOKEN") or cfg_get(
        config, "control.token", None
    )


def bind_control_routes(app: web.Application, orchestrator) -> None:
    token = resolve_token(getattr(orchestrator, "config", None))

    def _registry():
        return getattr(orchestrator, "registry", None)

    def _authorized(request: web.Request) -> bool:
        if not token:
            return True
        header = request.headers.get("Authorization", "")
        # compare BYTES: compare_digest on str raises TypeError for
        # non-ASCII input, which would turn a hostile header into a 500
        # instead of a 401
        return hmac.compare_digest(
            header.encode("utf-8", "surrogateescape"),
            f"Bearer {token}".encode("utf-8", "surrogateescape"),
        )

    def _deny() -> web.Response:
        return web.json_response(
            {"error": "missing or invalid bearer token"}, status=401
        )

    def _unavailable() -> web.Response:
        return web.json_response(
            {"error": "control plane unavailable"}, status=503
        )

    async def jobs_list(request: web.Request) -> web.Response:
        registry = _registry()
        if registry is None:
            return _unavailable()
        state = request.query.get("state")
        if state and state not in reg.LEGAL_TRANSITIONS:
            return web.json_response(
                {"error": f"unknown state {state!r}",
                 "states": sorted(reg.LEGAL_TRANSITIONS)}, status=400
            )
        jobs = registry.jobs(state)
        # ?recovered=true: only jobs that survived a worker crash
        # (journal-replayed placeholders + their adopting redeliveries)
        if request.query.get("recovered") in ("true", "1", "yes"):
            jobs = [r for r in jobs if r.recovered]
        return web.json_response({
            "jobs": [r.to_dict() for r in jobs],
            "counts": registry.counts(),
            "workerId": getattr(orchestrator, "worker_id", None),
            "intakePaused": bool(
                getattr(orchestrator, "intake_paused", False)
            ),
        })

    async def job_show(request: web.Request) -> web.Response:
        registry = _registry()
        if registry is None:
            return _unavailable()
        record = registry.get(request.match_info["id"])
        if record is None:
            return web.json_response({"error": "unknown job"}, status=404)
        return web.json_response(record.to_dict())

    async def job_events(request: web.Request) -> web.Response:
        """The job's flight-recorder timeline — the one endpoint that
        answers "why is job X slow / stuck / dead" without shelling in."""
        registry = _registry()
        if registry is None:
            return _unavailable()
        record = registry.get(request.match_info["id"])
        if record is None:
            return web.json_response({"error": "unknown job"}, status=404)
        return web.json_response({
            "id": record.job_id,
            "state": record.state,
            "stage": record.stage,
            "traceId": record.trace_id,
            "spanId": record.span_id,
            "eventsDropped": record.recorder.dropped,
            "events": record.recorder.events(),
        })

    async def trace_show(request: web.Request) -> web.Response:
        """The cross-worker timeline for one trace id: local registry
        segments + tracer spans, merged with peer digests from the
        coordination store and live peer admin APIs.  Coordination
        trouble degrades to the local view (``degraded: true``) — this
        endpoint never 5xxes on fleet trouble.  ``?scope=local`` (what
        peers send each other) skips every remote hop."""
        assemble = getattr(orchestrator, "assemble_trace", None)
        if assemble is None:
            return _unavailable()
        trace_id = request.match_info["id"]
        remote = request.query.get("scope") != "local"
        document = await assemble(trace_id, remote=remote)
        if not document["segments"] and not document["spans"]:
            return web.json_response(
                {"error": "unknown trace", **document}, status=404
            )
        return web.json_response(document)

    async def fleet_list(_request: web.Request) -> web.Response:
        """Fleet membership: live workers (heartbeat payloads incl. the
        autoscale trio), every live content lease, and this worker's
        own shared-tier stats."""
        plane = getattr(orchestrator, "fleet", None)
        payload = {
            "workerId": getattr(orchestrator, "worker_id", None),
            "enabled": plane is not None,
        }
        if plane is None:
            return web.json_response(payload)
        try:
            payload["workers"] = await plane.workers()
            payload["leases"] = await plane.leases()
        except Exception as err:  # coordination store down: say so
            return web.json_response(
                {**payload, "error": f"coordination store: {err}"},
                status=503,
            )
        payload["heldLeases"] = plane.lease_snapshot()
        payload["stats"] = dict(plane.stats)
        return web.json_response(payload)

    async def fleet_overview(_request: web.Request) -> web.Response:
        """The aggregated fleet overview: the one document
        the elected aggregator folds every live member's heartbeat
        digest into — fleet-wide tenant queue shares, worst-of-fleet
        burn rates, open breakers per worker, top hops by
        seconds-per-GB.  The trace-assembly degradation contract: any
        coordination trouble (down, browned out past the 5 s budget)
        serves the LOCAL view with ``degraded: true`` + a bounded
        ``errors`` list — never a 5xx."""
        plane = getattr(orchestrator, "fleet", None)
        # the local view is always serveable — no I/O, no fleet
        local = {"workerId": getattr(orchestrator, "worker_id", None)}
        signals_fn = getattr(orchestrator, "autoscale_signals", None)
        if callable(signals_fn):
            try:
                local["signals"] = dict(signals_fn())
            except Exception:
                pass
        digest_fn = getattr(orchestrator, "slo_digest", None)
        if callable(digest_fn):
            try:
                local["digest"] = dict(digest_fn())
            except Exception:
                pass
        payload: dict = {
            "enabled": plane is not None,
            "workerId": getattr(orchestrator, "worker_id", None),
            "local": local,
            "overview": None,
            "degraded": False,
            "errors": [],
        }
        if plane is None:
            return web.json_response(payload)
        try:
            doc = await plane.fetch_overview()
        except asyncio.CancelledError:
            raise
        except Exception as err:
            payload["degraded"] = True
            payload["errors"].append(
                f"coord overview: {type(err).__name__}: {err}"[:200])
            doc = None
        if doc is not None:
            payload["overview"] = doc
            age = plane.overview_age()
            if age is not None:
                payload["overviewAgeSeconds"] = round(age, 3)
        # the controller's current plan rides along (watch-fed cache,
        # no extra round trip) so `cli fleet top` shows admission/
        # drain/scale posture in the same frame
        plan = plane.current_plan()
        if plan is not None:
            payload["plan"] = plan
        return web.json_response(payload)

    async def fleet_plan(_request: web.Request) -> web.Response:
        """The placement controller's plan: served from THIS
        worker's watch-fed cache — the exact document admission acts on
        here, zero coordination round trips, so the endpoint stays up
        (and honest) through coord brownout.  ``fresh`` is the router's
        own staleness gate: false means admission is running
        uncontrolled even though a (stale) plan body is shown."""
        plane = getattr(orchestrator, "fleet", None)
        controller = getattr(orchestrator, "controller", None)
        payload: dict = {
            "enabled": plane is not None,
            "workerId": getattr(orchestrator, "worker_id", None),
            "plan": None,
            "fresh": False,
            "controller": None,
        }
        if controller is not None:
            payload["controller"] = {
                "running": controller._task is not None,
                "ticks": controller.ticks,
                "plansPublished": controller.plans_published,
            }
        if plane is None:
            return web.json_response(payload)
        fresh = plane.current_plan()
        doc = fresh if fresh is not None else plane._plan_doc
        if doc is not None:
            payload["plan"] = doc
            payload["fresh"] = fresh is not None
            payload["planAgeSeconds"] = round(
                max(time.time() - float(doc.get("updatedAt", 0) or 0),
                    0.0), 3)
        return web.json_response(payload)

    async def fleet_show(request: web.Request) -> web.Response:
        plane = getattr(orchestrator, "fleet", None)
        if plane is None:
            return web.json_response(
                {"error": "fleet plane disabled"}, status=503
            )
        try:
            doc = await plane.worker(request.match_info["id"])
        except Exception as err:
            return web.json_response(
                {"error": f"coordination store: {err}"}, status=503
            )
        if doc is None:
            return web.json_response({"error": "unknown worker"},
                                     status=404)
        return web.json_response(doc)

    async def tenants_list(_request: web.Request) -> web.Response:
        """Tenancy + overload posture: per-tenant config (weight, caps,
        quotas), live per-tenant queue depth / held run slots / waiting
        jobs, and the overload controller's saturation snapshot — the
        one endpoint that answers "why is tenant X's work not starting"."""
        table = getattr(orchestrator, "tenants", None)
        if table is None:
            return web.json_response(
                {"error": "tenancy unavailable"}, status=503
            )
        registry = _registry()
        scheduler = getattr(orchestrator, "scheduler", None)
        depths = (registry.tenant_queue_depths()
                  if registry is not None else {})
        held = (scheduler.held_by_tenant()
                if scheduler is not None else {})
        waiting = (scheduler.waiting_by_tenant()
                   if scheduler is not None else {})
        footprint_fn = getattr(orchestrator, "tenant_staging_bytes", None)
        footprints = footprint_fn() if callable(footprint_fn) else {}
        tenants = {}
        for name, spec in table.describe().items():
            tenants[name] = {
                **spec,
                "queued": depths.get(name, 0),
                "runningSlots": held.get(name, 0),
                "waitingForSlot": waiting.get(name, 0),
                # live disk footprint (quotas cover transfer rate only;
                # this is the accounting half, no enforcement)
                "stagingBytes": footprints.get(name, 0),
            }
        overload = getattr(orchestrator, "overload", None)
        return web.json_response({
            "workerId": getattr(orchestrator, "worker_id", None),
            "configured": table.configured,
            "tenants": tenants,
            "overload": (overload.snapshot() if overload is not None
                         else {"enabled": False}),
        })

    async def debug_tasks(_request: web.Request) -> web.Response:
        monitor = getattr(orchestrator, "loop_monitor", None)
        return web.json_response({
            "tasks": dump_tasks(),
            "loopLag": {
                "last": getattr(monitor, "last_lag", None),
                "max": getattr(monitor, "max_lag", None),
            },
        })

    async def debug_stacks(_request: web.Request) -> web.Response:
        return web.json_response(dump_stacks())

    async def job_cancel(request: web.Request) -> web.Response:
        if not _authorized(request):
            return _deny()
        registry = _registry()
        if registry is None:
            return _unavailable()
        job_id = request.match_info["id"]
        reason = request.query.get("reason") or "operator"
        if request.can_read_body:
            try:
                body = await request.json()
                reason = body.get("reason") or reason
            except (ValueError, AttributeError):
                pass
        fired = registry.cancel(job_id, reason=reason)
        record = registry.get(job_id)
        if not fired:
            if record is None:
                return web.json_response({"error": "unknown job"}, status=404)
            # known but already terminal (or token already fired)
            return web.json_response(
                {"error": "job is not cancellable", "job": record.to_dict()},
                status=409,
            )
        return web.json_response(
            {"cancelled": len(fired), "job": record.to_dict()}, status=202
        )

    async def intake_pause(request: web.Request) -> web.Response:
        if not _authorized(request):
            return _deny()
        pause = getattr(orchestrator, "pause_intake", None)
        if pause is None:
            return _unavailable()
        await pause()
        return web.json_response({"intakePaused": True})

    async def intake_resume(request: web.Request) -> web.Response:
        if not _authorized(request):
            return _deny()
        resume = getattr(orchestrator, "resume_intake", None)
        if resume is None:
            return _unavailable()
        await resume()
        return web.json_response({"intakePaused": False})

    async def incidents_list(_request: web.Request) -> web.Response:
        """Exported incident bundles, summaries only — the
        same degradation contract as the fleet surfaces: a disabled or
        empty incident plane reads as an empty listing, never a 5xx."""
        store = getattr(orchestrator, "incidents", None)
        if store is None:
            return web.json_response({"enabled": False, "incidents": []})
        payload = {
            "enabled": True,
            "workerId": getattr(orchestrator, "worker_id", None),
            "maxBundles": store.max_bundles,
            "autoExport": store.auto_export,
            "exportedTotal": store.exported_total,
            "lastVerdict": store.last_verdict,
            "incidents": [],
        }
        try:
            payload["incidents"] = store.summaries()
        except Exception:
            pass  # a torn summary degrades to the empty list, not a 5xx
        return web.json_response(payload)

    async def incident_show(request: web.Request) -> web.Response:
        """One full bundle, by bundleId, job id, or trace id."""
        store = getattr(orchestrator, "incidents", None)
        if store is None:
            return web.json_response(
                {"error": "incident plane disabled"}, status=404)
        bundle = store.get(request.match_info["id"])
        if bundle is None:
            return web.json_response(
                {"error": "unknown incident"}, status=404)
        return web.json_response(bundle)

    async def incident_export_route(request: web.Request) -> web.Response:
        """Manual export: snapshot a live/recently-settled job into the
        ring (trigger=manual) and return the full bundle."""
        if not _authorized(request):
            return _deny()
        if getattr(orchestrator, "incidents", None) is None:
            return web.json_response(
                {"error": "incident plane disabled"}, status=409)
        bundle = export_incident(
            orchestrator, request.match_info["id"], trigger=TRIGGER_MANUAL)
        if bundle is None:
            return web.json_response({"error": "unknown job"}, status=404)
        return web.json_response(bundle, status=201)

    async def incident_verdict(request: web.Request) -> web.Response:
        """Record a replay verdict against this worker's incidents:
        `cli incident replay/diff` posts whether the replay reproduced
        the original breach signature, which lands on the
        incident_replay_signature_match gauge (so the worker that
        exported the bundle alarms on a diverging replay)."""
        if not _authorized(request):
            return _deny()
        store = getattr(orchestrator, "incidents", None)
        if store is None:
            return web.json_response(
                {"error": "incident plane disabled"}, status=409)
        try:
            body = await request.json()
        except ValueError:
            return web.json_response(
                {"error": "body must be JSON"}, status=400)
        if not isinstance(body, dict) or "match" not in body:
            return web.json_response(
                {"error": "body must carry match: bool"}, status=400)
        verdict = {
            "match": bool(body.get("match")),
            "bundleId": body.get("bundleId"),
            "fields": body.get("fields"),
        }
        store.last_verdict = verdict
        metrics = getattr(orchestrator, "metrics", None)
        if metrics is not None:
            try:
                metrics.incident_replay_signature_match.set(
                    1.0 if verdict["match"] else 0.0)
            except Exception:
                pass
        return web.json_response({"recorded": True, **verdict})

    async def drain(request: web.Request) -> web.Response:
        if not _authorized(request):
            return _deny()
        drain_fn = getattr(orchestrator, "drain", None)
        if drain_fn is None:
            return _unavailable()
        try:
            grace = float(request.query.get("grace", 30.0))
        except ValueError:
            return web.json_response(
                {"error": "grace must be a number of seconds"}, status=400
            )
        drained = await drain_fn(grace_seconds=grace)
        return web.json_response({
            "drained": drained,
            "intakePaused": True,
            "active": len(getattr(orchestrator, "active_jobs", [])),
        }, status=200 if drained else 504)

    app.router.add_get("/v1/jobs", jobs_list)
    app.router.add_get("/v1/jobs/{id}", job_show)
    app.router.add_get("/v1/jobs/{id}/events", job_events)
    app.router.add_post("/v1/jobs/{id}/cancel", job_cancel)
    # cross-worker trace assembly: local + digests + live peers
    app.router.add_get("/v1/trace/{id}", trace_show)
    # fleet plane: membership, leases, per-worker heartbeat payloads
    app.router.add_get("/v1/fleet", fleet_list)
    # the aggregated overview + the controller's plan must register
    # BEFORE the {id} route or "overview"/"plan" would be captured as
    # worker ids
    app.router.add_get("/v1/fleet/overview", fleet_overview)
    app.router.add_get("/v1/fleet/plan", fleet_plan)
    app.router.add_get("/v1/fleet/{id}", fleet_show)
    # tenancy + overload: per-tenant weights/caps/quotas, live queue
    # depth and slot occupancy, and the saturation snapshot
    app.router.add_get("/v1/tenants", tenants_list)
    # runtime introspection: reads, open like /metrics
    app.router.add_get("/debug/tasks", debug_tasks)
    app.router.add_get("/debug/stacks", debug_stacks)
    # incident plane: the bundle ring (reads open like /metrics;
    # manual exports + replay verdicts token-gated).  The literal
    # /verdict route registers before the {id} capture, like
    # /v1/fleet/overview above
    app.router.add_get("/v1/incidents", incidents_list)
    app.router.add_get("/v1/incidents/{id}", incident_show)
    app.router.add_post("/v1/incidents/verdict", incident_verdict)
    app.router.add_post("/v1/incidents/{id}/export", incident_export_route)
    app.router.add_post("/v1/intake/pause", intake_pause)
    app.router.add_post("/v1/intake/resume", intake_resume)
    app.router.add_post("/v1/drain", drain)
