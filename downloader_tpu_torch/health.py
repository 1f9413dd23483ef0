"""HTTP surface: probes + metrics + the control plane's admin API.

``GET /health`` + ``/livez`` + ``/readyz`` + ``/metrics``, plus the
``/v1/jobs`` (list / show / events / cancel), intake, drain, and
``/debug/tasks`` / ``/debug/stacks`` endpoints from ``control/api.py``
mounted on the same app (one port for probes, metrics, operations, and
runtime introspection).

``/health`` has behavioral parity with upstream lib/main.js:174-194,
including the reference's deliberate inverted semantics: a worker with zero
active jobs answers 500 ``Not Running Jobs`` (it is expected to always be
busy); otherwise 200 with ``{metadata: {success, host}, data: {active}}``.
Because the orchestrator here actually removes finished jobs (the reference's
``slice`` bug made ``activeJobs`` grow forever, lib/main.js:169), the
endpoint is now truthful — which makes it operationally wrong as a k8s
probe: an idle-but-healthy worker would be restarted.  So:

- ``/livez`` — 200 whenever the process can answer (liveness probe).
- ``/readyz`` — 200 while the orchestrator is connected and consuming,
  503 before start / after shutdown begins (readiness probe).
- ``health.sane: true`` in config flips ``/health`` itself to sane
  semantics (200 when idle, with the same payload shape); the default
  stays reference parity.

``/metrics`` exposes the Prometheus registry (reference ``Prom.expose()``,
lib/main.js:44).

Default port 3401, overridable via ``$PORT`` (reference lib/main.js:194).
"""

from __future__ import annotations

import os
import socket
from typing import Optional

from aiohttp import web

from .control.api import bind_control_routes
from .orchestrator import Orchestrator
from .platform.config import cfg_get
from .platform.metrics import Metrics

DEFAULT_PORT = 3401


def build_app(orchestrator: Orchestrator, metrics: Optional[Metrics] = None) -> web.Application:
    app = web.Application()
    sane = bool(
        cfg_get(getattr(orchestrator, "config", None), "health.sane", False)
    )

    def _payload(active: int) -> dict:
        return {
            "metadata": {"success": True, "host": socket.gethostname()},
            "data": {"active": active},
        }

    async def health(_request: web.Request) -> web.Response:
        active = len(orchestrator.active_jobs)
        if active == 0 and not sane:
            return web.json_response({"message": "Not Running Jobs"}, status=500)
        return web.json_response(_payload(active))

    async def livez(_request: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    async def readyz(_request: web.Request) -> web.Response:
        if not orchestrator.consuming:
            return web.json_response({"status": "not consuming"}, status=503)
        if getattr(orchestrator, "intake_paused", False):
            # paused via POST /v1/intake/pause or /v1/drain: alive, but
            # deliberately not taking work — not ready
            return web.json_response(
                {"status": "paused", "active": len(orchestrator.active_jobs)},
                status=503,
            )
        # dependency circuit breakers (platform/errors.py): an open
        # staging-store/convert-publish breaker means new jobs park at
        # admission — tell load-aware orchestrators to route elsewhere
        # until the half-open probe restores service.  The payload always
        # carries the states, so the open -> half_open -> closed cycle is
        # observable here as well as on /metrics.
        breakers = getattr(orchestrator, "breakers", None)
        states = breakers.states() if breakers is not None else {}
        # open-reason attribution (failure vs slow): a slow-opened
        # breaker means the dependency is up but browned out — wait it
        # out and shed; a failure-opened one means check it is up at all
        reasons = (breakers.open_reasons()
                   if breakers is not None else {})
        # readiness keys on the ADMISSION dependencies only (store +
        # publish): an open per-job breaker someone opted into must not
        # pull the whole replica out of rotation
        blocked = (breakers.blocking_dependencies(
            getattr(orchestrator, "admission_dependencies", None))
            if breakers is not None else [])
        # live SLO posture (control/slo.py): burn rates per objective
        # and window, error budget remaining, current p50/p99 — the
        # same numbers as slo_burn_rate/slo_error_budget_remaining on
        # /metrics (one memoized snapshot feeds both).  Carried on the
        # 503 breaker body too: burn-rate triage (is the SLO actually
        # bleeding?) and breaker triage (which dependency, slow or
        # failed?) read off one probe.
        slo = getattr(orchestrator, "slo", None)
        slo_block = slo.snapshot() if slo is not None else None
        if blocked:
            body = {"status": "breaker_open", "breakers": states,
                    "blocked": blocked,
                    "active": len(orchestrator.active_jobs)}
            if reasons:
                body["breakerReasons"] = reasons
            if slo_block is not None:
                body["slo"] = slo_block
            return web.json_response(body, status=503)
        payload = {"status": "ready",
                   "active": len(orchestrator.active_jobs),
                   "breakers": states}
        if reasons:
            payload["breakerReasons"] = reasons
        if slo_block is not None:
            payload["slo"] = slo_block
        # overload controller (control/overload.py): a saturated worker
        # is still READY — HIGH/NORMAL flow, only BULK is shed — but the
        # posture is surfaced so routing layers can prefer idle peers
        overload = getattr(orchestrator, "overload", None)
        if overload is not None and overload.saturated:
            payload["overload"] = {
                "saturated": True,
                "reasons": list(overload.reasons),
            }
        # fleet plane: identity + liveness posture, without awaiting the
        # coordination store (readiness probes must stay cheap — the
        # full membership view lives on GET /v1/fleet)
        plane = getattr(orchestrator, "fleet", None)
        if plane is not None:
            payload["fleet"] = {
                "workerId": plane.worker_id,
                "heldLeases": len(plane.lease_snapshot()),
                "coordErrors": plane.stats.get("coordErrors", 0),
            }
        # crash recovery (control/journal.py): what the last boot's
        # reconciliation found — recovered placeholders, restored retry
        # counters, swept orphan workdirs.  Present only when a journal
        # is configured; torn lines > 0 is worth an operator's look.
        recovery = getattr(orchestrator, "recovery", None)
        if recovery is not None:
            payload["recovery"] = recovery
        return web.json_response(payload)

    async def prom(_request: web.Request) -> web.Response:
        body = metrics.render() if metrics is not None else b""
        return web.Response(body=body, content_type="text/plain")

    app.router.add_get("/health", health)
    app.router.add_get("/livez", livez)
    app.router.add_get("/readyz", readyz)
    app.router.add_get("/metrics", prom)
    # control plane: /v1/jobs, cancel, intake pause/resume, drain
    # (degrades to 503s against orchestrators without a registry)
    bind_control_routes(app, orchestrator)
    return app


async def start_server(
    orchestrator: Orchestrator,
    metrics: Optional[Metrics] = None,
    port: Optional[int] = None,
) -> web.AppRunner:
    """Bind the HTTP surface; returns the runner (caller cleans up)."""
    app = build_app(orchestrator, metrics)
    runner = web.AppRunner(app)
    await runner.setup()
    resolved = port if port is not None else int(os.environ.get("PORT", DEFAULT_PORT))
    site = web.TCPSite(runner, "0.0.0.0", resolved)
    await site.start()
    return runner
