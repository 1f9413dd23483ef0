"""Command line of the PyTorch/CUDA port: the operator tools of the
reference's ``cli.py`` on the port's service, and the compute plane's
``upscale``/``train`` on the GPU.

    python -m downloader_tpu_torch submit --id my-movie --name "My Movie" \
        --type MOVIE --source http --uri http://host/movie.mkv [--wait]
    python -m downloader_tpu_torch mktorrent /path/to/media \
        --tracker http://tracker:8000/announce --out media.torrent
    python -m downloader_tpu_torch magnet media.torrent
    python -m downloader_tpu_torch scrape media.torrent
    python -m downloader_tpu_torch status [--url http://host:3401]
    python -m downloader_tpu_torch jobs list|show ID|events ID|cancel ID \
        [--url ...]
    python -m downloader_tpu_torch fleet list|show WORKER|top [--url ...]
    python -m downloader_tpu_torch trace show TRACE_ID [--url ...]
    python -m downloader_tpu_torch tenants [--url ...] [--json]
    python -m downloader_tpu_torch incident list|show|export|replay|diff
    python -m downloader_tpu_torch debug tasks|stacks [--url ...]
    python -m downloader_tpu_torch scrub [--json] [--local-only]
    python -m downloader_tpu_torch watch [--id my-movie]
    python -m downloader_tpu_torch upscale in.y4m out.y4m [--batch N] \
        [--model espcn|swinir-m-x4-real] \
        [--checkpoint-dir DIR] [--device cuda|cpu] [--decode/--decoder BIN] \
        [--encode/--encoder BIN] [--encode-arg ARG ...]
    python -m downloader_tpu_torch train --data MEDIA [--steps N] [--batch N] \
        [--crop N] [--lr LR] [--checkpoint-dir DIR] [--save-every N] \
        [--model-axis 1] [--seed N] [--scale N] [--features N] [--depth N] \
        [--device cuda|cpu]

Every function but ``upscale``/``train``'s and the incident replay's
world import is the reference's (``tests/test_torch_service_copies.py``
holds them to it).  ``submit``/``watch`` talk to the queue backend named
in config (AMQP in production; they refuse the in-memory backend, which
cannot reach a running service in another process); ``--wait`` and
``watch`` tap the fanout exchanges, so they observe without stealing
deliveries from the service's real consumers.  ``incident replay`` runs
a bundle's scenario on a fresh fleet of the port's workers (the world
builder of ``tests/test_torch_soak.py``).

``upscale`` drives the same ``transcode`` as the reference (optional
decode front-end and encode back-end around the engine) with the port's
:class:`~.compute.pipeline.FrameUpscaler`, on the weights of
``--checkpoint-dir``'s latest step or, without it, the seeded random
init.  ``train`` fits the upscaler on Y4M media and saves the port's own
checkpoints (:mod:`.compute.checkpoint`), resuming from the latest one.
Both take a directory of the JAX package's orbax steps as well: a model
it trained is served, and a run it started resumed, here.
Both run on the GPU unless ``--device cpu`` is given, and adopt every
visible card: ``upscale`` splits each batch over them in one process,
``train`` runs one worker per card in a process group (NCCL), with
``--model-axis`` the tensor-parallel width of its (data x model) mesh.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys

from . import schemas
from .platform.config import load_config
from .platform.logging import get_logger


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="downloader-tpu-torch",
        description="Operator tools for the downloader staging service",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    submit = sub.add_parser("submit", help="enqueue one Download job")
    submit.add_argument("--id", required=True, help="media/job id")
    submit.add_argument("--name", required=True, help="media display name")
    submit.add_argument("--creator-id", default="cli",
                        help="creator/card id used in telemetry")
    submit.add_argument(
        "--type", default="MOVIE", type=str.upper,
        choices=list(schemas.MediaType.keys()),
    )
    submit.add_argument(
        "--source", default="HTTP", type=str.upper,
        choices=list(schemas.SourceType.keys()),
    )
    submit.add_argument("--uri", required=True,
                        help="magnet:, http(s)://, file://, or bucket:// URI")
    submit.add_argument(
        "--priority", default="NORMAL", type=str.upper,
        choices=list(schemas.JobPriority.keys()),
        help="scheduling class: HIGH starts before NORMAL before BULK "
             "when the service's run slots are contended",
    )
    submit.add_argument(
        "--tenant", default="",
        help="tenant identity for the service's weighted-fair scheduler "
             "and per-tenant quotas (absent/unknown = 'default')",
    )
    submit.add_argument(
        "--ttl", type=float, default=0.0, metavar="SECONDS",
        help="optional deadline from receipt: expired BULK jobs are "
             "dropped (EXPIRED), expired HIGH/NORMAL jobs are flagged "
             "but still run (0 = no deadline)",
    )
    submit.add_argument(
        "--mirror", action="append", default=[], metavar="URL",
        help="redundant origin for the SAME entity (repeatable): http(s) "
             "mirror URLs the racing fetcher spreads byte ranges across "
             "(per-origin breakers, straggler duplication, failover), or "
             "extra webseeds for a torrent source",
    )
    submit.add_argument(
        "--source-kind", default="AUTO", type=str.upper,
        choices=list(schemas.SourceKind.keys()),
        help="how the source URI is interpreted: AUTO (historical "
             "dispatch on --source), DIRECT (whole-entity fetch), or "
             "MANIFEST (HLS-style media playlist ingested segment by "
             "segment, live or VOD)",
    )
    submit.add_argument("--queue", default=schemas.DOWNLOAD_QUEUE)
    submit.add_argument("--wait", action="store_true",
                        help="tap telemetry and block until the job's "
                             "Convert message confirms completion")
    submit.add_argument("--wait-timeout", type=float, default=600.0,
                        help="seconds before --wait gives up (exit 124; "
                             "stall-dropped jobs emit no terminal event)")

    mk = sub.add_parser("mktorrent", help="build a .torrent from a path")
    mk.add_argument("path", help="file or directory to seed")
    mk.add_argument("--tracker", action="append", default=[],
                    help="announce URL (repeatable)")
    mk.add_argument("--webseed", action="append", default=[],
                    help="BEP 19 HTTP seed URL (repeatable)")
    def _piece_length(value: str) -> int:
        n = int(value)
        if n < (1 << 14):
            raise argparse.ArgumentTypeError(
                "piece length must be >= 16384 (BEP 3 block size)"
            )
        return n

    mk.add_argument("--piece-length", type=_piece_length, default=1 << 18)
    mk.add_argument("--out", required=True, help="output .torrent path")

    mag = sub.add_parser("magnet", help="print the magnet link of a .torrent")
    mag.add_argument("torrent", help=".torrent file path")

    scrape = sub.add_parser(
        "scrape", help="swarm stats (seeders/leechers) for a .torrent"
    )
    scrape.add_argument("torrent", help=".torrent file path")

    status = sub.add_parser(
        "status", help="query a running service's /health and key metrics"
    )
    status.add_argument("--url", default="http://127.0.0.1:3401",
                        help="service base URL (default local health port)")

    jobs = sub.add_parser(
        "jobs", help="list/inspect/cancel jobs via a service's admin API"
    )
    jobs_sub = jobs.add_subparsers(dest="jobs_command", required=True)

    def _jobs_common(p):
        p.add_argument("--url", default="http://127.0.0.1:3401",
                       help="service base URL (default local health port)")
        p.add_argument("--token", default=None,
                       help="bearer token for mutating endpoints "
                            "(default: $CONTROL_TOKEN)")

    jobs_list = jobs_sub.add_parser("list", help="list live + recent jobs")
    _jobs_common(jobs_list)
    jobs_list.add_argument("--state", default=None,
                           help="filter by lifecycle state "
                                "(RECEIVED/ADMITTED/RUNNING/PARKED/"
                                "PUBLISHING/DONE/FAILED/CANCELLED/"
                                "DROPPED_POISON/EXPIRED)")
    jobs_list.add_argument("--recovered", action="store_true",
                           help="only jobs that survived a worker crash "
                                "(journal-replayed placeholders and "
                                "their adopting redeliveries)")

    jobs_show = jobs_sub.add_parser("show", help="one job's full record")
    _jobs_common(jobs_show)
    jobs_show.add_argument("id", help="media/job id")

    jobs_events = jobs_sub.add_parser(
        "events", help="one job's flight-recorder timeline (state "
                       "transitions, waits, throughput samples, cache/"
                       "retry/settle decisions, correlation ids)"
    )
    _jobs_common(jobs_events)
    jobs_events.add_argument("id", help="media/job id")
    jobs_events.add_argument("--json", action="store_true",
                             help="raw JSON instead of the timeline view "
                                  "(with --follow: one JSON object per "
                                  "new event)")
    jobs_events.add_argument("--follow", "-f", action="store_true",
                             help="live-tail: re-poll until the job "
                                  "reaches a terminal state, printing "
                                  "only new events (incident triage)")
    jobs_events.add_argument("--interval", type=float, default=1.0,
                             help="--follow poll interval in seconds "
                                  "(default 1)")

    jobs_cancel = jobs_sub.add_parser(
        "cancel", help="cooperatively cancel a job (settled, not requeued)"
    )
    _jobs_common(jobs_cancel)
    jobs_cancel.add_argument("id", help="media/job id")
    jobs_cancel.add_argument("--reason", default="cli",
                             help="recorded in the job's terminal state")

    fleet = sub.add_parser(
        "fleet", help="inspect the fleet coordination plane (workers, "
                      "liveness, content leases, shared-tier stats)"
    )
    fleet_sub = fleet.add_subparsers(dest="fleet_command", required=True)
    fleet_list = fleet_sub.add_parser(
        "list", help="live workers + every live content lease"
    )
    fleet_list.add_argument("--url", default="http://127.0.0.1:3401",
                            help="service base URL (default local health "
                                 "port)")
    fleet_list.add_argument("--json", action="store_true",
                            help="raw JSON instead of the table view")
    fleet_show = fleet_sub.add_parser(
        "show", help="one worker's latest heartbeat document (autoscale "
                     "signals, held leases, shared-tier stats)"
    )
    fleet_show.add_argument("id", help="worker id (see `fleet list`)")
    fleet_show.add_argument("--url", default="http://127.0.0.1:3401",
                            help="service base URL")
    fleet_top = fleet_sub.add_parser(
        "top", help="live-refreshing fleet overview console (GET "
                    "/v1/fleet/overview): members, queue depths, burn "
                    "rates, open breakers, routing decisions, tenant "
                    "queue shares, top hops, and the placement "
                    "controller's plan"
    )
    fleet_top.add_argument("--url", default="http://127.0.0.1:3401",
                           help="service base URL (any worker serves "
                                "the aggregated view)")
    fleet_top.add_argument("--interval", type=float, default=2.0,
                           help="refresh cadence, seconds (default 2)")
    fleet_top.add_argument("--once", action="store_true",
                           help="render one frame and exit (no screen "
                                "clearing — scriptable)")
    fleet_top.add_argument("--json", action="store_true",
                           help="raw JSON frames instead of the console "
                                "view (JSONL with --interval looping)")

    trace = sub.add_parser(
        "trace", help="cross-worker trace timelines (GET /v1/trace/{id}: "
                      "this worker's segments + peer digests + live "
                      "peer admin APIs, joined on one trace id)"
    )
    trace_sub = trace.add_subparsers(dest="trace_command", required=True)
    trace_show = trace_sub.add_parser(
        "show", help="one trace's assembled timeline: every worker's "
                     "events merged in wall-clock order, spans, hop "
                     "ledgers"
    )
    trace_show.add_argument("id", help="32-hex trace id (see `jobs show` "
                                       "traceId, or any log line)")
    trace_show.add_argument("--url", default="http://127.0.0.1:3401",
                            help="service base URL (default local health "
                                 "port)")
    trace_show.add_argument("--json", action="store_true",
                            help="raw JSON instead of the timeline view")
    trace_show.add_argument("--local", action="store_true",
                            help="this worker's view only (skip the "
                                 "coordination store and peer hops)")

    tenants = sub.add_parser(
        "tenants", help="tenancy + overload posture: per-tenant weights/"
                        "caps/quotas, live queue depth and slot "
                        "occupancy, saturation snapshot"
    )
    tenants.add_argument("--url", default="http://127.0.0.1:3401",
                         help="service base URL (default local health "
                              "port)")
    tenants.add_argument("--json", action="store_true",
                         help="raw JSON instead of the table view")

    incident = sub.add_parser(
        "incident", help="incident plane: export forensic bundles, "
                         "replay them as deterministic chaos scenarios, "
                         "diff breach signatures"
    )
    incident_sub = incident.add_subparsers(dest="incident_command",
                                           required=True)

    def _incident_common(p):
        p.add_argument("--url", default="http://127.0.0.1:3401",
                       help="service base URL (default local health port)")
        p.add_argument("--token", default=None,
                       help="bearer token for mutating endpoints "
                            "(default: $CONTROL_TOKEN)")

    incident_list = incident_sub.add_parser(
        "list", help="exported bundle summaries (GET /v1/incidents)")
    _incident_common(incident_list)
    incident_list.add_argument("--json", action="store_true",
                               help="raw JSON instead of the table view")

    incident_show = incident_sub.add_parser(
        "show", help="one full bundle by bundleId, job id, or trace id")
    _incident_common(incident_show)
    incident_show.add_argument("id", help="bundleId | job id | trace id")
    incident_show.add_argument("--out", default=None,
                               help="write the bundle JSON to a file "
                                    "instead of stdout")

    incident_export = incident_sub.add_parser(
        "export", help="snapshot a live/recent job into the ring now "
                       "(POST /v1/incidents/{id}/export, trigger=manual)")
    _incident_common(incident_export)
    incident_export.add_argument("id", help="job id | trace id")
    incident_export.add_argument("--out", default=None,
                                 help="also write the bundle JSON here")

    incident_replay = incident_sub.add_parser(
        "replay", help="compile a bundle into a deterministic chaos "
                       "scenario and run it on a fresh SoakRig fleet, "
                       "then diff breach signatures (same signature = "
                       "the incident reproduces)")
    _incident_common(incident_replay)
    incident_replay.add_argument(
        "id", nargs="?", default=None,
        help="bundleId | job id | trace id to pull from --url "
             "(or use --bundle)")
    incident_replay.add_argument("--bundle", default=None,
                                 help="read the bundle from a JSON file "
                                      "instead of the admin API")
    incident_replay.add_argument("--runs", type=int, default=1,
                                 help="consecutive replays; ALL must "
                                      "match (default 1; the bench's "
                                      "round-trip guard uses 2)")
    incident_replay.add_argument("--compile-only", action="store_true",
                                 help="print the compiled scenario and "
                                      "exit without running a fleet")
    incident_replay.add_argument("--no-report", action="store_true",
                                 help="skip POSTing the verdict back to "
                                      "--url (/v1/incidents/verdict)")

    incident_diff = incident_sub.add_parser(
        "diff", help="compare the breach signatures of two bundle JSON "
                     "files (exit 0 = same signature)")
    incident_diff.add_argument("original", help="bundle JSON file")
    incident_diff.add_argument("replay", help="bundle JSON file")

    debug = sub.add_parser(
        "debug", help="runtime introspection against a running service"
    )
    debug_sub = debug.add_subparsers(dest="debug_command", required=True)
    debug_tasks = debug_sub.add_parser(
        "tasks", help="live asyncio tasks + event-loop lag stats"
    )
    debug_tasks.add_argument("--url", default="http://127.0.0.1:3401",
                             help="service base URL")
    debug_stacks = debug_sub.add_parser(
        "stacks", help="every thread's and task's current stack "
                       "(the SIGUSR1 dump, over HTTP)"
    )
    debug_stacks.add_argument("--url", default="http://127.0.0.1:3401",
                              help="service base URL")

    scrub = sub.add_parser(
        "scrub", help="run one integrity scrub pass over the local store "
                      "(cache entries, co-located shared tier, staged "
                      "workdir outputs) and print the verdict counts"
    )
    scrub.add_argument("--json", action="store_true", dest="as_json",
                       help="machine-readable verdict counts")
    scrub.add_argument(
        "--local-only", action="store_true",
        help="skip the shared tier entirely: no shared-tier scan and no "
             "repairs from it (mismatched cache entries quarantine "
             "instead); use when the store is unreachable from here")

    watch = sub.add_parser(
        "watch", help="tail job status/progress telemetry from the queue"
    )
    watch.add_argument("--id", default=None,
                       help="only show events for this media id")
    watch.add_argument("--count", type=int, default=0,
                       help="exit after N events (0 = run until ^C)")

    upscale = sub.add_parser(
        "upscale", help="upscale Y4M (or, with --decode, any container "
                        "an external decoder reads) through the model on "
                        "the GPU"
    )
    upscale.add_argument("src", help="input .y4m path (any container "
                                     "with --decode)")
    upscale.add_argument("dst", help="output .y4m path (2x dimensions; 4x "
                                     "with swinir-m-x4-real)")
    # compute.models.MODELS, spelled out: building the parser imports no torch
    upscale.add_argument("--model", choices=("espcn", "swinir-m-x4-real"),
                         default="espcn",
                         help="espcn (default: the ESPCN-style x2 upscaler) "
                              "or swinir-m-x4-real (SwinIR-M x4 real-world, "
                              "served only, seeded weights; takes no "
                              "--checkpoint-dir)")
    upscale.add_argument("--checkpoint-dir", default=None,
                         help="checkpoint dir written by the train command "
                              "of this package or of the JAX package (its "
                              "orbax steps) (default: seeded random init)")
    upscale.add_argument("--batch", type=int, default=8,
                         help="frames per device dispatch")
    upscale.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                         help="run on the GPU (default) or, explicitly, on "
                              "the CPU's plain PyTorch path")
    upscale.add_argument("--decode", action="store_true",
                         help="pipe src through the decoder's "
                              "yuv4mpegpipe output first")
    upscale.add_argument("--decoder", default=None,
                         help="decoder binary (implies --decode; "
                              "default ffmpeg)")
    upscale.add_argument("--encode", action="store_true",
                         help="pipe the upscaled y4m through an encoder "
                              "into dst (compressed container out)")
    upscale.add_argument("--encoder", default=None,
                         help="encoder binary (implies --encode; "
                              "default ffmpeg)")
    upscale.add_argument("--encode-arg", action="append", default=None,
                         metavar="ARG", dest="encode_args",
                         help="encoder args before the output path "
                              "(repeatable; REPLACES the default set "
                              "'-c:v libx264 -preset veryfast -crf 18', "
                              "so restate what you still want)")

    train = sub.add_parser(
        "train", help="fit the upscaler on Y4M media (self-supervised SR)"
    )
    train.add_argument("--data", required=True,
                       help=".y4m file or directory of .y4m files")
    train.add_argument("--steps", type=int, default=200)
    train.add_argument("--batch", type=int, default=8)
    train.add_argument("--crop", type=int, default=64,
                       help="high-res crop edge (LR input is crop/scale)")
    train.add_argument("--lr", type=float, default=1e-3,
                       help="adam learning rate")
    train.add_argument("--checkpoint-dir", default=None,
                       help="dir to save to / resume from (resumes the JAX "
                            "package's orbax steps too)")
    train.add_argument("--save-every", type=int, default=100)
    train.add_argument("--model-axis", type=int, default=1,
                       help="tensor-parallel axis size of the mesh over "
                            "every visible GPU (one worker per card); read "
                            "only with more than one")
    train.add_argument("--seed", type=int, default=0)
    train.add_argument("--scale", type=int, default=2,
                       help="upscale factor (match the upscale engine's)")
    train.add_argument("--features", type=int, default=128,
                       help="conv width (match the upscale engine's)")
    train.add_argument("--depth", type=int, default=4,
                       help="conv layers (match the upscale engine's)")
    train.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="train on the GPU (default) or, explicitly, on "
                            "the CPU's plain PyTorch path")
    return parser


async def _submit(args) -> int:
    from .mq import new_queue, resolve_backend

    config = load_config("converter")
    logger = get_logger("downloader-cli")
    if resolve_backend(config) == "memory":
        print(
            "config selects the in-memory queue backend, which lives and "
            "dies inside one process — a running service cannot see this "
            "submission. Configure `rabbitmq: {backend: amqp}` first.",
            file=sys.stderr,
        )
        return 2
    msg = schemas.Download(
        media=schemas.Media(
            id=args.id,
            creator_id=args.creator_id,
            name=args.name,
            type=schemas.MediaType.Value(args.type),
            source=schemas.SourceType.Value(args.source),
            source_uri=args.uri,
        ),
        priority=schemas.JobPriority.Value(args.priority),
        tenant=args.tenant,
        ttl_seconds=max(args.ttl, 0.0),
        source_kind=schemas.SourceKind.Value(args.source_kind),
    )
    msg.mirrors.extend(args.mirror)
    from .platform.tracing import format_traceparent, init_tracer

    tracer = init_tracer("downloader-cli", logger, config)
    mq = new_queue(config, logger=logger)
    await mq.connect()
    try:
        # the submit span's context rides the message headers, so the
        # service's job span (and the downstream Convert) parent to it —
        # one trace across processes
        with tracer.span("submit", jobId=args.id) as span:
            headers = {"traceparent": format_traceparent(span)}
            if not args.wait:
                await mq.publish(args.queue, schemas.encode(msg),
                                 headers=headers)
                print(f"submitted {args.id} -> {args.queue}")
                return 0
            return await _submit_and_wait(mq, args, msg, headers)
    finally:
        try:
            await mq.close()
        finally:
            # flush the submit span even when the queue close fails —
            # a missing root span breaks the whole trace
            await asyncio.to_thread(tracer.close)


async def _bind_telemetry_taps(mq, on_status, on_progress) -> None:
    """Bind exclusive tap queues to the telemetry fanout exchanges and
    start consuming them — copies of every event, without stealing
    deliveries from the real telemetry consumers."""
    import os

    from .platform.telemetry import PROGRESS_EXCHANGE, STATUS_EXCHANGE

    tap = os.urandom(4).hex()
    status_q = f"v1.telemetry.tap.{tap}.status"
    progress_q = f"v1.telemetry.tap.{tap}.progress"
    await mq.bind_queue(status_q, STATUS_EXCHANGE, exclusive=True)
    await mq.bind_queue(progress_q, PROGRESS_EXCHANGE, exclusive=True)
    await mq.listen(status_q, on_status)
    await mq.listen(progress_q, on_progress)


async def _submit_and_wait(mq, args, msg, headers=None) -> int:
    """Publish, then follow the job until its Convert message appears.

    Taps are bound BEFORE the publish so no event can be missed.  The
    Convert message is the only true completion signal: it is published
    after the done marker, and ERRORED statuses are informational (the
    job is redelivered and may still succeed).  Jobs the service drops
    via the stall policy emit no terminal event at all, so the wait is
    bounded by --wait-timeout (exit 124)."""
    import os

    errored = schemas.TelemetryStatus.Value("ERRORED")
    done = asyncio.Event()

    async def on_status(delivery):
        event = schemas.decode(schemas.TelemetryStatusEvent, delivery.body)
        await delivery.ack()
        if event.media_id != args.id:
            return
        name = schemas.TelemetryStatus.Name(event.status)
        suffix = "\t(will retry)" if event.status == errored else ""
        print(f"{args.id}\tstatus\t{name}{suffix}", flush=True)

    async def on_progress(delivery):
        event = schemas.decode(schemas.TelemetryProgressEvent, delivery.body)
        await delivery.ack()
        if event.media_id == args.id:
            print(f"{args.id}\tprogress\t{event.percent}%", flush=True)

    async def on_convert(delivery):
        event = schemas.decode(schemas.Convert, delivery.body)
        await delivery.ack()
        if event.media.id == args.id:
            done.set()

    await _bind_telemetry_taps(mq, on_status, on_progress)
    convert_tap = f"v1.convert.tap.{os.urandom(4).hex()}"
    await mq.bind_queue(convert_tap, schemas.CONVERT_EXCHANGE,
                        exclusive=True)
    await mq.listen(convert_tap, on_convert)

    await mq.publish(args.queue, schemas.encode(msg), headers=headers)
    print(f"submitted {args.id} -> {args.queue}", flush=True)
    try:
        async with asyncio.timeout(args.wait_timeout):
            await done.wait()
    except TimeoutError:
        print(f"{args.id}: no completion within {args.wait_timeout:.0f}s "
              "(stall-dropped jobs emit no terminal event)",
              file=sys.stderr)
        return 124
    except (KeyboardInterrupt, asyncio.CancelledError):
        return 130
    print(f"{args.id} staged (Convert published)")
    return 0


async def _status(args) -> int:
    import aiohttp

    base = args.url.rstrip("/")
    timeout = aiohttp.ClientTimeout(total=10)  # diagnostics must not hang
    async with aiohttp.ClientSession(timeout=timeout) as session:
        try:
            async with session.get(f"{base}/health") as resp:
                health = await resp.json()
                # reference parity: an idle worker answers 500
                busy = resp.status == 200
            print(f"health: {'busy' if busy else 'idle'} {health}")
            async with session.get(f"{base}/metrics") as resp:
                text = await resp.text()
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as err:
            print(f"{base}: unreachable ({err})", file=sys.stderr)
            return 2
    wanted = ("jobs_consumed_total", "jobs_completed_total",
              "jobs_failed_total", "jobs_skipped_total", "jobs_active",
              "bytes_downloaded_total", "bytes_uploaded_total")
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        if any(key in line for key in wanted):
            print(line)
    return 0


async def _jobs(args) -> int:
    """Drive the control plane's admin API (health.py port)."""
    import json

    import aiohttp

    base = args.url.rstrip("/")
    token = args.token or os.environ.get("CONTROL_TOKEN")
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    timeout = aiohttp.ClientTimeout(total=60)  # drain-adjacent ops can wait
    async with aiohttp.ClientSession(timeout=timeout,
                                     headers=headers) as session:
        try:
            if args.jobs_command == "list":
                params = {"state": args.state} if args.state else {}
                if args.recovered:
                    params["recovered"] = "true"
                async with session.get(f"{base}/v1/jobs",
                                       params=params) as resp:
                    body = await resp.json()
                    if resp.status != 200:
                        print(json.dumps(body), file=sys.stderr)
                        return 1
                if body.get("intakePaused"):
                    print("# intake PAUSED", file=sys.stderr)
                for job in body.get("jobs", []):
                    stage = job.get("stage") or "-"
                    percent = job.get("percent")
                    progress = f"{percent}%" if percent is not None else "-"
                    print(f"{job['id']}\t{job['state']}\t{stage}\t{progress}"
                          f"\t{job.get('priority', 'NORMAL')}")
                return 0
            if args.jobs_command == "show":
                async with session.get(
                    f"{base}/v1/jobs/{args.id}"
                ) as resp:
                    body = await resp.json()
                    print(json.dumps(body, indent=2, sort_keys=True))
                    return 0 if resp.status == 200 else 1
            if args.jobs_command == "events":
                from .control.registry import TERMINAL_STATES

                # --follow: re-poll until the job settles, printing only
                # events not yet shown.  ``eventsDropped + len(events)``
                # is the record's total-events-ever counter, so new
                # events are exactly the tail past what was printed —
                # correct even when the bounded ring wraps mid-tail.
                printed_total = 0
                header_shown = False
                while True:
                    async with session.get(
                        f"{base}/v1/jobs/{args.id}/events"
                    ) as resp:
                        body = await resp.json()
                        if resp.status != 200:
                            print(json.dumps(body), file=sys.stderr)
                            return 1
                    if args.json and not args.follow:
                        print(json.dumps(body, indent=2, sort_keys=True))
                        return 0
                    if not header_shown and not args.json:
                        header_shown = True
                        print(f"# {body['id']}\tstate={body['state']}\t"
                              f"traceId={body.get('traceId')}")
                        if body.get("eventsDropped"):
                            print(f"# {body['eventsDropped']} older "
                                  "events dropped (ring bound)",
                                  file=sys.stderr)
                    dropped = body.get("eventsDropped", 0)
                    events = body.get("events", [])
                    start = max(printed_total - dropped, 0)
                    for event in events[start:]:
                        if args.json:
                            # --follow --json: one JSON object per NEW
                            # event (jq-able stream), not repeated
                            # whole-body dumps
                            print(json.dumps(event, sort_keys=True),
                                  flush=True)
                            continue
                        event = dict(event)
                        ts = event.pop("t", "")
                        kind = event.pop("kind", "?")
                        rest = " ".join(
                            f"{k}={v}" for k, v in event.items())
                        print(f"{ts}\t{kind}\t{rest}", flush=True)
                    printed_total = dropped + len(events)
                    if not args.follow or body["state"] in TERMINAL_STATES:
                        return 0
                    await asyncio.sleep(max(args.interval, 0.1))
            # cancel
            async with session.post(
                f"{base}/v1/jobs/{args.id}/cancel",
                json={"reason": args.reason},
            ) as resp:
                body = await resp.json()
                print(json.dumps(body, indent=2, sort_keys=True))
                return 0 if resp.status in (200, 202) else 1
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as err:
            print(f"{base}: unreachable ({err})", file=sys.stderr)
            return 2


def render_overview(body: dict) -> list:
    """The `fleet top` frame lines for one GET /v1/fleet/overview body
    (pure: unit-testable without a terminal or a fleet)."""
    lines = []
    overview = body.get("overview") or {}
    totals = overview.get("totals") or {}
    degraded = body.get("degraded", False)
    header = (f"# fleet overview via {body.get('workerId')}"
              + (f"  age={body.get('overviewAgeSeconds')}s"
                 if body.get("overviewAgeSeconds") is not None else "")
              + (f"  aggregated by {overview.get('updatedBy')}"
                 if overview.get("updatedBy") else "")
              + ("  [DEGRADED: local view only]" if degraded else ""))
    lines.append(header)
    for err in body.get("errors") or []:
        lines.append(f"# error: {err}")
    members = overview.get("workers")
    if members is None:
        # degraded to local-only: render this worker's own view so the
        # console stays useful mid-incident
        local = body.get("local") or {}
        members = [{"workerId": local.get("workerId"),
                    "signals": local.get("signals"),
                    "digest": local.get("digest"),
                    "heartbeatAt": None, "leases": "-"}]
    import time as _time

    now = _time.time()
    plan = body.get("plan")
    lines.append("WORKER            QUEUE ACTIVE LEASES  "
                 "BURN fast/slow (worst)   BREAKERS     "
                 "DECISION      BEAT")
    for member in members:
        signals = member.get("signals") or {}
        digest = member.get("digest")
        burn = "-"
        breakers = "-"
        decision = "-"
        if isinstance(digest, dict):
            last = digest.get("lastDecision")
            if isinstance(last, dict) and last.get("outcome"):
                decision = str(last["outcome"])
            if (isinstance(plan, dict)
                    and member.get("workerId") in (plan.get("drain")
                                                   or [])):
                decision = "drain"
        if isinstance(digest, dict):
            rates = digest.get("burn") or {}
            if rates:
                worst = max(
                    rates.items(),
                    key=lambda kv: ((kv[1] or {}).get("fast", 0.0),
                                    (kv[1] or {}).get("slow", 0.0)))
                burn = (f"{worst[0]} "
                        f"{(worst[1] or {}).get('fast', 0):.2f}/"
                        f"{(worst[1] or {}).get('slow', 0):.2f}")
            open_breakers = digest.get("openBreakers") or {}
            if open_breakers:
                breakers = ",".join(
                    f"{dep}:{(info or {}).get('reason') or 'open'}"
                    for dep, info in sorted(open_breakers.items()))
        elif digest is None:
            burn = "(no digest)"  # pre-digest worker: listed, not lost
        beat = member.get("heartbeatAt")
        beat_s = (f"{max(now - float(beat), 0.0):.1f}s"
                  if isinstance(beat, (int, float)) else "-")
        lines.append(
            f"{str(member.get('workerId'))[:17]:<17} "
            f"{signals.get('queue_depth', '-'):>5} "
            f"{signals.get('active_jobs', '-'):>6} "
            f"{str(member.get('leases', '-')):>6}  "
            f"{burn:<24} {breakers:<12} {decision:<13} {beat_s}")
    shares = totals.get("tenantShares") or {}
    if shares:
        lines.append("tenant queue shares: " + "  ".join(
            f"{tenant}={share:.0%}"
            for tenant, share in sorted(shares.items())))
    hops = totals.get("topHops") or []
    if hops:
        lines.append("top hops (s/GB): " + "  ".join(
            f"{h.get('hop')}={h.get('secondsPerGb')}" for h in hops))
    cpu_per_gb = totals.get("cpuSPerGb")
    if cpu_per_gb is not None:
        top = (f"  top offender: {hops[0].get('hop')}"
               f"={hops[0].get('secondsPerGb')}" if hops else "")
        lines.append(f"staging copy cost (cpu s/GB): {cpu_per_gb}{top}")
    ratio = totals.get("hopReconcileRatioMixed")
    if ratio is not None:
        lines.append(f"hop/stage reconcile (mixed, unguarded): {ratio}")
    scrub = totals.get("scrub") or {}
    if any(scrub.get(k) for k in ("clean", "repaired", "quarantined")):
        lines.append(
            f"scrub: clean={scrub.get('clean', 0)} "
            f"repaired={scrub.get('repaired', 0)} "
            f"quarantined={scrub.get('quarantined', 0)}")
    if isinstance(plan, dict):
        admission = plan.get("admission") or {}
        shed = ("SHED BULK (" + str(admission.get("reason") or "") + ")"
                if admission.get("shedBulk") else "admit all")
        drain = ",".join(plan.get("drain") or []) or "none"
        tail = plan.get("decisions") or []
        last = (f"  last: {tail[-1].get('kind')} ({tail[-1].get('why')})"
                if tail else "")
        lines.append(
            f"plan[{plan.get('epoch')}] by {plan.get('updatedBy')}: "
            f"{shed}  drain={drain}  "
            f"desired={plan.get('desiredWorkers')} "
            f"({plan.get('scale')}){last}")
    return lines


async def _fleet_top(args) -> int:
    """`cli fleet top`: a live-refreshing console over GET
    /v1/fleet/overview — the fleet's burn rates, breakers, tenant
    shares, and worst hops on one screen, from any worker."""
    import json

    import aiohttp

    base = args.url.rstrip("/")
    timeout = aiohttp.ClientTimeout(total=30)
    async with aiohttp.ClientSession(timeout=timeout) as session:
        while True:
            try:
                async with session.get(
                        f"{base}/v1/fleet/overview") as resp:
                    body = await resp.json()
                    if resp.status != 200:
                        print(json.dumps(body), file=sys.stderr)
                        return 1
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError) as err:
                print(f"{base}: unreachable ({err})", file=sys.stderr)
                if args.once:
                    return 2
                # a refreshing console must SURVIVE one dropped
                # connection or a worker restart — mid-incident is
                # exactly when the operator is watching; keep the
                # last frame on screen and retry next interval
                await asyncio.sleep(max(args.interval, 0.2))
                continue
            if args.json:
                print(json.dumps(body, sort_keys=True))
            else:
                if not args.once:
                    # clear + home: a refreshing console, not a scroll
                    print("\x1b[2J\x1b[H", end="")
                for line in render_overview(body):
                    print(line)
            if args.once:
                return 0
            try:
                await asyncio.sleep(max(args.interval, 0.2))
            except (KeyboardInterrupt, asyncio.CancelledError):
                return 0


async def _fleet(args) -> int:
    """Drive the fleet endpoints (mirrors the `jobs` UX)."""
    import json
    import time

    import aiohttp

    if args.fleet_command == "top":
        return await _fleet_top(args)
    base = args.url.rstrip("/")
    timeout = aiohttp.ClientTimeout(total=30)
    async with aiohttp.ClientSession(timeout=timeout) as session:
        try:
            if args.fleet_command == "show":
                async with session.get(
                    f"{base}/v1/fleet/{args.id}"
                ) as resp:
                    body = await resp.json()
                    print(json.dumps(body, indent=2, sort_keys=True))
                    return 0 if resp.status == 200 else 1
            async with session.get(f"{base}/v1/fleet") as resp:
                body = await resp.json()
                if resp.status != 200:
                    print(json.dumps(body), file=sys.stderr)
                    return 1
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as err:
            print(f"{base}: unreachable ({err})", file=sys.stderr)
            return 2
    if args.json:
        print(json.dumps(body, indent=2, sort_keys=True))
        return 0
    if not body.get("enabled"):
        print(f"# fleet plane disabled on {body.get('workerId') or base}",
              file=sys.stderr)
        return 0
    now = time.time()
    print(f"# this worker: {body.get('workerId')}")
    for worker in body.get("workers", []):
        signals = worker.get("signals") or {}
        beat_age = now - float(worker.get("heartbeatAt", now))
        stats = worker.get("stats") or {}
        print(f"{worker.get('workerId')}\tbeat={beat_age:.1f}s ago"
              f"\tqueue={signals.get('queue_depth', '-')}"
              f"\tactive={signals.get('active_jobs', '-')}"
              f"\tleases={len(worker.get('leases') or [])}"
              f"\tsharedHits={stats.get('sharedHits', 0)}"
              f"\tsharedFills={stats.get('sharedFills', 0)}")
    for lease in body.get("leases", []):
        flag = "EXPIRED" if lease.get("expired") else "live"
        print(f"lease {lease.get('key', '')[:16]}\t{flag}"
              f"\towner={lease.get('owner')}"
              f"\tfence={lease.get('fence')}")
    return 0


async def _trace(args) -> int:
    """Render GET /v1/trace/{id}: one wall-clock-ordered timeline of
    every worker's events for the trace, plus spans and hop ledgers."""
    import json

    import aiohttp

    base = args.url.rstrip("/")
    timeout = aiohttp.ClientTimeout(total=30)  # peer hops can add up
    params = {"scope": "local"} if args.local else {}
    async with aiohttp.ClientSession(timeout=timeout) as session:
        try:
            async with session.get(f"{base}/v1/trace/{args.id}",
                                   params=params) as resp:
                body = await resp.json()
                if resp.status != 200:
                    print(json.dumps(body), file=sys.stderr)
                    return 1
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as err:
            print(f"{base}: unreachable ({err})", file=sys.stderr)
            return 2
    if args.json:
        print(json.dumps(body, indent=2, sort_keys=True))
        return 0
    from .control.trace import merged_timeline

    print(f"# trace {body['traceId']}\tworkers="
          f"{','.join(body.get('workers') or []) or '-'}")
    if body.get("degraded"):
        print("# DEGRADED view (coordination/peer trouble): "
              + "; ".join(body.get("errors") or []), file=sys.stderr)
    for segment in body.get("segments") or []:
        hops = segment.get("hopLedger") or {}
        hop_view = " ".join(
            f"{hop}={entry.get('seconds')}s/{entry.get('bytes')}B"
            for hop, entry in hops.items()
        )
        print(f"# job {segment.get('jobId')}\t{segment.get('state')}"
              f"\tworker={segment.get('workerId')}"
              f"\tsource={segment.get('source')}"
              + (f"\tlink={segment['link']}" if segment.get("link")
                 else "")
              + (f"\n#   hops: {hop_view}" if hop_view else ""))
    for row in merged_timeline(body):
        ts = row.pop("t", "")
        kind = row.pop("kind", "?")
        worker = row.pop("workerId", "-")
        job = row.pop("jobId", "-")
        rest = " ".join(f"{k}={v}" for k, v in row.items())
        print(f"{ts}\t{worker}\t{job}\t{kind}\t{rest}")
    spans = body.get("spans") or []
    if spans:
        print(f"# {len(spans)} span(s)")
        for span in sorted(spans, key=lambda s: s.get("startTime") or 0):
            print(f"{span.get('startTime')}\t{span.get('workerId') or '-'}"
                  f"\tspan\t{span.get('name')}"
                  f"\tduration={round(span.get('duration', 0), 4)}s"
                  + (f"\terror={span['error']}" if span.get("error")
                     else ""))
    return 0


async def _tenants(args) -> int:
    """Render GET /v1/tenants (mirrors the `fleet list` UX)."""
    import json

    import aiohttp

    base = args.url.rstrip("/")
    timeout = aiohttp.ClientTimeout(total=10)
    async with aiohttp.ClientSession(timeout=timeout) as session:
        try:
            async with session.get(f"{base}/v1/tenants") as resp:
                body = await resp.json()
                if resp.status != 200:
                    print(json.dumps(body), file=sys.stderr)
                    return 1
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as err:
            print(f"{base}: unreachable ({err})", file=sys.stderr)
            return 2
    if args.json:
        print(json.dumps(body, indent=2, sort_keys=True))
        return 0
    overload = body.get("overload") or {}
    if overload.get("saturated"):
        print("# worker SATURATED: shedding BULK "
              f"(reasons: {','.join(overload.get('reasons', []))})",
              file=sys.stderr)
    if not body.get("configured"):
        print("# no tenants.* config: every job runs as 'default'",
              file=sys.stderr)
    for name, t in sorted((body.get("tenants") or {}).items()):
        cap = t.get("maxConcurrent")
        print(f"{name}\tweight={t.get('weight')}"
              f"\tcap={cap if cap is not None else '-'}"
              f"\tqueued={t.get('queued', 0)}"
              f"\trunning={t.get('runningSlots', 0)}"
              f"\twaiting={t.get('waitingForSlot', 0)}"
              f"\tdl={t.get('downloadRateLimit') or '-'}"
              f"\tul={t.get('uploadRateLimit') or '-'}")
    return 0


async def _incident(args) -> int:
    """Drive the incident plane (downloader_tpu_torch/incident):
    list/show/export bundles over the admin API, replay one on a fresh
    SoakRig fleet, and diff breach signatures."""
    import json

    import aiohttp

    if args.incident_command == "diff":
        from .incident.replay import bundle_signature, diff_signatures

        with open(args.original, encoding="utf-8") as fh:
            original = json.load(fh)
        with open(args.replay, encoding="utf-8") as fh:
            replay = json.load(fh)
        verdict = diff_signatures(bundle_signature(original),
                                  bundle_signature(replay))
        _print_signature_diff(verdict)
        return 0 if verdict["match"] else 1

    if args.incident_command == "replay":
        return await _incident_replay(args)

    base = args.url.rstrip("/")
    token = args.token or os.environ.get("CONTROL_TOKEN")
    headers = {"Authorization": f"Bearer {token}"} if token else {}
    timeout = aiohttp.ClientTimeout(total=30)
    async with aiohttp.ClientSession(timeout=timeout,
                                     headers=headers) as session:
        try:
            if args.incident_command == "list":
                async with session.get(f"{base}/v1/incidents") as resp:
                    body = await resp.json()
                    if resp.status != 200:
                        print(json.dumps(body), file=sys.stderr)
                        return 1
                if args.json:
                    print(json.dumps(body, indent=2, sort_keys=True))
                    return 0
                if not body.get("enabled"):
                    print("# incident plane disabled "
                          "(incident.enabled: false)", file=sys.stderr)
                verdict = body.get("lastVerdict")
                if verdict is not None:
                    print("# last replay verdict: "
                          + ("MATCH" if verdict.get("match")
                             else "DIVERGED"), file=sys.stderr)
                for row in body.get("incidents", []):
                    objectives = ",".join(row.get("objectives") or []) or "-"
                    print(f"{row.get('bundleId')}\t{row.get('trigger')}"
                          f"\t{row.get('jobId')}\t{row.get('state')}"
                          f"\tbreaches={row.get('breaches')}"
                          f"\tobjectives={objectives}"
                          f"\t{row.get('exportedAt')}")
                return 0

            if args.incident_command == "show":
                async with session.get(
                        f"{base}/v1/incidents/{args.id}") as resp:
                    body = await resp.json()
                    if resp.status != 200:
                        print(json.dumps(body), file=sys.stderr)
                        return 1
                return _emit_bundle(body, args.out)

            if args.incident_command == "export":
                async with session.post(
                        f"{base}/v1/incidents/{args.id}/export") as resp:
                    body = await resp.json()
                    if resp.status not in (200, 201):
                        print(json.dumps(body), file=sys.stderr)
                        return 1
                print(f"# exported {body.get('bundleId')} "
                      f"(trigger={body.get('trigger')})", file=sys.stderr)
                return _emit_bundle(body, args.out)
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as err:
            print(f"{base}: unreachable ({err})", file=sys.stderr)
            return 2
    raise AssertionError("unreachable")


def _emit_bundle(bundle: dict, out) -> int:
    import json

    blob = json.dumps(bundle, indent=2, sort_keys=True)
    if out:
        with open(out, "w", encoding="utf-8") as fh:
            fh.write(blob + "\n")
        print(f"# wrote {out}", file=sys.stderr)
    else:
        print(blob)
    return 0


def _print_signature_diff(verdict: dict) -> None:
    import json

    for name, field in verdict["fields"].items():
        mark = "=" if field["match"] else "!"
        print(f"{mark} {name}\toriginal={json.dumps(field['original'])}"
              f"\treplay={json.dumps(field['replay'])}")
    print("match" if verdict["match"] else "DIVERGED")


async def _incident_replay(args) -> int:
    """Pull (or read) a bundle, compile it, run the scenario on a fresh
    SoakRig fleet --runs times, and require EVERY replay to reproduce
    the original breach signature."""
    import json
    import tempfile

    import aiohttp

    from .incident.compiler import compile_bundle, scenario_profile
    from .incident.replay import (diff_signatures,
                                  signature_from_incidents)

    base = args.url.rstrip("/")
    if args.bundle:
        with open(args.bundle, encoding="utf-8") as fh:
            bundle = json.load(fh)
    elif args.id:
        timeout = aiohttp.ClientTimeout(total=30)
        async with aiohttp.ClientSession(timeout=timeout) as session:
            try:
                async with session.get(
                        f"{base}/v1/incidents/{args.id}") as resp:
                    bundle = await resp.json()
                    if resp.status != 200:
                        print(json.dumps(bundle), file=sys.stderr)
                        return 1
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError) as err:
                print(f"{base}: unreachable ({err})", file=sys.stderr)
                return 2
    else:
        print("incident replay: give a bundle id or --bundle FILE",
              file=sys.stderr)
        return 1

    scenario = compile_bundle(bundle)
    if args.compile_only:
        print(json.dumps(scenario, indent=2, sort_keys=True))
        return 0

    # the port's SoakTestWorld lives with the port's tests (it wires the
    # broker copy + MiniS3 + loopback origins around the port's rig),
    # never the reference's test_soak, which would run the JAX package's
    # workers
    tests_dir = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tests")
    tests_dir = os.path.abspath(tests_dir)
    if tests_dir not in sys.path:
        sys.path.insert(0, tests_dir)
    from test_torch_soak import SoakTestWorld

    original_sig = scenario["signature"]
    print(f"# replaying {scenario.get('source')}: "
          f"{len(scenario['faultPlan'])} fault rule(s), "
          f"{scenario['profile'].get('jobs')} jobs x{args.runs} run(s)",
          file=sys.stderr)
    all_match = True
    last_verdict = None
    for run in range(max(args.runs, 1)):
        profile = scenario_profile(scenario)
        with tempfile.TemporaryDirectory() as tmp:
            world = await SoakTestWorld.create(tmp, profile)
            try:
                await world.rig.run(world.workload)
                replay_sig = signature_from_incidents(world.rig.incidents)
            finally:
                await world.close()
        verdict = diff_signatures(original_sig, replay_sig)
        last_verdict = verdict
        print(f"# run {run + 1}/{args.runs}: "
              + ("signature MATCH" if verdict["match"] else "DIVERGED"),
              file=sys.stderr)
        _print_signature_diff(verdict)
        all_match = all_match and verdict["match"]

    if not args.no_report and last_verdict is not None:
        # best-effort: land the verdict on the worker that exported the
        # bundle (incident_replay_signature_match gauge)
        token = args.token or os.environ.get("CONTROL_TOKEN")
        headers = ({"Authorization": f"Bearer {token}"} if token else {})
        try:
            timeout = aiohttp.ClientTimeout(total=10)
            async with aiohttp.ClientSession(timeout=timeout,
                                             headers=headers) as session:
                async with session.post(
                        f"{base}/v1/incidents/verdict",
                        json={"match": all_match,
                              "bundleId": bundle.get("bundleId"),
                              "fields": last_verdict["fields"]}) as resp:
                    await resp.read()
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
            pass
    return 0 if all_match else 1


async def _debug(args) -> int:
    """Drive the runtime-introspection endpoints (/debug/*)."""
    import json

    import aiohttp

    base = args.url.rstrip("/")
    timeout = aiohttp.ClientTimeout(total=10)  # diagnostics must not hang
    async with aiohttp.ClientSession(timeout=timeout) as session:
        try:
            async with session.get(
                f"{base}/debug/{args.debug_command}"
            ) as resp:
                body = await resp.json()
                if resp.status != 200:
                    print(json.dumps(body), file=sys.stderr)
                    return 1
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as err:
            print(f"{base}: unreachable ({err})", file=sys.stderr)
            return 2
    if args.debug_command == "tasks":
        lag = body.get("loopLag") or {}
        print(f"# loop lag: last={lag.get('last')} max={lag.get('max')}")
        for task in body.get("tasks", []):
            top = task["stack"][-1] if task.get("stack") else "-"
            print(f"{task['name']}\t{task['coro']}\t{top}")
        return 0
    for thread in body.get("threads", []):
        print(f"== thread {thread['name']} ({thread['threadId']})")
        for line in thread.get("stack", []):
            print(line)
    for task in body.get("tasks", []):
        print(f"== task {task['name']} ({task['coro']})")
        for line in task.get("stack", []):
            print(f"  {line}")
    return 0


async def _scrub(args) -> int:
    """One synchronous scrub pass, in-process (no running service).

    Builds the same cache/fleet/workdir trio the orchestrator hands its
    background scrubber and runs a single ``scan()`` — so an operator
    can force a full integrity pass (post-incident, after swapping a
    disk) without waiting out ``scrub.interval``, including against a
    stopped instance.  ``scrub.enabled: false`` only removes the
    BACKGROUND loop; an explicit invocation always runs.  Exit 0 when
    nothing was quarantined (clean or repaired are both fine), 1 when
    something was (bytes lost their last healthy replica — page on it),
    2 when the shared tier is unreachable and ``--local-only`` wasn't
    given (refusing to quarantine entries a reachable tier would have
    repaired).
    """
    import json

    from .fleet.plane import FleetPlane, resolve_worker_id
    from .platform.config import cfg_get
    from .stages.download import job_download_dir
    from .store import new_client
    from .store.cache import ContentCache
    from .store.scrub import (DEFAULT_INTERVAL, DEFAULT_RATE_MB_S,
                              Scrubber)

    config = load_config("converter")
    logger = get_logger("downloader-scrub")
    cache = ContentCache.from_config(config, logger=logger)
    fleet = None
    if not args.local_only:
        try:
            fleet = FleetPlane.from_config(
                config, worker_id=resolve_worker_id(config),
                store=new_client(config), logger=logger,
            )
        except Exception as err:
            print(
                f"shared tier unavailable ({type(err).__name__}: {err}); "
                "re-run with --local-only to scrub without repairs",
                file=sys.stderr,
            )
            return 2
    scrubber = Scrubber(
        cache=cache, fleet=fleet,
        workdir_root=os.path.dirname(job_download_dir(config, "_probe")),
        quarantine_dir=cfg_get(config, "scrub.quarantine_dir", None),
        interval=float(cfg_get(config, "scrub.interval",
                               DEFAULT_INTERVAL)),
        rate_bytes=float(cfg_get(config, "scrub.rate_mb_s",
                                 DEFAULT_RATE_MB_S)) * 1e6,
        logger=logger,
    )
    counts = await scrubber.scan()
    snap = scrubber.snapshot()
    if args.as_json:
        print(json.dumps({**counts,
                          "passSeconds": snap.get("lastPassSeconds")}))
    else:
        print(f"scrub pass complete: clean={counts['clean']} "
              f"repaired={counts['repaired']} "
              f"quarantined={counts['quarantined']} "
              f"({snap.get('lastPassSeconds', 0.0)}s)")
    return 0 if counts["quarantined"] == 0 else 1


async def _watch(args) -> int:
    from .mq import new_queue, resolve_backend

    config = load_config("converter")
    logger = get_logger("downloader-cli")
    if resolve_backend(config) == "memory":
        print(
            "config selects the in-memory queue backend; telemetry from a "
            "running service is not reachable from this process. Configure "
            "`rabbitmq: {backend: amqp}` first.",
            file=sys.stderr,
        )
        return 2

    seen = 0
    done = asyncio.Event()

    def _emit(line: str) -> None:
        nonlocal seen
        print(line, flush=True)
        seen += 1
        if args.count and seen >= args.count:
            done.set()

    async def on_status(delivery):
        event = schemas.decode(schemas.TelemetryStatusEvent, delivery.body)
        await delivery.ack()
        if args.id and event.media_id != args.id:
            return
        name = schemas.TelemetryStatus.Name(event.status)
        _emit(f"{event.media_id}\tstatus\t{name}")

    async def on_progress(delivery):
        event = schemas.decode(schemas.TelemetryProgressEvent, delivery.body)
        await delivery.ack()
        if args.id and event.media_id != args.id:
            return
        name = schemas.TelemetryStatus.Name(event.status)
        _emit(f"{event.media_id}\tprogress\t{name}\t{event.percent}%")

    mq = new_queue(config, logger=logger)
    await mq.connect()
    try:
        await _bind_telemetry_taps(mq, on_status, on_progress)
        try:
            await done.wait()
        except (KeyboardInterrupt, asyncio.CancelledError):
            pass
    finally:
        await mq.close()
    return 0


def _mktorrent(args) -> int:
    from .torrent import make_metainfo

    meta = make_metainfo(
        args.path,
        piece_length=args.piece_length,
        trackers=args.tracker,
        webseeds=args.webseed,
    )
    with open(args.out, "wb") as fh:
        fh.write(meta.to_torrent_bytes())
    print(f"{args.out}: {meta.num_pieces} pieces x {meta.piece_length} "
          f"({meta.total_length} bytes), infohash {meta.info_hash.hex()}")
    return 0


async def _scrape(args) -> int:
    from .torrent import tracker as tracker_mod
    from .torrent.metainfo import parse_torrent_bytes

    with open(args.torrent, "rb") as fh:
        meta = parse_torrent_bytes(fh.read())
    if not meta.trackers:
        print("torrent has no trackers to scrape", file=sys.stderr)
        return 2
    # trackers are independent: query them concurrently so dead ones
    # don't serialize their timeouts in front of the live ones
    results = await asyncio.gather(
        *(tracker_mod.scrape(url, meta.info_hash) for url in meta.trackers),
        return_exceptions=True,
    )
    failures = 0
    for url, stats in zip(meta.trackers, results):
        if isinstance(stats, BaseException):
            print(f"{url}\terror\t{stats}", file=sys.stderr)
            failures += 1
            continue
        print(f"{url}\tseeders={stats.seeders}\tleechers={stats.leechers}"
              f"\tcompleted={stats.completed}")
    return 0 if failures < len(meta.trackers) else 1


def _upscale(args) -> int:
    import shutil

    from .compute.models import model_config
    from .compute.pipeline import FrameUpscaler
    from .compute.transcode import DEFAULT_ENCODE_ARGS, transcode

    # naming a decoder/encoder (or passing encode args) implies the mode;
    # binaries resolve BEFORE the engine is built, so a usage error does
    # not pay for device start-up
    decoder = encoder = None
    if args.decode or args.decoder:
        name = args.decoder or "ffmpeg"
        decoder = shutil.which(name)
        if decoder is None:
            print(f"decoder {name!r} not found on PATH", file=sys.stderr)
            return 2
    if args.encode or args.encoder or args.encode_args:
        name = args.encoder or "ffmpeg"
        encoder = shutil.which(name)
        if encoder is None:
            print(f"encoder {name!r} not found on PATH", file=sys.stderr)
            return 2
    upscaler = FrameUpscaler(config=model_config(args.model), batch=args.batch,
                             device=args.device,
                             checkpoint_dir=args.checkpoint_dir)
    try:
        # transcode writes through a private temp and renames onto dst
        # only on success: a pre-existing dst survives any error
        frames = transcode(
            upscaler, args.src, args.dst,
            decoder=decoder, encoder=encoder,
            encode_args=args.encode_args or DEFAULT_ENCODE_ARGS,
        )
    except RuntimeError as err:
        print(f"transcode failed: {err}", file=sys.stderr)
        return 1
    print(f"upscaled {frames} frames -> {args.dst}")
    return 0


def _train(args) -> int:
    from .compute.trainer import TrainerSettings, discover_media, train

    paths = discover_media(args.data)
    settings = TrainerSettings(
        steps=args.steps,
        batch=args.batch,
        crop=args.crop,
        learning_rate=args.lr,
        checkpoint_dir=args.checkpoint_dir,
        save_every=args.save_every,
        model_axis=args.model_axis,
        seed=args.seed,
        scale=args.scale,
        features=args.features,
        depth=args.depth,
    )
    summary = train(paths, settings, log=print, device=args.device)
    host = ", ".join(f"{hop} {seconds:.3f}"
                     for hop, seconds in summary["host_s"].items())
    print(
        f"trained to step {summary['final_step']} "
        f"(loss {summary['final_loss']:.6f}, batch {summary['batch']}, "
        f"devices {summary['devices']}; host s: {host})"
    )
    return 0


def _magnet(args) -> int:
    from .torrent.magnet import make_magnet
    from .torrent.metainfo import parse_torrent_bytes

    with open(args.torrent, "rb") as fh:
        meta = parse_torrent_bytes(fh.read())
    print(make_magnet(meta.info_hash, meta.name, meta.trackers))
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "submit":
        return asyncio.run(_submit(args))
    if args.command == "mktorrent":
        return _mktorrent(args)
    if args.command == "magnet":
        return _magnet(args)
    if args.command == "scrape":
        return asyncio.run(_scrape(args))
    if args.command == "status":
        return asyncio.run(_status(args))
    if args.command == "jobs":
        return asyncio.run(_jobs(args))
    if args.command == "fleet":
        return asyncio.run(_fleet(args))
    if args.command == "trace":
        return asyncio.run(_trace(args))
    if args.command == "tenants":
        return asyncio.run(_tenants(args))
    if args.command == "incident":
        return asyncio.run(_incident(args))
    if args.command == "debug":
        return asyncio.run(_debug(args))
    if args.command == "scrub":
        return asyncio.run(_scrub(args))
    if args.command == "watch":
        return asyncio.run(_watch(args))
    if args.command == "upscale":
        return _upscale(args)
    if args.command == "train":
        return _train(args)
    raise AssertionError("unreachable")


if __name__ == "__main__":
    sys.exit(main())
