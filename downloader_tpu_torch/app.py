"""Service entrypoint & lifecycle.

Capability-equivalent to upstream index.js: load config
(index.js:18), build logger + tracer (index.js:12-15), start the
orchestrator (index.js:19), install signal/unhandled-error handlers that run
the termination handler and exit 0/1 (index.js:21-35).

Run with ``python -m downloader_tpu_torch``.
"""

from __future__ import annotations

import asyncio
import signal

from . import schemas  # noqa: F401  (ensures schemas import before serving)
from .health import start_server
from .mq import new_queue, resolve_backend
from .mq.memory import InMemoryBroker
from .orchestrator import Orchestrator
from .platform import metrics as prom
from .platform.config import cfg_get, load_config
from .platform.logging import get_logger
from .platform.telemetry import Telemetry
from .platform.tracing import init_tracer
from .store import new_client


def build_service(config=None, broker=None, store=None):
    """Wire the service graph; returns (orchestrator, metrics, telemetry).

    Factored out of :func:`main` so tests and benchmarks can assemble the
    exact production object graph against hermetic backends.
    """
    config = config or load_config("converter")
    logger = get_logger("downloader")
    tracer = init_tracer("downloader", logger, config)
    metrics = prom.new("downloader")
    # exporter health on /metrics: a down OTLP collector shows up as
    # climbing drop/error gauges instead of silently missing traces
    metrics.bind_tracer(tracer)

    # optional field-number reconciliation with a real triton-core
    # deployment (schemas/remap.py); bad tables fail here, at boot
    schemas.configure_remap(cfg_get(config, "wire_remap", None))

    # Queue backend per config: a real AMQP connection pair (one for jobs,
    # one for telemetry, like the reference's AMQP + Telemetry connections,
    # lib/main.js:46-50) or the hermetic in-process broker.  For the memory
    # backend, cap redeliveries so a deterministically-failing (poison) job
    # cannot hot-loop at the head of the queue and starve the worker;
    # RabbitMQ would need a dead-letter policy for the same guarantee.
    if broker is None and resolve_backend(config) == "memory":
        broker = InMemoryBroker(max_redeliveries=5)
    mq = new_queue(config, broker=broker, logger=logger)
    telem_mq = new_queue(config, broker=broker, logger=logger)
    telemetry = Telemetry(telem_mq, metrics)

    store = store if store is not None else new_client(config)

    # config-gated compute stage: insert ``upscale`` between process
    # and upload (the reference has no compute stage; its downstream
    # converter does the transform — see stages/upscale.py)
    from .stages.base import STAGES
    from .stages.upscale import upscale_enabled

    stages = list(STAGES)
    if upscale_enabled(config):
        stages.insert(stages.index("upload"), "upscale")
        logger.info("upscale stage enabled", stages=stages)

    orchestrator = Orchestrator(
        config=config,
        mq=mq,
        store=store,
        telemetry=telemetry,
        metrics=metrics,
        tracer=tracer,
        logger=logger,
        stages=stages,
    )
    return orchestrator, metrics, telemetry


async def run(config=None) -> None:
    logger = get_logger("downloader")
    orchestrator, metrics, _telemetry = build_service(config)

    await orchestrator.start()
    runner = await start_server(orchestrator, metrics)
    logger.info("initialized")

    stop = asyncio.Event()

    def _on_signal() -> None:
        logger.info("signal received, shutting down")
        stop.set()

    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, _on_signal)

    # SIGUSR1: dump every thread/task stack to the log — the "what is
    # this wedged worker doing" escape hatch when even the admin port
    # is unreachable (same payload as GET /debug/stacks)
    if hasattr(signal, "SIGUSR1"):
        def _on_dump() -> None:
            from .platform.obs import dump_stacks

            dump = dump_stacks()
            logger.warn("SIGUSR1 stack dump",
                        threads=dump["threads"], tasks=dump["tasks"])

        loop.add_signal_handler(signal.SIGUSR1, _on_dump)

    await stop.wait()
    await orchestrator.shutdown()
    await runner.cleanup()
    # flush any spans still queued for the OTLP collector
    await asyncio.to_thread(orchestrator.tracer.close)
    logger.info("shutdown complete")


def main() -> None:
    asyncio.run(run())


if __name__ == "__main__":
    main()
