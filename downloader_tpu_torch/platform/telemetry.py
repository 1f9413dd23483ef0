"""Job telemetry: status + progress events published to the queue.

Capability-equivalent to ``triton-core/telemetry``: ``emitStatus(jobId, 2)``
(upstream lib/main.js:68) and
``emitProgress(id, DOWNLOADING, percent)``
(upstream lib/download.js:85,255,272, lib/upload.js:51), delivered
over RabbitMQ (lib/main.js:49-50).

Events are protobuf (``TelemetryStatusEvent`` / ``TelemetryProgressEvent``)
on the ``v1.telemetry.status`` / ``v1.telemetry.progress`` queues.  The
reference stores its telemetry client in ``global.telem`` (lib/main.js:52,
self-annotated ``// BAD``); here the client is passed explicitly to every
stage (SURVEY.md §7 step 6 lists that global as a bug to fix).
"""

from __future__ import annotations

from .. import schemas
from ..mq.base import MessageQueue

STATUS_QUEUE = "v1.telemetry.status"
PROGRESS_QUEUE = "v1.telemetry.progress"
# fanout exchanges feeding the canonical queues, so observers (cli watch)
# can bind their own tap queues without stealing the work-queue deliveries
STATUS_EXCHANGE = STATUS_QUEUE + ".fanout"
PROGRESS_EXCHANGE = PROGRESS_QUEUE + ".fanout"


class Telemetry:
    """Publishes job status/progress events.

    ``metrics`` is optional, mirroring how the reference passes its prom
    handle into Telemetry for internal counters (lib/main.js:49).

    Events go through fanout exchanges bound to the canonical queues when
    the backend supports exchanges (AMQP, memory broker): downstream
    consumers read the same queue names as before, and any number of
    observers can tap the stream with their own bound queues.  Backends
    without exchange support fall back to direct queue publishes.
    """

    def __init__(self, mq: MessageQueue, metrics=None):
        self._mq = mq
        self._metrics = metrics
        self._fanout = False

    async def connect(self) -> None:
        """(reference lib/main.js:50)"""
        await self._mq.connect()
        try:
            await self._mq.bind_queue(STATUS_QUEUE, STATUS_EXCHANGE)
            await self._mq.bind_queue(PROGRESS_QUEUE, PROGRESS_EXCHANGE)
            self._fanout = True
        except NotImplementedError:
            self._fanout = False

    async def close(self) -> None:
        """Tear down the telemetry connection (graceful shutdown)."""
        await self._mq.close()

    async def _publish(self, queue: str, exchange: str, body: bytes) -> None:
        if self._fanout:
            await self._mq.publish_exchange(exchange, body)
        else:
            await self._mq.publish(queue, body)
        if self._metrics is not None:
            self._metrics.messages_published.labels(queue=queue).inc()

    async def emit_status(self, media_id: str, status: int) -> None:
        event = schemas.TelemetryStatusEvent(media_id=media_id, status=status)
        await self._publish(STATUS_QUEUE, STATUS_EXCHANGE,
                            schemas.encode(event))

    async def emit_progress(self, media_id: str, status: int, percent: int) -> None:
        event = schemas.TelemetryProgressEvent(
            media_id=media_id, status=status, percent=int(percent)
        )
        await self._publish(PROGRESS_QUEUE, PROGRESS_EXCHANGE,
                            schemas.encode(event))


class NullTelemetry(Telemetry):
    """Telemetry sink that drops everything (hermetic stage tests)."""

    def __init__(self) -> None:  # noqa: D401
        super().__init__(mq=None)  # type: ignore[arg-type]

    async def close(self) -> None:
        pass

    async def connect(self) -> None:
        pass

    async def emit_status(self, media_id: str, status: int) -> None:
        pass

    async def emit_progress(self, media_id: str, status: int, percent: int) -> None:
        pass
