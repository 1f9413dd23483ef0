"""Hermetic in-process broker with at-least-once delivery semantics.

Stands in for RabbitMQ so the orchestrator and stages are testable without a
network broker (SURVEY.md §4 calls this out as the reference's biggest gap).
Semantics model the slice of AMQP the pipeline relies on:

- named FIFO queues, created on first use
- consumer prefetch (bounded unsettled deliveries per consumer)
- ``nack(requeue=True)`` redelivers with ``redelivered=True``
- unsettled deliveries from a crashed handler are redelivered
"""

from __future__ import annotations

import asyncio
import collections
from typing import Deque, Dict, List, Optional, Set, Tuple

from .base import Delivery, Handler, MessageQueue


class _Message:
    __slots__ = ("body", "redelivered", "deliveries", "headers")

    def __init__(self, body: bytes, headers: Optional[dict] = None):
        self.body = body
        self.redelivered = False
        self.deliveries = 0
        # copy: fanout shares the caller's dict across messages, and a
        # consumer mutating its delivery's headers must not bleed into
        # siblings/redeliveries (the AMQP backend isolates via the wire
        # codec; match it — review r5)
        self.headers = dict(headers) if headers else {}


class _MemoryDelivery(Delivery):
    __slots__ = ("_msg", "_broker", "_queue", "_settled", "_sem", "_headers")

    def __init__(self, msg: _Message, broker: "InMemoryBroker", queue: str,
                 sem: asyncio.Semaphore):
        self._msg = msg
        self._broker = broker
        self._queue = queue
        self._settled = False
        self._sem = sem
        # per-DELIVERY copy: the AMQP backend re-decodes headers from the
        # wire for every delivery, so a handler mutating its delivery's
        # headers must see a fresh dict again on redelivery (advisor r5)
        self._headers = dict(msg.headers)

    @property
    def body(self) -> bytes:
        return self._msg.body

    @property
    def redelivered(self) -> bool:
        return self._msg.redelivered

    @property
    def headers(self) -> dict:
        return self._headers

    def _settle(self) -> bool:
        if self._settled:
            return False
        self._settled = True
        self._sem.release()
        return True

    async def ack(self) -> None:
        if self._settle():
            self._broker._settled(self._queue)

    async def nack(self, requeue: bool = True) -> None:
        if self._settle():
            if requeue:
                self._msg.redelivered = True
                self._broker._requeue(self._queue, self._msg)
            self._broker._settled(self._queue)


class InMemoryBroker:
    """Shared broker state; one per test/process.

    ``max_redeliveries`` (optional) caps redelivery of a single message so a
    poison message cannot spin a test forever; ``None`` means redeliver
    forever, like a RabbitMQ queue without a dead-letter policy.
    """

    def __init__(self, max_redeliveries: Optional[int] = None):
        self._queues: Dict[str, Deque[_Message]] = collections.defaultdict(collections.deque)
        self._events: Dict[str, asyncio.Event] = {}
        self._published: Dict[str, List[bytes]] = collections.defaultdict(list)
        self._unsettled: Dict[str, int] = collections.defaultdict(int)
        self.max_redeliveries = max_redeliveries
        self.dropped: List[Tuple[str, bytes]] = []
        # fanout exchanges: name -> bound queue names (ordered, deduped)
        self._exchanges: Dict[str, Dict[str, None]] = collections.defaultdict(dict)

    # -- introspection helpers for tests --------------------------------
    def published(self, queue: str) -> List[bytes]:
        """All bodies ever published to ``queue`` (including consumed ones)."""
        return list(self._published[queue])

    def depth(self, queue: str) -> int:
        """Messages currently waiting in ``queue``."""
        return len(self._queues[queue])

    def idle(self, queue: str) -> bool:
        """True when ``queue`` has no waiting or unsettled messages."""
        return not self._queues[queue] and self._unsettled[queue] == 0

    async def join(self, queue: str, timeout: float = 10.0) -> None:
        """Wait until ``queue`` is fully drained and settled."""
        async with asyncio.timeout(timeout):
            while not self.idle(queue):
                await asyncio.sleep(0.005)

    # -- broker internals ----------------------------------------------
    def _event(self, queue: str) -> asyncio.Event:
        if queue not in self._events:
            self._events[queue] = asyncio.Event()
        return self._events[queue]

    def _push(self, queue: str, msg: _Message, front: bool = False) -> None:
        if front:
            self._queues[queue].appendleft(msg)
        else:
            self._queues[queue].append(msg)
        self._event(queue).set()

    def _requeue(self, queue: str, msg: _Message) -> None:
        if self.max_redeliveries is not None and msg.deliveries > self.max_redeliveries:
            self.dropped.append((queue, msg.body))
            return
        self._push(queue, msg, front=True)

    def _settled(self, queue: str) -> None:
        self._unsettled[queue] -= 1

    def publish(self, queue: str, body: bytes,
                headers: Optional[dict] = None) -> None:
        self._published[queue].append(body)
        self._push(queue, _Message(body, headers))

    def bind(self, queue: str, exchange: str) -> None:
        self._exchanges[exchange][queue] = None

    def publish_exchange(self, exchange: str, body: bytes,
                         headers: Optional[dict] = None) -> None:
        """Fanout: every bound queue gets its own copy."""
        for queue in self._exchanges[exchange]:
            self.publish(queue, body, headers)

    async def pop(self, queue: str) -> _Message:
        q = self._queues[queue]
        event = self._event(queue)
        while not q:
            event.clear()
            await event.wait()
        msg = q.popleft()
        msg.deliveries += 1
        self._unsettled[queue] += 1
        return msg


class MemoryQueue(MessageQueue):
    """A connection to an :class:`InMemoryBroker`."""

    def __init__(self, broker: InMemoryBroker):
        self._broker = broker
        self._consume_loops: Set[asyncio.Task] = set()
        self._handlers: Set[asyncio.Task] = set()
        # subscriptions survive stop_consuming so resume_consuming can
        # re-spawn them (control-plane intake pause/resume); the shared
        # semaphore keeps unsettled deliveries counted across the pause
        self._subscriptions: list = []
        self._connected = False

    async def connect(self) -> None:
        self._connected = True

    async def stop_consuming(self) -> None:
        for task in self._consume_loops:
            task.cancel()
        for task in list(self._consume_loops):
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._consume_loops.clear()

    async def resume_consuming(self) -> None:
        if not self._connected:
            raise RuntimeError("resume on closed queue connection")
        if self._consume_loops:
            return  # already consuming
        for sub in self._subscriptions:
            self._spawn_consumer(*sub)

    async def close(self) -> None:
        self._connected = False
        await self.stop_consuming()
        for task in self._handlers:
            task.cancel()
        for task in list(self._handlers):
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._handlers.clear()

    async def publish(self, queue: str, body: bytes,
                      headers: Optional[dict] = None) -> None:
        if not self._connected:
            raise RuntimeError("publish on closed queue connection")
        self._broker.publish(queue, body, headers)

    async def publish_exchange(self, exchange: str, body: bytes,
                               headers: Optional[dict] = None) -> None:
        if not self._connected:
            raise RuntimeError("publish on closed queue connection")
        self._broker.publish_exchange(exchange, body, headers)

    async def bind_queue(self, queue: str, exchange: str,
                         exclusive: bool = False) -> None:
        if not self._connected:
            raise RuntimeError("bind on closed queue connection")
        self._broker.bind(queue, exchange)

    async def listen(self, queue: str, handler: Handler, prefetch: int = 1) -> None:
        if not self._connected:
            raise RuntimeError("listen on closed queue connection")
        sem = asyncio.Semaphore(prefetch)
        self._subscriptions.append((queue, handler, sem))
        self._spawn_consumer(queue, handler, sem)

    def _spawn_consumer(self, queue: str, handler: Handler,
                        sem: asyncio.Semaphore) -> None:
        async def _consume() -> None:
            while True:
                await sem.acquire()
                try:
                    msg = await self._broker.pop(queue)
                except asyncio.CancelledError:
                    # stop_consuming cancelled us while parked on an empty
                    # queue: give the permit back or every pause/resume
                    # cycle would shrink the effective prefetch by one
                    sem.release()
                    raise
                delivery = _MemoryDelivery(msg, self._broker, queue, sem)

                async def _run(d: _MemoryDelivery = delivery) -> None:
                    try:
                        await handler(d)
                    except asyncio.CancelledError:
                        # cancelled mid-handler (connection close): requeue so
                        # the at-least-once contract holds
                        await d.nack(requeue=True)
                        raise
                    except Exception:
                        # crashed handler: redeliver, like an AMQP channel
                        # close would
                        await d.nack(requeue=True)

                task = asyncio.create_task(_run())
                self._handlers.add(task)
                task.add_done_callback(self._handlers.discard)

        self._consume_loops.add(asyncio.create_task(_consume()))
