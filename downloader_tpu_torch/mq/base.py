"""Queue interface: the AMQP surface the pipeline actually uses.

Maps one-to-one onto the reference's ``triton-core/amqp`` usage:
``new AMQP(addr, 1, 2, prom); connect(); listen('v1.download', processor);
publish('v1.convert', encoded); close()``
(upstream lib/main.js:46-47,164,172,200) with ``rmsg.ack()`` /
``rmsg.nack()`` settlement (upstream lib/main.js:145-150,168).
Delivery is at-least-once: a nacked message is redelivered.
"""

from __future__ import annotations

import abc
from typing import Awaitable, Callable, Optional

Handler = Callable[["Delivery"], Awaitable[None]]


class Delivery(abc.ABC):
    """A single queue delivery awaiting settlement.

    The reference handler receives ``rmsg`` with ``rmsg.message.content``
    (bytes) and ``ack``/``nack`` methods (upstream lib/main.js:63,168).
    """

    __slots__ = ()

    @property
    @abc.abstractmethod
    def body(self) -> bytes:
        """Raw message payload."""

    @property
    @abc.abstractmethod
    def redelivered(self) -> bool:
        """True if this message was previously delivered and nacked."""

    @property
    def headers(self) -> dict:
        """Application headers published with the message (AMQP basic
        properties ``headers`` table).  The pipeline uses them to carry
        W3C trace context (``traceparent``) across queue hops — the
        cross-service propagation triton's design provides for
        (upstream lib/main.js:20 imports the tracer's serialize/
        unserialize) but the reference never wired up."""
        return {}

    @abc.abstractmethod
    async def ack(self) -> None:
        """Settle successfully; the broker drops the message."""

    @abc.abstractmethod
    async def nack(self, requeue: bool = True) -> None:
        """Settle unsuccessfully; with ``requeue`` the broker redelivers."""


class MessageQueue(abc.ABC):
    """A connection to a message broker."""

    @abc.abstractmethod
    async def connect(self) -> None:
        """Establish the connection (reference lib/main.js:47)."""

    @abc.abstractmethod
    async def close(self) -> None:
        """Tear down the connection and cancel consumers
        (reference lib/main.js:200)."""

    @abc.abstractmethod
    async def stop_consuming(self) -> None:
        """Stop pulling new deliveries but let in-flight handlers finish.

        Used by graceful shutdown: drain-then-close instead of cancelling
        handlers mid-stage."""

    async def resume_consuming(self) -> None:
        """Re-start the consumers registered via :meth:`listen` after a
        :meth:`stop_consuming` (control-plane intake pause/resume).

        Optional capability: the bundled backends implement it; the
        default raises so a backend that silently dropped subscriptions
        can't fake a resume."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support resuming consumers"
        )

    @abc.abstractmethod
    async def publish(self, queue: str, body: bytes,
                      headers: Optional[dict] = None) -> None:
        """Enqueue ``body`` onto ``queue`` (reference lib/main.js:164),
        optionally with application headers (e.g. ``traceparent``)."""

    @abc.abstractmethod
    async def listen(self, queue: str, handler: Handler, prefetch: int = 1) -> None:
        """Consume ``queue``, invoking ``handler`` per delivery.

        ``prefetch`` bounds in-flight unsettled deliveries per consumer
        (the reference passes prefetch params ``(1, 2)`` to its AMQP
        constructor, lib/main.js:46).
        """

    # -- fanout (optional capability) -----------------------------------
    # Work queues split deliveries among consumers; telemetry wants every
    # interested party to see every event.  Backends that support it
    # expose fanout exchanges: publish_exchange copies to all bound
    # queues; bind_queue attaches a (possibly exclusive/transient) queue.

    async def publish_exchange(self, exchange: str, body: bytes,
                               headers: Optional[dict] = None) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support fanout exchanges"
        )

    async def bind_queue(self, queue: str, exchange: str,
                         exclusive: bool = False) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support fanout exchanges"
        )
