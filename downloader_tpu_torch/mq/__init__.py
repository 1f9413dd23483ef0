"""Message-queue abstraction.

The reference's "distributed communication backend" is RabbitMQ via
``triton-core/amqp`` (SURVEY.md §5).  This package defines the exact queue
surface the reference consumes — ``connect`` / ``listen`` / ``publish`` /
``close`` with per-message ``ack``/``nack`` and consumer prefetch
(upstream lib/main.js:46-47,145-150,164,172,200) — plus a hermetic
in-process broker so the whole pipeline is testable without a RabbitMQ
server (the reference's biggest test gap, SURVEY.md §4).
"""

from .base import Delivery, MessageQueue
from .memory import InMemoryBroker, MemoryQueue

__all__ = [
    "Delivery",
    "MessageQueue",
    "InMemoryBroker",
    "MemoryQueue",
    "new_queue",
    "resolve_backend",
]


def resolve_backend(config) -> str:
    """Resolve the configured queue backend name (``memory`` default)."""
    mq_cfg = config.get("rabbitmq") if config is not None else None
    if mq_cfg is None:
        return "memory"
    return mq_cfg.get("backend", "memory")


def new_queue(config, broker=None, logger=None) -> MessageQueue:
    """Build a broker connection from config.

    Capability-equivalent to ``new AMQP(dyn('rabbitmq'), 1, 2, prom)``
    (upstream lib/main.js:46): the backend is selected by
    ``config.rabbitmq.backend`` — ``memory`` (default, hermetic; pass a
    shared :class:`InMemoryBroker`) or ``amqp`` (a real AMQP 0-9-1
    connection to the address resolved by ``dyn('rabbitmq')``).

    The reference opens separate connections for jobs and telemetry
    (lib/main.js:46-50); call this once per connection.

    An explicitly injected ``broker`` always wins over config — tests and
    benchmarks that hand in a hermetic broker must never end up on real
    sockets because of ambient configuration.
    """
    if broker is not None:
        return MemoryQueue(broker)
    backend = resolve_backend(config)
    if backend == "memory":
        return MemoryQueue(InMemoryBroker())
    if backend == "amqp":
        from ..platform.config import dyn
        from .amqp import AmqpQueue

        return AmqpQueue(dyn("rabbitmq", config), logger=logger)
    raise ValueError(f"unknown queue backend {backend!r}")
