"""Asyncio AMQP 0-9-1 client implementing the :class:`MessageQueue` surface.

Capability-equivalent to the reference's ``triton-core/amqp`` stack:
amqplib for the protocol plus amqp-connection-manager for automatic
reconnect/resubscribe (upstream yarn.lock:3574-3575), constructed and
connected at upstream lib/main.js:46-47 and consumed via
``listen``/``publish``/``close`` with per-delivery ``ack``/``nack``
(upstream lib/main.js:145-150,164,168,172,200).

Pure stdlib asyncio — no external AMQP dependency.  Framing lives in
:mod:`downloader_tpu_torch.mq.wire`; this module owns the connection state
machine:

- PLAIN-auth handshake, tune negotiation, heartbeats both directions
- one data channel (the pipeline's whole surface is two queues)
- durable queue declaration on first use, broker-side prefetch via
  ``basic.qos``
- consume/deliver with at-least-once settlement; a crashed handler nacks
  for redelivery, mirroring the in-memory broker's contract
- automatic reconnect with exponential backoff and consumer re-subscribe;
  settlements for deliveries from a dead connection are dropped so the
  broker's redelivery provides the at-least-once guarantee
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, List, Optional, Set, Tuple
from urllib.parse import unquote, urlparse

from . import wire
from .base import Delivery, Handler, MessageQueue

DEFAULT_PORT = 5672
DEFAULT_TLS_PORT = 5671
DEFAULT_FRAME_MAX = 131072
RPC_TIMEOUT = 30.0


class AccessRefused(ConnectionError):
    """The broker refused the handshake (bad credentials / vhost).

    Permanent: retrying with the same parameters cannot succeed, so the
    connect retry loop re-raises instead of backing off.
    """


def parse_amqp_url(url: str) -> Dict[str, Any]:
    """Parse ``amqp(s)://user:pass@host:port/vhost`` with RabbitMQ
    defaults (5672 plain, 5671 TLS)."""
    parsed = urlparse(url if "//" in url else f"amqp://{url}")
    if parsed.scheme not in ("amqp", "amqps", ""):
        raise ValueError(f"unsupported scheme {parsed.scheme!r}")
    tls = parsed.scheme == "amqps"
    vhost = unquote(parsed.path[1:]) if len(parsed.path) > 1 else "/"
    return {
        "host": parsed.hostname or "localhost",
        "port": parsed.port or (DEFAULT_TLS_PORT if tls else DEFAULT_PORT),
        "user": unquote(parsed.username) if parsed.username else "guest",
        "password": unquote(parsed.password) if parsed.password else "guest",
        "vhost": vhost,
        "tls": tls,
    }


class _Subscription:
    __slots__ = ("queue", "handler", "prefetch", "consumer_tag")

    def __init__(self, queue: str, handler: Handler, prefetch: int, tag: str):
        self.queue = queue
        self.handler = handler
        self.prefetch = prefetch
        self.consumer_tag = tag


class _PendingPublish:
    """A publish awaiting broker confirmation (confirm mode).

    Kept until the broker acks it; resent on a fresh connection if the old
    one died first — the amqp-connection-manager behavior the reference
    relies on for publish reliability.
    """

    __slots__ = ("queue", "body", "fut", "exchange", "headers")

    def __init__(self, queue: str, body: bytes, fut: asyncio.Future,
                 exchange: str = "", headers: Optional[dict] = None):
        self.queue = queue          # routing key when exchange is ""
        self.body = body
        self.fut = fut
        self.exchange = exchange    # fanout exchange name, "" = default
        self.headers = headers      # application headers (traceparent)


class _AmqpDelivery(Delivery):
    __slots__ = ("_client", "_tag", "_epoch", "_body", "_redelivered",
                 "_settled", "_headers")

    def __init__(self, client: "AmqpQueue", tag: int, epoch: int,
                 body: bytes, redelivered: bool,
                 headers: Optional[dict] = None):
        self._client = client
        self._tag = tag
        self._epoch = epoch
        self._body = body
        self._redelivered = redelivered
        self._settled = False
        self._headers = headers or {}

    @property
    def body(self) -> bytes:
        return self._body

    @property
    def redelivered(self) -> bool:
        return self._redelivered

    @property
    def headers(self) -> dict:
        return self._headers

    async def ack(self) -> None:
        if self._settled:
            return
        self._settled = True
        await self._client._settle(self._tag, self._epoch, ack=True)

    async def nack(self, requeue: bool = True) -> None:
        if self._settled:
            return
        self._settled = True
        await self._client._settle(self._tag, self._epoch, ack=False, requeue=requeue)


class AmqpQueue(MessageQueue):
    """A resilient connection to an AMQP 0-9-1 broker (e.g. RabbitMQ)."""

    CHANNEL = 1

    def __init__(
        self,
        url: str,
        heartbeat: int = 30,
        reconnect_initial: float = 0.1,
        reconnect_max: float = 5.0,
        connect_attempts: Optional[int] = None,
        logger=None,
        ssl_context=None,
    ):
        """``amqps://`` URLs negotiate TLS (default port 5671) using
        ``ssl_context`` or a default verifying context."""
        self._params = parse_amqp_url(url)
        self._ssl_context = ssl_context
        self._want_heartbeat = heartbeat
        self._reconnect_initial = reconnect_initial
        self._reconnect_max = reconnect_max
        # None = retry the initial connect forever (the reference's
        # amqp-connection-manager behavior: a worker booting before its
        # broker waits for it rather than crash-looping)
        self._connect_attempts = connect_attempts
        self._logger = logger

        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._frame_max = DEFAULT_FRAME_MAX
        self._heartbeat = heartbeat
        self._epoch = 0  # bumped per (re)connect; stale settlements are dropped
        self._connected = asyncio.Event()
        self._closing = False

        self._read_task: Optional[asyncio.Task] = None
        self._heartbeat_task: Optional[asyncio.Task] = None
        self._reconnect_task: Optional[asyncio.Task] = None
        self._last_recv = 0.0

        self._rpc_lock = asyncio.Lock()
        self._send_lock = asyncio.Lock()
        self._pending_rpc: Optional[Tuple[Tuple[int, int], asyncio.Future]] = None

        self._declared: Set[str] = set()
        self._declared_exchanges: Set[str] = set()
        # (queue, exchange, exclusive) bindings, replayed on reconnect
        self._bindings: List[Tuple[str, str, bool]] = []
        self._subscriptions: Dict[str, _Subscription] = {}  # by consumer tag
        self._consuming = True
        self._next_tag = 0
        self._handlers: Set[asyncio.Task] = set()

        # publisher-confirm state: seq -> entry for the live connection,
        # plus the ordered set of entries not yet confirmed by any broker
        self._publish_seq = 0
        self._unconfirmed: Dict[int, _PendingPublish] = {}
        self._pending_publishes: Dict[_PendingPublish, None] = {}

        # in-flight content assembly (consumer_tag, delivery_tag, redelivered)
        self._pending_deliver: Optional[Tuple[str, int, bool]] = None
        self._pending_size = 0
        self._pending_chunks: List[bytes] = []
        self._pending_props: Optional[dict] = None

    # -- connection lifecycle -------------------------------------------

    async def connect(self) -> None:
        if self._connected.is_set() and not self._closing:
            # idempotent: a second connect() (e.g. Telemetry.connect after
            # the caller already connected the queue) must not stack a new
            # connection over the live one
            return
        delay = self._reconnect_initial
        attempt = 0
        while True:
            try:
                await self._establish()
                return
            except AccessRefused:
                raise
            except (ConnectionError, OSError, wire.ProtocolError,
                    asyncio.IncompleteReadError) as err:
                attempt += 1
                if (self._connect_attempts is not None
                        and attempt >= self._connect_attempts):
                    raise
                if self._logger is not None:
                    self._logger.warn(
                        "amqp connect failed, retrying", error=repr(err),
                        attempt=attempt)
                await asyncio.sleep(delay)
                delay = min(delay * 2, self._reconnect_max)

    async def _establish(self) -> None:
        p = self._params
        ssl_ctx = None
        if p.get("tls"):
            import ssl as ssl_mod

            ssl_ctx = self._ssl_context or ssl_mod.create_default_context()
        reader, writer = await asyncio.open_connection(
            p["host"], p["port"], ssl=ssl_ctx
        )
        try:
            await self._handshake(reader, writer)
        except BaseException:
            writer.close()
            raise
        self._reader, self._writer = reader, writer
        self._epoch += 1
        self._declared.clear()
        self._declared_exchanges.clear()
        self._publish_seq = 0
        self._unconfirmed.clear()
        self._last_recv = time.monotonic()
        self._read_task = asyncio.create_task(self._read_loop())
        if self._heartbeat:
            self._heartbeat_task = asyncio.create_task(self._heartbeat_loop())
        self._connected.set()
        # re-establish exchange bindings (exclusive tap queues died with
        # the old connection and must be re-created before re-binding)
        for queue, exchange, exclusive in list(self._bindings):
            await self._ensure_exchange(exchange)
            await self._ensure_queue(queue, exclusive=exclusive)
            await self._send_bind(queue, exchange)
        # restore consumers on a fresh connection
        if self._consuming:
            for sub in list(self._subscriptions.values()):
                await self._start_consumer(sub)
        # resend publishes the dead connection never confirmed
        for entry in list(self._pending_publishes):
            if not entry.fut.done():
                await self._send_publish(entry)

    async def _handshake(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        p = self._params
        writer.write(wire.PROTOCOL_HEADER)
        await writer.drain()

        async def expect(method: Tuple[int, int]) -> List[Any]:
            while True:
                ftype, _channel, payload = await wire.read_frame(reader)
                if ftype == wire.FRAME_HEARTBEAT:
                    continue
                if ftype != wire.FRAME_METHOD:
                    raise wire.ProtocolError(f"expected method frame, got {ftype}")
                got, args = wire.decode_method(payload)
                if got == wire.CONNECTION_CLOSE:
                    # close during handshake = refusal (403/530): permanent
                    raise AccessRefused(
                        f"server closed connection: {args[0]} {args[1]}")
                if got != method:
                    raise wire.ProtocolError(f"expected {method}, got {got}")
                return args

        await expect(wire.CONNECTION_START)
        client_props = {
            "product": "downloader-tpu",
            "capabilities": {"basic.nack": True, "consumer_cancel_notify": True},
        }
        response = f"\0{p['user']}\0{p['password']}"
        writer.write(wire.encode_method(
            0, wire.CONNECTION_START_OK, client_props, "PLAIN", response, "en_US"))
        await writer.drain()

        _ch_max, frame_max, hb = await expect(wire.CONNECTION_TUNE)
        self._frame_max = min(frame_max or DEFAULT_FRAME_MAX, DEFAULT_FRAME_MAX)
        # 0 from either side disables heartbeats (RabbitMQ negotiation rule)
        if hb and self._want_heartbeat:
            self._heartbeat = min(hb, self._want_heartbeat)
        else:
            self._heartbeat = 0
        writer.write(wire.encode_method(
            0, wire.CONNECTION_TUNE_OK, 1, self._frame_max, self._heartbeat))
        writer.write(wire.encode_method(
            0, wire.CONNECTION_OPEN, p["vhost"], "", False))
        await writer.drain()
        await expect(wire.CONNECTION_OPEN_OK)

        writer.write(wire.encode_method(self.CHANNEL, wire.CHANNEL_OPEN, ""))
        await writer.drain()
        await expect(wire.CHANNEL_OPEN_OK)

        # confirm mode: the broker acks every publish, so lost connections
        # can't silently drop messages (we resend unconfirmed ones)
        writer.write(wire.encode_method(self.CHANNEL, wire.CONFIRM_SELECT, False))
        await writer.drain()
        await expect(wire.CONFIRM_SELECT_OK)

    def _connection_lost(self, exc: Optional[BaseException]) -> None:
        if not self._connected.is_set() and self._reconnect_task:
            return
        self._connected.clear()
        if self._writer is not None:
            self._writer.close()
        if self._heartbeat_task:
            self._heartbeat_task.cancel()
            self._heartbeat_task = None
        if self._pending_rpc is not None:
            _method, fut = self._pending_rpc
            if not fut.done():
                fut.set_exception(exc or ConnectionError("connection lost"))
            self._pending_rpc = None
        self._pending_deliver = None
        self._pending_chunks = []
        self._pending_props = None
        # stale per-connection confirm tags; the entries themselves stay in
        # _pending_publishes and are resent once reconnected
        self._unconfirmed.clear()
        if not self._closing and self._reconnect_task is None:
            if self._logger is not None:
                self._logger.warn("amqp connection lost, reconnecting",
                                  error=repr(exc) if exc else None)
            self._reconnect_task = asyncio.create_task(self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        delay = self._reconnect_initial
        while not self._closing:
            try:
                await self._establish()
            except asyncio.CancelledError:
                raise
            except Exception as err:
                if self._logger is not None:
                    self._logger.warn("amqp reconnect failed", error=repr(err))
                await asyncio.sleep(delay)
                delay = min(delay * 2, self._reconnect_max)
            else:
                self._reconnect_task = None
                return

    async def stop_consuming(self) -> None:
        self._consuming = False
        if not self._connected.is_set():
            return
        for sub in list(self._subscriptions.values()):
            try:
                await self._rpc(
                    wire.encode_method(
                        self.CHANNEL, wire.BASIC_CANCEL, sub.consumer_tag, False),
                    wire.BASIC_CANCEL_OK,
                )
            except (ConnectionError, OSError):
                # connection is gone: nothing is being consumed, and
                # _consuming=False keeps the reconnect loop from
                # restoring the subscriptions
                break
            # wire.ProtocolError / TimeoutError propagate: the consumer
            # may still be live on a healthy connection, and a caller
            # (intake pause / drain) must not report intake stopped when
            # it wasn't — a retry re-issues the cancels idempotently

    async def resume_consuming(self) -> None:
        """Re-issue basic.consume for every registered subscription
        (control-plane intake resume after :meth:`stop_consuming`).

        The subscriptions table survives the pause, so the same queues /
        handlers / qos come back; while disconnected, flipping
        ``_consuming`` is enough — the reconnect loop restores consumers
        on the next connection.

        Deliberately RE-ENTRANT: each subscription is basic.cancel'd
        (a no-op for a tag the broker doesn't know) before its consume,
        so a resume that half-failed on a slow broker can simply be
        retried — without this, a first attempt dying between the
        ``_consuming`` flip and the consume would make every retry a
        silent no-op and leave intake dead until the next reconnect.
        """
        if self._closing:
            raise RuntimeError("resume on closed queue connection")
        self._consuming = True
        if not self._connected.is_set():
            return  # reconnect loop restores consumers on connect
        for sub in list(self._subscriptions.values()):
            try:
                await self._rpc(
                    wire.encode_method(
                        self.CHANNEL, wire.BASIC_CANCEL,
                        sub.consumer_tag, False),
                    wire.BASIC_CANCEL_OK,
                )
                await self._start_consumer(sub)
            except (ConnectionError, OSError):
                return  # connection died: reconnect restores everything
            # wire.ProtocolError / TimeoutError propagate: the caller's
            # retry re-runs the cancel+consume pair idempotently

    async def close(self) -> None:
        self._closing = True
        if self._reconnect_task:
            self._reconnect_task.cancel()
            try:
                await self._reconnect_task
            except (asyncio.CancelledError, Exception):
                pass
            self._reconnect_task = None
        for task in list(self._handlers):
            task.cancel()
        for task in list(self._handlers):
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._handlers.clear()
        if self._connected.is_set() and self._writer is not None:
            try:
                await self._rpc(
                    wire.encode_method(
                        0, wire.CONNECTION_CLOSE, 200, "bye", 0, 0),
                    wire.CONNECTION_CLOSE_OK,
                    timeout=2.0,
                )
            except (ConnectionError, wire.ProtocolError, asyncio.TimeoutError):
                pass
        self._connected.clear()
        for entry in list(self._pending_publishes):
            if not entry.fut.done():
                entry.fut.set_exception(
                    ConnectionError("connection closed before publish confirm"))
        self._pending_publishes.clear()
        self._unconfirmed.clear()
        for task in (self._read_task, self._heartbeat_task):
            if task:
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass
        self._read_task = self._heartbeat_task = None
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._reader = self._writer = None

    # -- read loop & dispatch -------------------------------------------

    async def _read_loop(self) -> None:
        try:
            while True:
                ftype, channel, payload = await wire.read_frame(self._reader)
                self._last_recv = time.monotonic()
                if ftype == wire.FRAME_HEARTBEAT:
                    continue
                if ftype == wire.FRAME_METHOD:
                    self._on_method(channel, payload)
                elif ftype == wire.FRAME_HEADER:
                    _size, _props = wire.decode_content_header(payload)
                    self._pending_size = _size
                    self._pending_props = _props
                    self._pending_chunks = []
                    if _size == 0:
                        self._dispatch_delivery()
                elif ftype == wire.FRAME_BODY:
                    self._pending_chunks.append(payload)
                    if sum(map(len, self._pending_chunks)) >= self._pending_size:
                        self._dispatch_delivery()
        except asyncio.CancelledError:
            raise
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                wire.ProtocolError) as err:
            self._connection_lost(err)

    def _on_method(self, channel: int, payload: bytes) -> None:
        method, args = wire.decode_method(payload)
        if method == wire.BASIC_DELIVER:
            consumer_tag, delivery_tag, redelivered, _exchange, _rk = args
            self._pending_deliver = (consumer_tag, delivery_tag, redelivered)
            return
        if method == wire.BASIC_ACK:
            self._confirm(args[0], args[1], ok=True)
            return
        if method == wire.BASIC_NACK:
            self._confirm(args[0], args[1], ok=False)
            return
        if method in (wire.CONNECTION_CLOSE, wire.CHANNEL_CLOSE):
            # server-initiated close: acknowledge, then treat as lost
            reply = (wire.CONNECTION_CLOSE_OK if method == wire.CONNECTION_CLOSE
                     else wire.CHANNEL_CLOSE_OK)
            if self._writer is not None:
                self._writer.write(wire.encode_method(channel, reply))
            raise ConnectionError(f"server closed: {args[1]!r}")
        if self._pending_rpc is not None and method == self._pending_rpc[0]:
            _method, fut = self._pending_rpc
            self._pending_rpc = None
            if not fut.done():
                fut.set_result(args)
            return
        # unsolicited but harmless (e.g. basic.cancel-ok after a race)

    def _dispatch_delivery(self) -> None:
        if self._pending_deliver is None:
            self._pending_chunks = []
            return
        consumer_tag, delivery_tag, redelivered = self._pending_deliver
        body = b"".join(self._pending_chunks)
        props = self._pending_props or {}
        self._pending_deliver = None
        self._pending_chunks = []
        self._pending_props = None
        sub = self._subscriptions.get(consumer_tag)
        if sub is None:
            # delivery for a cancelled consumer: requeue it
            asyncio.ensure_future(
                self._settle(delivery_tag, self._epoch, ack=False, requeue=True))
            return
        delivery = _AmqpDelivery(self, delivery_tag, self._epoch, body,
                                 redelivered, headers=props.get("headers"))

        async def _run() -> None:
            try:
                await sub.handler(delivery)
            except asyncio.CancelledError:
                await delivery.nack(requeue=True)
                raise
            except Exception:
                # crashed handler: redeliver, like a channel close would
                await delivery.nack(requeue=True)

        task = asyncio.create_task(_run())
        self._handlers.add(task)
        task.add_done_callback(self._handlers.discard)

    async def _heartbeat_loop(self) -> None:
        interval = max(self._heartbeat / 2.0, 0.01)
        frame = wire.encode_frame(wire.FRAME_HEARTBEAT, 0, b"")
        while True:
            await asyncio.sleep(interval)
            if time.monotonic() - self._last_recv > 2 * self._heartbeat:
                # peer went silent: drop the transport; the read loop's error
                # path owns reconnection
                if self._writer is not None:
                    self._writer.close()
                return
            try:
                self._writer.write(frame)
                await self._writer.drain()
            except (ConnectionError, OSError):
                return

    # -- RPC & sends -----------------------------------------------------

    async def _rpc(self, frame: bytes, expect: Tuple[int, int],
                   timeout: float = RPC_TIMEOUT) -> List[Any]:
        async with self._rpc_lock:
            if self._writer is None:
                raise ConnectionError("not connected")
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._pending_rpc = (expect, fut)
            self._writer.write(frame)
            await self._writer.drain()
            return await asyncio.wait_for(fut, timeout)

    async def _ensure_queue(self, queue: str, exclusive: bool = False) -> None:
        if queue in self._declared:
            return
        # exclusive queues (telemetry taps) are transient: not durable,
        # auto-deleted with the connection; work queues are durable
        await self._rpc(
            wire.encode_method(
                self.CHANNEL, wire.QUEUE_DECLARE,
                0, queue, False, not exclusive, exclusive, exclusive,
                False, None),
            wire.QUEUE_DECLARE_OK,
        )
        self._declared.add(queue)

    async def _ensure_exchange(self, exchange: str) -> None:
        if exchange in self._declared_exchanges:
            return
        await self._rpc(
            wire.encode_method(
                self.CHANNEL, wire.EXCHANGE_DECLARE,
                0, exchange, "fanout", False, True, False, False, False,
                None),
            wire.EXCHANGE_DECLARE_OK,
        )
        self._declared_exchanges.add(exchange)

    async def _send_bind(self, queue: str, exchange: str) -> None:
        await self._rpc(
            wire.encode_method(
                self.CHANNEL, wire.QUEUE_BIND,
                0, queue, exchange, "", False, None),
            wire.QUEUE_BIND_OK,
        )

    async def bind_queue(self, queue: str, exchange: str,
                         exclusive: bool = False) -> None:
        """Declare a fanout ``exchange`` and bind ``queue`` to it (declaring
        the queue too; ``exclusive`` makes it a transient per-connection tap
        queue).  Bindings are replayed after a reconnect."""
        if self._closing:
            raise RuntimeError("bind on closed queue connection")
        await self._connected.wait()
        await self._ensure_exchange(exchange)
        await self._ensure_queue(queue, exclusive=exclusive)
        await self._send_bind(queue, exchange)
        entry = (queue, exchange, exclusive)
        if entry not in self._bindings:
            self._bindings.append(entry)

    async def _settle(self, delivery_tag: int, epoch: int, ack: bool,
                      requeue: bool = True) -> None:
        if epoch != self._epoch or not self._connected.is_set():
            # the delivery's connection is gone; the broker already requeued
            # every unacked message on that channel
            return
        if ack:
            frame = wire.encode_method(
                self.CHANNEL, wire.BASIC_ACK, delivery_tag, False)
        else:
            frame = wire.encode_method(
                self.CHANNEL, wire.BASIC_NACK, delivery_tag, False, requeue)
        try:
            self._writer.write(frame)
            await self._writer.drain()
        except (ConnectionError, OSError):
            pass

    # -- MessageQueue surface -------------------------------------------

    def _confirm(self, delivery_tag: int, multiple: bool, ok: bool) -> None:
        """Resolve publisher-confirm futures for an incoming (n)ack."""
        tags = ([t for t in self._unconfirmed if t <= delivery_tag]
                if multiple else [delivery_tag])
        for tag in tags:
            entry = self._unconfirmed.pop(tag, None)
            if entry is None:
                continue
            self._pending_publishes.pop(entry, None)
            if entry.fut.done():
                continue
            if ok:
                entry.fut.set_result(None)
            else:
                entry.fut.set_exception(
                    ConnectionError("broker rejected publish (basic.nack)"))

    async def _send_publish(self, entry: _PendingPublish) -> None:
        if entry.exchange:
            await self._ensure_exchange(entry.exchange)
        else:
            await self._ensure_queue(entry.queue)
        props: dict = {"delivery_mode": 2}
        if entry.headers:
            props["headers"] = entry.headers
        frames = [
            wire.encode_method(
                self.CHANNEL, wire.BASIC_PUBLISH,
                0, entry.exchange, entry.queue, False, False),
            wire.encode_content_header(
                self.CHANNEL, len(entry.body), props),
        ]
        frames.extend(
            wire.encode_body_frames(self.CHANNEL, entry.body, self._frame_max))
        async with self._send_lock:
            self._publish_seq += 1
            self._unconfirmed[self._publish_seq] = entry
            self._writer.write(b"".join(frames))
            await self._writer.drain()

    async def _publish_entry(self, entry: _PendingPublish) -> None:
        if self._closing:
            raise RuntimeError("publish on closed queue connection")
        await self._connected.wait()
        self._pending_publishes[entry] = None
        try:
            await self._send_publish(entry)
        except (ConnectionError, OSError, EOFError):
            # connection died mid-send (possibly before the read loop
            # noticed): _establish resends everything unconfirmed, so just
            # fall through to waiting on the confirm.  Worst case is a
            # duplicate publish — at-least-once, like the broker's delivery.
            # EOFError covers asyncio.IncompleteReadError: a drop DURING a
            # declare/bind RPC surfaces through the rpc future as the read
            # loop's readexactly EOF, not as a ConnectionError — it used
            # to escape here and fail a publish a reconnect would repair.
            if self._closing:
                self._pending_publishes.pop(entry, None)
                raise
        except BaseException:
            # anything a reconnect can't repair (e.g. RPC timeout on a live
            # connection) must surface, not hang on a confirm that will
            # never arrive
            self._pending_publishes.pop(entry, None)
            raise
        await entry.fut

    async def publish(self, queue: str, body: bytes,
                      headers: Optional[dict] = None) -> None:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._publish_entry(
            _PendingPublish(queue, body, fut, headers=headers))

    async def publish_exchange(self, exchange: str, body: bytes,
                               headers: Optional[dict] = None) -> None:
        """Publish to a fanout exchange: every bound queue gets a copy."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._publish_entry(
            _PendingPublish("", body, fut, exchange=exchange,
                            headers=headers)
        )

    async def listen(self, queue: str, handler: Handler, prefetch: int = 1) -> None:
        if self._closing:
            raise RuntimeError("listen on closed queue connection")
        await self._connected.wait()
        self._next_tag += 1
        sub = _Subscription(queue, handler, prefetch, f"ctag-{self._next_tag}")
        self._subscriptions[sub.consumer_tag] = sub
        self._consuming = True
        try:
            await self._start_consumer(sub)
        except (ConnectionError, OSError, EOFError):
            # EOFError = IncompleteReadError from a drop mid-RPC, same
            # repairable case as the publish path
            if self._closing:
                raise
            # the subscription is registered: the reconnect loop will
            # re-issue declare/qos/consume on the next connection
        except BaseException:
            # a failure a reconnect won't repair: unregister and surface
            self._subscriptions.pop(sub.consumer_tag, None)
            raise

    async def _start_consumer(self, sub: _Subscription) -> None:
        await self._ensure_queue(sub.queue)
        await self._rpc(
            wire.encode_method(
                self.CHANNEL, wire.BASIC_QOS, 0, sub.prefetch, False),
            wire.BASIC_QOS_OK,
        )
        await self._rpc(
            wire.encode_method(
                self.CHANNEL, wire.BASIC_CONSUME,
                0, sub.queue, sub.consumer_tag, False, False, False, False, None),
            wire.BASIC_CONSUME_OK,
        )
