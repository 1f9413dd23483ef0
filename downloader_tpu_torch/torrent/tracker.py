"""Tracker announce: HTTP (BEP 3) + compact peers (BEP 23) + UDP (BEP 15)
+ WebSocket (the webtorrent JSON protocol, ws/wss).

The reference's webtorrent client announces to http(s), udp AND
WebSocket trackers (upstream lib/download.js:9,19,64-66 via
bittorrent-tracker); ``announce()`` dispatches on the URL scheme so the
client treats them uniformly.  wss swarm peers are WebRTC-only, so the
ws announce contributes registration + stats, not dialable addresses
(PARITY.md "WebSocket trackers").
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import socket
import struct
import urllib.parse
from typing import List, Optional

import aiohttp
import yarl

from .bencode import bdecode


@dataclasses.dataclass(frozen=True)
class Peer:
    host: str
    port: int


class TrackerError(RuntimeError):
    pass


def _permanent(message: str) -> TrackerError:
    """A tracker rejection that repeats deterministically (bad scheme,
    explicit failure reason, 4xx): tagged so the retry layer
    (platform/errors.py classify) fails fast instead of burning its
    backoff budget re-sending the same request."""
    err = TrackerError(message)
    err.fault_class = "permanent"
    return err


_EVENT_CODES = {"none": 0, "completed": 1, "started": 2, "stopped": 3}


async def announce(
    tracker_url: str,
    info_hash: bytes,
    peer_id: bytes,
    port: int,
    uploaded: int = 0,
    downloaded: int = 0,
    left: int = 0,
    event: str = "started",
    session: aiohttp.ClientSession | None = None,
    udp_timeout: float = 5.0,
    udp_retries: int = 2,
) -> List[Peer]:
    """Announce to a tracker (http/https/udp) and return its peer list."""
    # fault-injection seam (platform/faults.py): tracker timeout storms
    # are a chaos-drill staple, and this hook makes them deterministic
    from ..platform import faults

    if faults.enabled():
        await faults.fire("tracker.announce", key=tracker_url)
    scheme = urllib.parse.urlsplit(tracker_url).scheme.lower()
    if scheme == "udp":
        return await announce_udp(
            tracker_url, info_hash, peer_id, port,
            uploaded=uploaded, downloaded=downloaded, left=left, event=event,
            timeout=udp_timeout, retries=udp_retries,
        )
    if scheme in ("http", "https"):
        return await announce_http(
            tracker_url, info_hash, peer_id, port,
            uploaded=uploaded, downloaded=downloaded, left=left, event=event,
            session=session,
        )
    if scheme in ("ws", "wss"):
        return await announce_ws(
            tracker_url, info_hash, peer_id, port,
            uploaded=uploaded, downloaded=downloaded, left=left, event=event,
            session=session,
        )
    raise _permanent(f"unsupported tracker scheme: {scheme!r}")


async def announce_with_retry(
    tracker_url: str,
    info_hash: bytes,
    peer_id: bytes,
    port: int,
    retries: int = 1,
    backoff: float = 0.2,
    **kwargs,
) -> List[Peer]:
    """:func:`announce` with bounded transient retries.

    A tracker blip (timeout, 5xx, connection reset) gets ``retries``
    further attempts with a doubling pause; failures the error taxonomy
    (platform/errors.py) calls permanent — bad scheme, a bencoded
    ``failure reason`` — re-raise immediately.  The torrent client runs
    this per tracker *concurrently*, so a retrying tracker never delays
    its healthy siblings.
    """
    from ..platform.errors import TRANSIENT, classify

    delay = backoff
    for attempt in range(retries + 1):
        try:
            return await announce(tracker_url, info_hash, peer_id, port,
                                  **kwargs)
        except Exception as err:
            if attempt >= retries or classify(err) != TRANSIENT:
                raise
            await asyncio.sleep(delay)
            delay *= 2
    raise AssertionError("unreachable: announce retry loop returns/raises")


async def announce_http(
    tracker_url: str,
    info_hash: bytes,
    peer_id: bytes,
    port: int,
    uploaded: int = 0,
    downloaded: int = 0,
    left: int = 0,
    event: str = "started",
    session: aiohttp.ClientSession | None = None,
) -> List[Peer]:
    """Announce to an HTTP tracker and return its peer list."""
    query = urllib.parse.urlencode(
        {
            "info_hash": info_hash,
            "peer_id": peer_id,
            "port": port,
            "uploaded": uploaded,
            "downloaded": downloaded,
            "left": left,
            "compact": 1,
            "event": event,
        },
        quote_via=urllib.parse.quote,
    )
    sep = "&" if "?" in tracker_url else "?"
    url = f"{tracker_url}{sep}{query}"

    owned = session is None
    session = session or aiohttp.ClientSession(trust_env=True)
    try:
        # pre-encoded: the percent-encoded binary info_hash must reach the
        # wire untouched (yarl would otherwise re-quote it)
        async with session.get(yarl.URL(url, encoded=True)) as resp:
            if resp.status != 200:
                # 5xx/408/429 are outage-shaped (retryable); other 4xx
                # repeat deterministically
                if resp.status >= 500 or resp.status in (408, 429):
                    raise TrackerError(f"tracker answered {resp.status}")
                raise _permanent(f"tracker answered {resp.status}")
            body = await resp.read()
    finally:
        if owned:
            await session.close()

    data = bdecode(body)
    if b"failure reason" in data:
        # the tracker ANSWERED and rejected the announce (bad infohash,
        # banned client): retrying re-sends the same request
        raise _permanent(
            data[b"failure reason"].decode("utf-8", "replace")
        )

    peers = data.get(b"peers", b"")
    out: List[Peer] = []
    if isinstance(peers, bytes):  # compact: 6 bytes per peer
        out.extend(parse_compact_peers(peers))
    else:  # non-compact dict form
        for entry in peers:
            out.append(
                Peer(entry[b"ip"].decode(), entry[b"port"])
            )
    # BEP 7: IPv6 peers arrive in a parallel compact list
    peers6 = data.get(b"peers6", b"")
    if isinstance(peers6, bytes):
        out.extend(parse_compact_peers6(peers6))
    return out


# -- WebSocket trackers (the webtorrent wss announce protocol) ----------
#
# The reference's engine also announces to ws:// and wss:// trackers
# (upstream lib/download.js:9,19 — webtorrent via
# bittorrent-tracker).  The wire protocol is JSON text frames over a
# WebSocket; 20-byte binary fields (info_hash, peer_id) travel as
# latin-1 strings ("binary" encoding in Node terms).  WSS trackers
# coordinate BROWSER peers: peer addresses are exchanged as WebRTC
# offers/answers signalled through the tracker, never as ip:port pairs,
# so a server-side announce yields swarm membership + stats but no
# dialable peers (ICE/DTLS/SCTP stays out of scope — PARITY.md
# "WebSocket trackers"; offer messages are counted and ignored).

_WS_TIMEOUT = 15.0


def _ws_binary(raw: bytes) -> str:
    return raw.decode("latin-1")


async def _ws_roundtrip(tracker_url: str, payload: dict, want_action: str,
                        session: aiohttp.ClientSession | None = None,
                        timeout: float = _WS_TIMEOUT,
                        ssl_ctx=None) -> dict:
    """One request/response over a fresh (or caller-shared) WebSocket:
    send ``payload``, return the first ``want_action`` reply for our
    info_hash, skipping interleaved offer/answer signalling traffic."""
    import json

    owned = session is None
    session = session or aiohttp.ClientSession(trust_env=True)
    try:
        async with asyncio.timeout(timeout):
            kwargs = {} if ssl_ctx is None else {"ssl": ssl_ctx}
            async with session.ws_connect(tracker_url, **kwargs) as ws:
                await ws.send_str(json.dumps(payload))
                async for msg in ws:
                    if msg.type != aiohttp.WSMsgType.TEXT:
                        continue
                    try:
                        reply = json.loads(msg.data)
                    except ValueError:
                        continue  # not ours; tolerate tracker chatter
                    if "failure reason" in reply:
                        raise _permanent(str(reply["failure reason"]))
                    if reply.get("action") != want_action:
                        continue
                    if "offer" in reply or "answer" in reply:
                        # WebRTC signalling fan-out ALSO uses action
                        # "announce" (bittorrent-tracker wire shape);
                        # we carry no ICE/DTLS stack — skip it
                        continue
                    ih = reply.get("info_hash")
                    if ih is not None and ih != payload.get("info_hash") \
                            and want_action != "scrape":
                        continue
                    return reply
        raise TrackerError("tracker closed the socket without answering")
    except aiohttp.ClientError as err:
        raise TrackerError(f"ws tracker failed: {err}") from err
    except TimeoutError as err:
        # a hung tracker is the failure mode operators actually hit;
        # str(TimeoutError()) is empty, so name it (review r5)
        raise TrackerError(
            f"ws tracker timed out after {timeout:.0f}s") from err
    finally:
        if owned:
            await session.close()


async def announce_ws(
    tracker_url: str,
    info_hash: bytes,
    peer_id: bytes,
    port: int,
    uploaded: int = 0,
    downloaded: int = 0,
    left: int = 0,
    event: str = "started",
    session: aiohttp.ClientSession | None = None,
    timeout: float = _WS_TIMEOUT,
    ssl_ctx=None,
) -> List[Peer]:
    """Announce to a ws/wss tracker (webtorrent protocol).

    Registers us in the swarm and returns an (always empty) peer list —
    wss swarm peers are WebRTC-only; ``scrape_ws`` exposes the stats the
    announce reply carries."""
    payload = {
        "action": "announce",
        "info_hash": _ws_binary(info_hash),
        "peer_id": _ws_binary(peer_id),
        "numwant": 0,  # no offers attached -> nothing to hand out
        "uploaded": uploaded,
        "downloaded": downloaded,
        "left": left,
        "event": event,
        "offers": [],
    }
    await _ws_roundtrip(tracker_url, payload, "announce",
                        session=session, timeout=timeout, ssl_ctx=ssl_ctx)
    return []  # wss peers are WebRTC-only; stats live in scrape_ws


async def scrape_ws(tracker_url: str, info_hash: bytes,
                    session: aiohttp.ClientSession | None = None,
                    timeout: float = _WS_TIMEOUT,
                    ssl_ctx=None) -> "ScrapeStats":
    """Scrape swarm stats over a ws/wss tracker."""
    payload = {"action": "scrape", "info_hash": _ws_binary(info_hash)}
    reply = await _ws_roundtrip(tracker_url, payload, "scrape",
                                session=session, timeout=timeout,
                                ssl_ctx=ssl_ctx)
    files = reply.get("files", {})
    stats = files.get(_ws_binary(info_hash))
    if stats is None:
        raise TrackerError("tracker scrape reply missing our info_hash")
    return ScrapeStats(
        seeders=int(stats.get("complete", 0)),
        completed=int(stats.get("downloaded", 0)),
        leechers=int(stats.get("incomplete", 0)),
    )


@dataclasses.dataclass(frozen=True)
class ScrapeStats:
    """Per-infohash swarm statistics from a tracker scrape."""
    seeders: int
    completed: int
    leechers: int


async def scrape(tracker_url: str, info_hash: bytes) -> ScrapeStats:
    """Scrape swarm stats for one infohash.

    HTTP trackers use the /announce -> /scrape URL convention; UDP
    trackers use BEP 15 action 2.  Raises TrackerError when the tracker
    does not support scraping.
    """
    scheme = urllib.parse.urlsplit(tracker_url).scheme.lower()
    if scheme == "udp":
        return await scrape_udp(tracker_url, info_hash)
    if scheme in ("ws", "wss"):
        return await scrape_ws(tracker_url, info_hash)
    return await scrape_http(tracker_url, info_hash)


def _scrape_url(tracker_url: str) -> str:
    """BEP 48 convention: the last path segment 'announce' -> 'scrape'."""
    parts = urllib.parse.urlsplit(tracker_url)
    head, sep, last = parts.path.rpartition("/")
    if not last.startswith("announce"):
        raise TrackerError(f"tracker does not support scrape: {tracker_url}")
    return urllib.parse.urlunsplit(parts._replace(
        path=head + sep + "scrape" + last[len("announce"):]
    ))


async def scrape_http(tracker_url: str, info_hash: bytes) -> ScrapeStats:
    query = urllib.parse.urlencode(
        {"info_hash": info_hash}, quote_via=urllib.parse.quote
    )
    url = _scrape_url(tracker_url)
    sep = "&" if "?" in url else "?"
    async with aiohttp.ClientSession(trust_env=True) as session:
        async with session.get(
            yarl.URL(f"{url}{sep}{query}", encoded=True)
        ) as resp:
            if resp.status != 200:
                raise TrackerError(f"scrape answered {resp.status}")
            body = await resp.read()
    data = bdecode(body)
    if b"failure reason" in data:
        raise TrackerError(data[b"failure reason"].decode("utf-8", "replace"))
    files = data.get(b"files", {})
    entry = files.get(info_hash)
    if not isinstance(entry, dict):
        raise TrackerError("scrape response missing our infohash")
    return ScrapeStats(
        seeders=int(entry.get(b"complete", 0)),
        completed=int(entry.get(b"downloaded", 0)),
        leechers=int(entry.get(b"incomplete", 0)),
    )


# ---------------------------------------------------------------------------
# UDP tracker protocol (BEP 15)
# ---------------------------------------------------------------------------

_UDP_MAGIC = 0x41727101980
_ACTION_CONNECT = 0
_ACTION_ANNOUNCE = 1
_ACTION_SCRAPE = 2
_ACTION_ERROR = 3


async def _udp_roundtrip(loop, transport, proto, payload_fn,
                         timeout: float, retries: int) -> bytes:
    """One retried request/response exchange against a UDP tracker."""
    last: Exception = TrackerError("udp tracker unreachable")
    for _ in range(max(1, retries + 1)):
        tid = random.getrandbits(32)
        fut: asyncio.Future = loop.create_future()
        proto.waiters[tid] = fut
        transport.sendto(payload_fn(tid))
        try:
            async with asyncio.timeout(timeout):
                return await fut
        except TimeoutError:
            proto.waiters.pop(tid, None)
            last = TrackerError(f"udp tracker timed out after {timeout}s")
        except TrackerError as err:
            last = err
    raise last


async def _udp_connect(loop, transport, proto, timeout, retries) -> int:
    """BEP 15 connect round trip -> connection id."""
    resp = await _udp_roundtrip(
        loop, transport, proto,
        lambda tid: struct.pack(">QII", _UDP_MAGIC, _ACTION_CONNECT, tid),
        timeout, retries,
    )
    (action,) = struct.unpack_from(">I", resp, 0)
    if action == _ACTION_ERROR:
        raise TrackerError(resp[8:].decode("utf-8", "replace"))
    if action != _ACTION_CONNECT or len(resp) < 16:
        raise TrackerError("malformed udp connect response")
    (connection_id,) = struct.unpack_from(">Q", resp, 8)
    return connection_id


async def scrape_udp(tracker_url: str, info_hash: bytes,
                     timeout: float = 5.0, retries: int = 2) -> ScrapeStats:
    """BEP 15 action-2 scrape for one infohash."""
    parts = urllib.parse.urlsplit(tracker_url)
    if parts.hostname is None or parts.port is None:
        raise _permanent(f"udp tracker needs host:port: {tracker_url}")
    loop = asyncio.get_running_loop()
    transport, proto = await loop.create_datagram_endpoint(
        _UdpTrackerProtocol, remote_addr=(parts.hostname, parts.port)
    )
    try:
        connection_id = await _udp_connect(
            loop, transport, proto, timeout, retries
        )
        resp = await _udp_roundtrip(
            loop, transport, proto,
            lambda tid: struct.pack(
                ">QII20s", connection_id, _ACTION_SCRAPE, tid, info_hash
            ),
            timeout, retries,
        )
        (action,) = struct.unpack_from(">I", resp, 0)
        if action == _ACTION_ERROR:
            raise TrackerError(resp[8:].decode("utf-8", "replace"))
        if action != _ACTION_SCRAPE or len(resp) < 20:
            raise TrackerError("malformed udp scrape response")
        seeders, completed, leechers = struct.unpack_from(">III", resp, 8)
        return ScrapeStats(seeders=seeders, completed=completed,
                           leechers=leechers)
    finally:
        transport.close()


class _UdpTrackerProtocol(asyncio.DatagramProtocol):
    """Collects datagrams into per-transaction futures."""

    def __init__(self) -> None:
        self.waiters: dict[int, asyncio.Future] = {}
        self.transport: Optional[asyncio.DatagramTransport] = None

    def connection_made(self, transport) -> None:
        self.transport = transport

    def datagram_received(self, data: bytes, addr) -> None:
        if len(data) < 8:
            return
        (tid,) = struct.unpack_from(">I", data, 4)
        fut = self.waiters.pop(tid, None)
        if fut is not None and not fut.done():
            fut.set_result(data)

    def error_received(self, exc) -> None:
        for fut in self.waiters.values():
            if not fut.done():
                fut.set_exception(TrackerError(f"udp error: {exc}"))
        self.waiters.clear()


def parse_compact_peers(blob: bytes) -> List[Peer]:
    """BEP 23 compact peers: 4-byte IP + 2-byte port each, concatenated.

    The single parser for every compact-peer surface (HTTP tracker, UDP
    tracker, DHT ``values``).  Port-0 entries are dropped — unconnectable.
    """
    out = []
    for i in range(0, len(blob) - len(blob) % 6, 6):
        host = socket.inet_ntoa(blob[i:i + 4])
        (peer_port,) = struct.unpack(">H", blob[i + 4:i + 6])
        if peer_port:
            out.append(Peer(host, peer_port))
    return out


def parse_compact_peers6(blob: bytes) -> List[Peer]:
    """BEP 7 compact IPv6 peers: 16-byte address + 2-byte port each."""
    out = []
    for i in range(0, len(blob) - len(blob) % 18, 18):
        host = socket.inet_ntop(socket.AF_INET6, blob[i:i + 16])
        (peer_port,) = struct.unpack(">H", blob[i + 16:i + 18])
        if peer_port:
            out.append(Peer(host, peer_port))
    return out


_parse_compact_peers = parse_compact_peers  # backwards-compatible alias


async def announce_udp(
    tracker_url: str,
    info_hash: bytes,
    peer_id: bytes,
    port: int,
    uploaded: int = 0,
    downloaded: int = 0,
    left: int = 0,
    event: str = "started",
    num_want: int = -1,
    timeout: float = 5.0,
    retries: int = 2,
) -> List[Peer]:
    """Announce over the BEP 15 UDP tracker protocol.

    Two round trips: ``connect`` (magic -> connection_id, guards against
    spoofed sources) then ``announce``.  Each request is retried
    ``retries`` times with the given per-attempt timeout; BEP 15's
    15*2^n schedule is collapsed to a flat timeout because the stage
    above already enforces the reference's 240 s stall budget.
    """
    parts = urllib.parse.urlsplit(tracker_url)
    if parts.hostname is None or parts.port is None:
        raise _permanent(f"udp tracker needs host:port: {tracker_url}")
    addr = (parts.hostname, parts.port)

    loop = asyncio.get_running_loop()
    transport, proto = await loop.create_datagram_endpoint(
        _UdpTrackerProtocol, remote_addr=addr
    )
    try:
        def _roundtrip(payload_fn):
            return _udp_roundtrip(
                loop, transport, proto, payload_fn, timeout, retries
            )

        connection_id = await _udp_connect(
            loop, transport, proto, timeout, retries
        )

        # announce round trip
        resp = await _roundtrip(
            lambda tid: struct.pack(
                ">QII20s20sQQQIIIiH",
                connection_id, _ACTION_ANNOUNCE, tid,
                info_hash, peer_id,
                downloaded, left, uploaded,
                _EVENT_CODES.get(event, 0),
                0,                      # IP: let the tracker use the source
                random.getrandbits(32),  # key
                num_want, port,
            )
        )
        (action,) = struct.unpack_from(">I", resp, 0)
        if action == _ACTION_ERROR:
            raise TrackerError(resp[8:].decode("utf-8", "replace"))
        if action != _ACTION_ANNOUNCE or len(resp) < 20:
            raise TrackerError("malformed udp announce response")
        # BEP 15: a tracker reached over IPv6 answers with 18-byte
        # (address, port) entries; slicing those on 6-byte boundaries
        # would fabricate garbage IPv4 peers
        sockname = transport.get_extra_info("sockname")
        if sockname is not None and len(sockname) == 4:  # AF_INET6 tuple
            return parse_compact_peers6(resp[20:])
        return parse_compact_peers(resp[20:])
    finally:
        transport.close()
