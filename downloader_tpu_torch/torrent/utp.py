"""uTP — Micro Transport Protocol (BEP 29) over UDP.

The reference's webtorrent client dials peers over both TCP and uTP
(upstream lib/download.js:19 — webtorrent bundles utp-native); uTP
matters in the real world because consumer NATs and ISP shapers often
drop or throttle bulk TCP, while uTP's LEDBAT congestion control yields
to interactive traffic and survives UDP-only NAT mappings.  This module
closes that transport capability with a from-scratch asyncio
implementation: no third-party code, standard BEP 29 wire format.

Surface: :func:`open_utp_connection` and :class:`UtpEndpoint` mirror
``asyncio.open_connection`` / ``asyncio.start_server`` closely enough
that the MSE layer (mse.py) and the peer wire protocol (wire.py) run
unchanged over uTP — the reader IS an ``asyncio.StreamReader`` and the
writer facade implements the subset the stack uses (``write``, ``drain``,
``close``, ``wait_closed``, ``is_closing``, ``get_extra_info``).

Protocol notes (BEP 29):

- 20-byte header: type/version byte, extension byte, connection id,
  32-bit microsecond timestamp, timestamp difference, advertised window,
  sequence number, ack number.  Types: ST_DATA, ST_FIN, ST_STATE,
  ST_RESET, ST_SYN.  ST_DATA/ST_FIN/ST_SYN consume sequence numbers;
  ST_STATE does not.
- Handshake: initiator sends ST_SYN with ``connection_id = conn_id_recv``
  and ``seq_nr = 1``; all later packets carry ``conn_id_send =
  conn_id_recv + 1``.  The acceptor mirrors the pair and replies with
  ST_STATE carrying a random initial ``seq_nr``.
- Selective ack (extension 1): a bitmask acking packets beyond
  ``ack_nr + 1`` so a single lost datagram doesn't stall the pipe.
- Congestion control is LEDBAT: every packet echoes the sender's
  timestamp back as ``timestamp_difference``; the one-way delay above a
  min-filtered base estimates queuing delay and the window tracks a
  100 ms target, backing off multiplicatively on loss/timeout.
"""

from __future__ import annotations

import asyncio
import random
import struct
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple, Union

ST_DATA = 0
ST_FIN = 1
ST_STATE = 2
ST_RESET = 3
ST_SYN = 4

VERSION = 1
EXT_SACK = 1

_HEADER = struct.Struct(">BBHIIIHH")
HEADER_SIZE = _HEADER.size  # 20

# conservative payload: 20-byte header under a 1400-byte UDP datagram
# clears every sane tunnel/PPPoE MTU without fragmentation
MAX_PAYLOAD = 1380
# loopback paths get large datagrams (the lo interface MTU is 64 KiB):
# throughput is bounded by per-packet processing cost, not bytes — the
# r3 payload sweep measured 27 MB/s at 1380 vs 648 MB/s at 60 KiB on
# the same code, and the full torrent swarm over uTP went 19 -> 79 MB/s
# (BASELINE.md "uTP: where the time goes")
LOOPBACK_PAYLOAD = 60 * 1024

# LEDBAT (RFC 6817 / BEP 29) parameters
TARGET_DELAY_US = 100_000
MAX_CWND_INCREASE_PER_RTT = 3000  # bytes, libutp's default gain

RECV_WINDOW = 1 << 20  # advertised receive window

MIN_RTO = 0.5
MAX_RETRANSMITS = 6  # ~0.5+1+2+4+8+16 s of backoff before giving up
FIN_LINGER = 3.0
# TIME_WAIT-style courtesy after our side retires with the peer's FIN
# still unseen: stay registered (acking the peer's data/FIN) so THEIR
# close completes in one round trip instead of retransmitting into
# silence until FIN_LINGER aborts — profiled r5: this stall made a
# loopback transfer of 32 MiB read 11 MB/s end-to-end while the data
# phase alone ran at ~1 GB/s
LAST_ACK_LINGER = 1.0

# acceptor-side state bounds: a SYN flood must not mint unbounded
# connection objects/timers, and a silent peer must not pin its slot
# forever (healthy BitTorrent connections carry 60 s keep-alives)
MAX_ACCEPTED_CONNS = 256
IDLE_TIMEOUT = 300.0

# out-of-order packets held while waiting for a retransmit; beyond this a
# hostile or badly reordered stream is dropped on the floor (the sender
# retransmits — correctness is unaffected, memory stays bounded)
MAX_OOO = 2048

# Delayed acks (r4): the r3 profile measured one ST_STATE per ST_DATA —
# roughly half the per-packet processing budget on a loopback transfer
# ("uTP: where the time goes", BASELINE.md).  Cumulative ack_nr makes
# acking every Nth in-order packet protocol-legal (BEP 29 specifies no
# ack schedule; libutp likewise delays); anything out of the ordinary —
# reordering, duplicates, FIN — still acks immediately, so dup-ack fast
# retransmit and loss recovery behave exactly as before.  The safety
# valve: the 50 ms timer tick flushes a pending ack long before the
# sender's MIN_RTO (500 ms) can fire.
DELAYED_ACK_EVERY = 2
DELAYED_ACK_TIMEOUT = 0.05


def _now_us() -> int:
    return time.monotonic_ns() // 1000 & 0xFFFFFFFF


def payload_for(host: str) -> int:
    """Path-aware packet size: loopback peers get large datagrams."""
    import ipaddress

    try:
        if ipaddress.ip_address(host).is_loopback:
            return LOOPBACK_PAYLOAD
    except ValueError:
        pass
    return MAX_PAYLOAD


def _seq_lte(a: int, b: int) -> bool:
    """True if a <= b in mod-2^16 sequence space."""
    return ((b - a) & 0xFFFF) < 0x8000


def _seq_lt(a: int, b: int) -> bool:
    return a != b and _seq_lte(a, b)


def encode_packet(ptype: int, conn_id: int, ts: int, ts_diff: int,
                  wnd: int, seq: int, ack: int,
                  sack: bytes = b"", payload: bytes = b"") -> bytes:
    ext = EXT_SACK if sack else 0
    head = _HEADER.pack((ptype << 4) | VERSION, ext, conn_id,
                        ts, ts_diff, wnd, seq, ack)
    if sack:
        # extension chain: [next_ext=0, len, bitmask]
        head += bytes((0, len(sack))) + sack
    return head + payload


class PacketError(ValueError):
    pass


def decode_packet(data: bytes):
    """-> (type, conn_id, ts, ts_diff, wnd, seq, ack, sack_mask, payload)

    The payload is a zero-copy memoryview into ``data`` (60 KiB loopback
    datagrams made the per-packet slice copy a measurable term — r4); it
    compares equal to bytes and feeds ``StreamReader.feed_data``
    directly."""
    if len(data) < HEADER_SIZE:
        raise PacketError("short packet")
    (tv, ext, conn_id, ts, ts_diff, wnd, seq, ack) = _HEADER.unpack_from(data)
    if tv & 0x0F != VERSION:
        raise PacketError("bad version")
    ptype = tv >> 4
    if ptype > ST_SYN:
        raise PacketError("bad type")
    offset = HEADER_SIZE
    sack = b""
    # walk the extension chain
    while ext:
        if offset + 2 > len(data):
            raise PacketError("truncated extension")
        next_ext = data[offset]
        length = data[offset + 1]
        if offset + 2 + length > len(data):
            raise PacketError("truncated extension body")
        if ext == EXT_SACK:
            sack = data[offset + 2:offset + 2 + length]
        ext = next_ext
        offset += 2 + length
    return (ptype, conn_id, ts, ts_diff, wnd, seq, ack, sack,
            memoryview(data)[offset:])


class _Inflight:
    """One unacked outgoing ST_DATA/ST_FIN packet."""

    __slots__ = ("seq", "ptype", "payload", "sent_at", "transmissions",
                 "need_resend")

    def __init__(self, seq: int, ptype: int, payload: bytes):
        self.seq = seq
        self.ptype = ptype
        self.payload = payload
        self.sent_at = 0.0
        self.transmissions = 0
        self.need_resend = False


class UtpWriter:
    """StreamWriter-compatible facade over a :class:`UtpConnection`."""

    def __init__(self, conn: "UtpConnection"):
        self._conn = conn

    def write(self, data: bytes) -> None:
        self._conn._write(data)

    async def drain(self) -> None:
        await self._conn._drain()

    def close(self) -> None:
        self._conn._close()

    async def wait_closed(self) -> None:
        await self._conn._wait_closed()

    def is_closing(self) -> bool:
        return self._conn._closing or self._conn._closed

    def get_extra_info(self, name: str, default=None):
        if name == "peername":
            return self._conn.remote_addr
        if name == "sockname":
            return self._conn.endpoint.local_addr
        return default


class UtpConnection:
    """One uTP connection: reliability, ordering, LEDBAT, stream bridge."""

    def __init__(self, endpoint: "UtpEndpoint",
                 remote_addr: Tuple[str, int],
                 recv_id: int, send_id: int, seq: int, *,
                 connected: bool = False):
        self.endpoint = endpoint
        self.remote_addr = remote_addr
        self.recv_id = recv_id  # conn_id on packets we RECEIVE
        self.send_id = send_id  # conn_id on packets we SEND
        self.reader = asyncio.StreamReader()
        self.writer = UtpWriter(self)

        self._seq = seq  # next sequence number WE will consume
        self._ack = 0  # last in-order sequence we received
        self._connected = asyncio.Event()
        if connected:
            self._connected.set()

        self._inflight: Dict[int, _Inflight] = {}
        # seqs in send order: cumulative acks pop from the left, so ack
        # processing is O(newly acked), not O(window) — at a 4 MB window
        # an O(window) scan per ack is the throughput ceiling
        self._order: deque = deque()
        # loss-marked packets awaiting retransmission: _flush drains this
        # instead of scanning the whole inflight dict per datagram
        self._resend: deque = deque()
        self._flight_bytes = 0
        # send queue: deque of whole buffers + consumed-prefix offset.
        # The r3 bytearray (`del buf[:60KiB]` per packet) memmoved the
        # entire remaining window left on EVERY packetization — ~270 MB
        # of memmove per 32 MiB transferred at a 1 MiB buffer; profiled
        # as a first-order term of the per-packet bound (r4)
        self._send_q: deque = deque()
        self._send_q_len = 0
        self._send_off = 0
        self._send_lo = asyncio.Event()
        self._send_lo.set()
        # path-aware packet size (loopback gets large datagrams; the
        # throughput bound is per-packet processing, not bytes)
        self.max_payload = payload_for(remote_addr[0])
        self._min_cwnd = 2 * self.max_payload
        self._cwnd = 16 * self.max_payload  # slow-start-ish initial window
        self._peer_wnd = RECV_WINDOW
        self._ooo: Dict[int, Tuple[int, bytes]] = {}  # seq -> (type, data)
        self._eof_seq: Optional[int] = None

        self._rtt = 0.0
        self._rtt_var = 0.0
        self._rto = 1.0
        self._base_delay: Optional[int] = None
        self._reply_micro = 0
        self._dup_acks = 0
        self._last_ack_seen = -1

        self._ack_scheduled = False
        self._flush_scheduled = False  # write-coalescing (one loop turn)
        self._pending_acks = 0  # in-order data packets not yet acked
        self._ack_deadline = 0.0
        self._quenched_peer = False  # we advertised < one packet of room
        self._wnd_update_at = 0.0
        self._probe_at = 0.0
        self._last_recv = time.monotonic()
        self._closing = False  # FIN queued/sent
        self._closed = False  # fully torn down
        self._fin_seq: Optional[int] = None
        self._done = asyncio.Event()
        self._timer: Optional[asyncio.Task] = None
        self._drain_timer = None  # LAST_ACK courtesy window (TimerHandle)
        self._syn_packet: Optional[bytes] = None

    # -- lifecycle ------------------------------------------------------
    def start_timer(self) -> None:
        self._timer = asyncio.create_task(self._timeout_loop())

    def abort(self, exc: Optional[BaseException] = None) -> None:
        """Hard teardown: RESET received, too many timeouts, or endpoint
        shutdown."""
        if self._closed:
            return
        self._closed = True
        if exc is not None and not self.reader.at_eof():
            self.reader.set_exception(exc)
        else:
            self.reader.feed_eof()
        self._send_lo.set()
        self._connected.set()
        self._done.set()
        if self._timer is not None:
            self._timer.cancel()
        if self._drain_timer is not None:
            self._drain_timer.cancel()
            self._drain_timer = None
        self.endpoint._unregister(self)

    async def _timeout_loop(self) -> None:
        try:
            while not self._closed:
                await asyncio.sleep(0.05)
                self._check_timeouts()
        except asyncio.CancelledError:
            pass

    def _check_timeouts(self) -> None:
        now = time.monotonic()
        if now - self._last_recv > IDLE_TIMEOUT:
            self.abort(ConnectionResetError("uTP idle timeout"))
            return
        # delayed-ack safety valve: an odd trailing packet (or a sender
        # pausing mid-window) gets its ack at the deadline, far inside
        # the sender's MIN_RTO
        if self._pending_acks and now >= self._ack_deadline:
            self._send_ack()
        if self._connected.is_set():
            self._check_zero_window(now)
        if not self._inflight:
            return
        oldest = min(self._inflight.values(), key=lambda p: p.sent_at)
        if now - oldest.sent_at < self._rto:
            # tail-loss probe (TCP TLP style): a lost LAST packet of a
            # burst generates no dup-acks, so without this the only
            # recovery is the full MIN_RTO (500 ms) — a massive stall
            # against sub-ms loopback RTTs (r5: occasional swarm runs
            # lost ~30% throughput to exactly these).  After a quiet
            # period of ~2 RTT (floored well above ack-coalescing
            # delays), re-send the NEWEST unacked packet once; if the
            # tail was lost the ack (or dup-ack chain) restarts
            # recovery, and a spurious probe costs one duplicate the
            # receiver discards.
            newest = max(self._inflight.values(), key=lambda p: p.sent_at)
            quiet = max(2 * self._rtt + 4 * self._rtt_var,
                        2 * DELAYED_ACK_TIMEOUT)
            if (now - newest.sent_at > quiet
                    and now - self._last_recv > quiet
                    and newest.transmissions == 1):
                self._transmit(newest)
            return
        if oldest.transmissions > MAX_RETRANSMITS:
            self.abort(ConnectionResetError("uTP retransmit limit"))
            return
        # timeout: multiplicative backoff, shrink to min window, resend
        # the oldest now; the rest stay marked and go out ack-clocked
        # (every arriving datagram flushes marked packets), so recovery
        # never bursts a full window into an already-lossy path
        self._rto = min(self._rto * 2, 16.0)
        self._cwnd = self._min_cwnd
        for pkt in self._inflight.values():
            if not pkt.need_resend:
                pkt.need_resend = True
                self._resend.append(pkt)
        self._transmit(oldest)

    def _check_zero_window(self, now: float) -> None:
        """Break the mutual zero-window stall.

        Acks are only ever sent in response to data, so once the receiver
        advertises wnd=0 and the sender's flight drains, neither side has
        a reason to transmit again — without this, the connection sits
        dead until IDLE_TIMEOUT.  Two complementary escapes:

        - receiver side: we quenched the sender (advertised < one packet)
          but the consumer has since drained the buffer — send an
          unsolicited ST_STATE carrying the reopened window.
        - sender side: the peer advertises no room and nothing is in
          flight — probe with ONE packet past the window (RTO-paced, like
          a TCP window probe); the forced ack carries the peer's current
          window even if the probe itself is dropped at the backstop.
        """
        if (self._quenched_peer
                and self._recv_window() >= self.max_payload
                and now - self._wnd_update_at >= max(self._rto, MIN_RTO)):
            # repeat RTO-paced until data flows again (_handle_data
            # disarms the flag): the update is a bare UDP datagram, and
            # a one-shot that gets dropped would re-create the very
            # stall it exists to break
            self._wnd_update_at = now
            self._send_ack()
        if (self._send_q_len and not self._inflight
                and self._peer_wnd < self.max_payload
                and now - self._probe_at >= max(self._rto, MIN_RTO)):
            self._probe_at = now
            # TCP-window-probe style: ONE byte past the window, so a
            # stalled receiver's buffer overshoot is bounded to ~nothing
            # (a full chunk per RTO would pile up toward the 4x backstop)
            self._send_next_chunk(limit=1)

    # -- connect (initiator side) --------------------------------------
    def send_syn(self) -> None:
        # SYN carries conn_id_recv (every other packet carries send_id)
        # and consumes seq 1; retransmission is owned by wait_connected,
        # not the regular inflight machinery
        self._syn_packet = encode_packet(
            ST_SYN, self.recv_id, _now_us(), 0, RECV_WINDOW,
            self._seq, 0,
        )
        self._seq = (self._seq + 1) & 0xFFFF
        self._transmit_raw(self._syn_packet)

    async def wait_connected(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        delay = 1.0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.abort()
                raise TimeoutError("uTP connect timed out")
            try:
                async with asyncio.timeout(min(delay, remaining)):
                    await self._connected.wait()
            except TimeoutError:
                if self._syn_packet is not None:
                    self._transmit_raw(self._syn_packet)
                delay *= 2
                continue
            if self._closed:
                raise ConnectionRefusedError("uTP connection refused")
            return

    # -- receive path ---------------------------------------------------
    def on_datagram(self, packet) -> None:
        """Handle one already-decoded packet tuple (the endpoint decodes
        exactly once, for routing and for us — r3 decoded twice)."""
        (ptype, _cid, ts, ts_diff, wnd, seq, ack, sack, payload) = packet
        if self._closed:
            # draining (LAST_ACK courtesy): keep acking the peer's
            # remaining in-order data/FIN — payloads are discarded (our
            # reader is gone), the cumulative ack is what lets the
            # peer's own close finish without retransmit stalls
            if ptype in (ST_DATA, ST_FIN) and self._drain_timer is not None:
                self._reply_micro = (_now_us() - ts) & 0xFFFFFFFF
                if seq == ((self._ack + 1) & 0xFFFF):
                    self._ack = seq
                self._send_ack()
                if ptype == ST_FIN and seq == self._ack:
                    # both directions now closed and acked: no reason
                    # to hold the socket/routing slot for the rest of
                    # the linger (review r5 — churning swarms would
                    # accumulate a dead socket per close otherwise)
                    self._drain_timer.cancel()
                    self._unregister_after_drain()
            return
        self._last_recv = time.monotonic()
        self._reply_micro = (_now_us() - ts) & 0xFFFFFFFF
        self._peer_wnd = wnd

        if ptype == ST_RESET:
            self.abort(ConnectionResetError("uTP connection reset by peer"))
            return

        if not self._connected.is_set():
            if ptype in (ST_STATE, ST_DATA, ST_FIN):
                # acceptor's reply: its seq_nr is the next it will send
                self._ack = (seq - 1) & 0xFFFF
                self._connected.set()
            # fall through: the packet's ack/payload still matter
        self._handle_ack(ack, sack, ts_diff)

        if ptype in (ST_DATA, ST_FIN):
            in_order = self._handle_data(ptype, seq, payload)
            self._pending_acks += 1
            if self._pending_acks == 1:
                self._ack_deadline = (time.monotonic()
                                      + DELAYED_ACK_TIMEOUT)
            # immediate ack on anything irregular (dup-ack fast
            # retransmit depends on it) or every Nth in-order packet;
            # in between, the timer tick flushes (delayed ack).  The
            # call_soon coalesces a burst already queued on the loop
            # into ONE ack with SACK state as of the last packet.
            if ((not in_order or ptype == ST_FIN
                 or self._pending_acks >= DELAYED_ACK_EVERY)
                    and not self._ack_scheduled):
                self._ack_scheduled = True
                asyncio.get_running_loop().call_soon(self._flush_ack)
        elif ptype == ST_SYN:
            # duplicate SYN (our ST_STATE got lost): re-ack it
            self._send_ack()
        self._flush()
        if (self._closed and self._drain_timer is not None
                and self._eof_seq is not None):
            # this very datagram both completed our retire (its ack
            # covered our FIN) and carried the peer's FIN: once the
            # already-scheduled ack flushes (call_soon FIFO), the
            # handshake is done — end the drain instead of holding the
            # slot/socket for the linger (simultaneous-close case the
            # closed-branch early-exit above cannot see).  The timer
            # attr stays set until the deferred call so _flush_ack
            # still treats the connection as drain-alive and sends the
            # FIN's ack first.
            self._drain_timer.cancel()
            asyncio.get_running_loop().call_soon(
                self._unregister_after_drain)

    def _flush_ack(self) -> None:
        self._ack_scheduled = False
        # draining counts as alive for acking: a FIN's ack scheduled
        # just before our own retire must still go out, or the peer
        # retransmits into silence (r5)
        if self._pending_acks and (not self._closed
                                   or self._drain_timer is not None):
            self._send_ack()

    def _handle_data(self, ptype: int, seq: int, payload: bytes) -> bool:
        """Returns True for the plain in-order case (eligible for a
        delayed ack); False for anything that must be acked NOW —
        duplicates (stop the retransmitting sender), reordering (feed
        the sender's dup-ack fast retransmit), backstop drops."""
        # data arriving means the sender knows our window again; if the
        # consumer stalls once more, _recv_window re-arms the flag
        self._quenched_peer = False
        # hard backstop behind the advertised window: a sender that
        # ignores flow control must not balloon the reader buffer (the
        # dropped packet goes unacked, so a compliant-after-all sender
        # just retransmits once the consumer catches up)
        if len(self.reader._buffer) > 4 * RECV_WINDOW:  # noqa: SLF001
            return False
        nxt = (self._ack + 1) & 0xFFFF
        if _seq_lt(seq, nxt):
            return False  # duplicate
        if seq != nxt:
            if len(self._ooo) < MAX_OOO:
                self._ooo.setdefault(seq, (ptype, payload))
            return False
        filled_gap = bool(self._ooo)
        self._deliver(ptype, payload)
        self._ack = seq
        # drain any now-in-order packets
        while True:
            nxt = (self._ack + 1) & 0xFFFF
            entry = self._ooo.pop(nxt, None)
            if entry is None:
                break
            self._deliver(entry[0], entry[1])
            self._ack = nxt
        # a retransmission that fills a reordering gap must be acked NOW
        # (the cumulative ack jumps past the sacked range; delaying it
        # would hold the sender's flight bytes for up to the timer tick),
        # as must anything leaving further gaps behind
        return not filled_gap and not self._ooo

    def _deliver(self, ptype: int, payload: bytes) -> None:
        if ptype == ST_FIN:
            self._eof_seq = 1  # marker; eof fires below
            if not self.reader.at_eof():
                self.reader.feed_eof()
            # no more data will be accepted; if our FIN is also done,
            # the connection can retire
            if self._closing and not self._inflight and not self._send_q_len:
                self._retire()
            return
        if payload and self._eof_seq is None and not self._closed:
            # the _closed guard: a datagram can FIRST ack our FIN
            # (retiring us, reader EOF'd) and ALSO carry in-order data
            # — half-close with the peer still streaming; feeding a
            # finished reader raises, killing the whole recv batch
            # (review r5).  The data is discarded; the cumulative ack
            # still flows from the drain path.
            self.reader.feed_data(payload)

    # -- ack / congestion path ------------------------------------------
    def _handle_ack(self, ack: int, sack: bytes, ts_diff: int) -> None:
        acked_bytes = 0
        now = time.monotonic()
        while self._order and _seq_lte(self._order[0], ack):
            seq = self._order.popleft()
            pkt = self._inflight.pop(seq, None)
            if pkt is None:
                continue  # already sacked away
            acked_bytes += len(pkt.payload)
            self._flight_bytes -= len(pkt.payload)
            if pkt.transmissions == 1:
                self._update_rtt(now - pkt.sent_at)
        if sack:
            acked_bytes += self._handle_sack(ack, sack)
        if acked_bytes:
            self._dup_acks = 0
            self._ledbat(acked_bytes, ts_diff)
        elif ack == self._last_ack_seen and self._inflight:
            self._dup_acks += 1
            if self._dup_acks == 3:
                # fast retransmit of the earliest unacked packet
                earliest = min(self._inflight, key=lambda s: (s - ack) & 0xFFFF)
                self._transmit(self._inflight[earliest])
                self._cwnd = max(self._cwnd // 2, self._min_cwnd)
        self._last_ack_seen = ack
        if self._send_buf_low():
            self._send_lo.set()
        if (self._closing and self._fin_seq is not None
                and self._fin_seq not in self._inflight):
            self._retire()

    def _handle_sack(self, ack: int, mask: bytes) -> int:
        """Selective ack: bit n covers seq ``ack + 2 + n``.  Returns bytes
        newly acked; packets below a thrice-sacked horizon are resent."""
        acked = 0
        highest_sacked = None
        sacked_count = 0
        for n in range(len(mask) * 8):
            if not mask[n >> 3] & (1 << (n & 7)):
                continue
            seq = (ack + 2 + n) & 0xFFFF
            sacked_count += 1
            highest_sacked = seq
            pkt = self._inflight.pop(seq, None)
            if pkt is not None:
                acked += len(pkt.payload)
                self._flight_bytes -= len(pkt.payload)
        if highest_sacked is not None and sacked_count >= 3:
            for seq, pkt in self._inflight.items():
                if _seq_lt(seq, highest_sacked) and not pkt.need_resend:
                    pkt.need_resend = True
                    self._transmit(pkt)  # clears the flag; no queue entry
        return acked

    def _update_rtt(self, sample: float) -> None:
        if self._rtt == 0.0:
            self._rtt, self._rtt_var = sample, sample / 2
        else:
            delta = abs(sample - self._rtt)
            self._rtt_var += (delta - self._rtt_var) / 4
            self._rtt += (sample - self._rtt) / 8
        self._rto = max(self._rtt + 4 * self._rtt_var, MIN_RTO)

    def _ledbat(self, acked_bytes: int, ts_diff: int) -> None:
        """RFC 6817-style window update from the echoed one-way delay."""
        if ts_diff:
            if self._base_delay is None or ts_diff < self._base_delay:
                self._base_delay = ts_diff
            queuing = ts_diff - self._base_delay
            off_target = (TARGET_DELAY_US - queuing) / TARGET_DELAY_US
        else:
            off_target = 1.0
        window_factor = min(acked_bytes / max(self._cwnd, 1), 1.0)
        self._cwnd += int(
            MAX_CWND_INCREASE_PER_RTT * off_target * window_factor
        )
        self._cwnd = max(self._min_cwnd, min(self._cwnd, 4 << 20))

    # -- send path ------------------------------------------------------
    def _write(self, data: bytes) -> None:
        if self._closing or self._closed:
            raise ConnectionResetError("uTP writer is closed")
        if data:
            # bytes(bytes) is a refcount bump, not a copy; memoryview/
            # bytearray callers get the one defensive copy the old
            # bytearray-append also paid
            self._send_q.append(data if isinstance(data, bytes)
                                else bytes(data))
            self._send_q_len += len(data)
        if not self._send_buf_low():
            self._send_lo.clear()
        # packetize one loop turn later, not per write: a pipelined
        # serve loop writes many 16 KiB blocks back-to-back in one turn,
        # and flushing each immediately emitted one UNDERSIZED datagram
        # per block (~2.7k packets per 32 MiB instead of ~560 at the
        # 60 KiB loopback payload — r5 profile).  Deferring lets the
        # burst coalesce into full datagrams; ack-clocked refills
        # (_handle_ack -> _flush) stay immediate.
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(self._deferred_flush)

    def _deferred_flush(self) -> None:
        self._flush_scheduled = False
        if not self._closed:
            self._flush()

    def _send_buf_low(self) -> bool:
        return self._send_q_len < RECV_WINDOW // 2

    async def _drain(self) -> None:
        if self._closed and self._send_q_len:
            raise ConnectionResetError("uTP connection closed")
        await self._send_lo.wait()

    def _flush(self) -> None:
        """Packetize the send buffer up to the congestion/peer window,
        resending loss-marked packets first (they already occupy flight
        bytes, so retransmitting them never grows the window)."""
        if not self._connected.is_set() or self._closed:
            return
        while self._resend:
            pkt = self._resend.popleft()
            # stale entries: acked away since marking, or already resent
            if pkt.need_resend and pkt.seq in self._inflight:
                self._transmit(pkt)
        window = min(self._cwnd, self._peer_wnd)
        while self._send_q_len and self._flight_bytes < window:
            self._send_next_chunk()
        if self._send_buf_low():
            self._send_lo.set()
        if (self._closing and not self._send_q_len
                and self._fin_seq is None):
            self._send_fin()

    def _take_chunk(self, size: int) -> bytes:
        """Dequeue up to ``size`` bytes: whole queued buffers pass
        through with zero copies; a partially-consumed head advances an
        offset instead of memmoving the remainder."""
        parts = []
        need = size
        while need and self._send_q:
            head = self._send_q[0]
            avail = len(head) - self._send_off
            if avail <= need:
                parts.append(memoryview(head)[self._send_off:]
                             if self._send_off else head)
                self._send_q.popleft()
                self._send_off = 0
                need -= avail
            else:
                parts.append(
                    memoryview(head)[self._send_off:self._send_off + need])
                self._send_off += need
                need = 0
        self._send_q_len -= size - need
        if len(parts) == 1:
            part = parts[0]
            return part if isinstance(part, bytes) else bytes(part)
        return b"".join(parts)

    def _send_next_chunk(self, limit: Optional[int] = None) -> None:
        """Packetize and transmit one chunk off the send buffer."""
        size = self.max_payload if limit is None else min(limit, self.max_payload)
        chunk = self._take_chunk(min(size, self._send_q_len))
        pkt = _Inflight(self._seq, ST_DATA, chunk)
        self._inflight[self._seq] = pkt
        self._order.append(self._seq)
        self._seq = (self._seq + 1) & 0xFFFF
        self._flight_bytes += len(chunk)
        self._transmit(pkt)

    def _sack_mask(self) -> bytes:
        if not self._ooo:
            return b""
        mask = bytearray(8)  # 64 seqs of lookahead, multiple-of-4 length
        base = (self._ack + 2) & 0xFFFF
        for seq in self._ooo:
            n = (seq - base) & 0xFFFF
            if n < 64:
                mask[n >> 3] |= 1 << (n & 7)
        return bytes(mask)

    def _send_ack(self) -> None:
        self._pending_acks = 0  # cumulative: covers everything pending
        self._transmit_raw(encode_packet(
            ST_STATE, self.send_id, _now_us(), self._reply_micro,
            self._recv_window(), self._seq, self._ack,
            sack=self._sack_mask(),
        ))

    def _recv_window(self) -> int:
        # StreamReader buffers internally; advertise the remaining slack
        # so a stalled consumer eventually quenches the sender
        buffered = len(self.reader._buffer)  # noqa: SLF001 - stdlib attr
        wnd = max(RECV_WINDOW - buffered, 0)
        if wnd < self.max_payload:
            self._quenched_peer = True
        return wnd

    def _transmit(self, pkt: _Inflight) -> None:
        pkt.sent_at = time.monotonic()
        pkt.transmissions += 1
        pkt.need_resend = False
        self._transmit_raw(encode_packet(
            pkt.ptype, self.send_id, _now_us(), self._reply_micro,
            self._recv_window(), pkt.seq, self._ack, payload=pkt.payload,
        ))

    def _transmit_raw(self, data: bytes) -> None:
        self.endpoint._send(data, self.remote_addr)

    # -- close ----------------------------------------------------------
    def _send_fin(self) -> None:
        self._fin_seq = self._seq
        pkt = _Inflight(self._seq, ST_FIN, b"")
        self._inflight[self._seq] = pkt
        self._order.append(self._seq)
        self._seq = (self._seq + 1) & 0xFFFF
        self._transmit(pkt)

    def _close(self) -> None:
        if self._closing or self._closed:
            return
        self._closing = True
        if self._connected.is_set():
            self._flush()  # queues the FIN once the buffer drains
        else:
            self.abort()

    def _retire(self) -> None:
        """Graceful completion: our FIN is acked and the buffer is empty."""
        if self._closed:
            return
        self._closed = True
        if not self.reader.at_eof():
            self.reader.feed_eof()
        self._send_lo.set()
        self._done.set()
        if self._timer is not None:
            self._timer.cancel()
        if self._eof_seq is not None:
            # both directions finished: fully gone
            self.endpoint._unregister(self)
        else:
            # the peer hasn't closed its direction yet: drain — stay
            # registered to ack its remaining data/FIN (on_datagram's
            # closed-branch) so its close completes promptly, then
            # unregister after the courtesy window
            loop = asyncio.get_running_loop()
            self._drain_timer = loop.call_later(
                LAST_ACK_LINGER, self._unregister_after_drain)

    def _unregister_after_drain(self) -> None:
        self._drain_timer = None
        self.endpoint._unregister(self)

    async def _wait_closed(self) -> None:
        if not self._closing and not self._closed:
            return
        try:
            async with asyncio.timeout(FIN_LINGER):
                await self._done.wait()
        except TimeoutError:
            self.abort()


class _RawUdpTransport:
    """Minimal datagram transport over a nonblocking UDP socket with a
    DRAINING read loop: one event-loop wakeup processes up to
    ``RECV_BATCH`` queued datagrams instead of one.

    asyncio's ``_SelectorDatagramTransport`` does exactly one recvfrom
    per selector wakeup, so a burst of queued datagrams pays the full
    loop round-trip (callback scheduling, selector re-entry) per packet
    — profiled as a first-order share of uTP's per-packet budget.
    Draining amortizes that across the batch; the cap keeps one busy
    socket from starving the rest of the loop.  The surface mirrors the
    subset of DatagramTransport the endpoint (and the test suite's
    lossy wrappers) use: ``sendto``/``close``/``is_closing``/
    ``get_extra_info``.
    """

    RECV_BATCH = 64

    def __init__(self, loop, sock, recv_cb, error_cb):
        self._loop = loop
        self._sock = sock
        self._recv_cb = recv_cb
        self._error_cb = error_cb
        self._closing = False
        loop.add_reader(sock.fileno(), self._on_readable)

    def _on_readable(self) -> None:
        for _ in range(self.RECV_BATCH):
            if self._closing:
                return
            try:
                data, addr = self._sock.recvfrom(65536)
            except (BlockingIOError, InterruptedError):
                return
            except OSError as exc:
                # connected-UDP sockets surface ICMP errors here
                self._error_cb(exc)
                return
            self._recv_cb(data, addr)

    def sendto(self, data, addr=None) -> None:
        if self._closing:
            return
        try:
            if addr is None:
                self._sock.send(data)
            else:
                self._sock.sendto(data, addr)
        except (BlockingIOError, InterruptedError):
            # kernel send buffer full: drop — UDP semantics, the
            # reliability layer retransmits
            pass
        except OSError as exc:
            self._error_cb(exc)

    def get_extra_info(self, name: str, default=None):
        if name == "socket":
            return self._sock
        if name == "sockname":
            try:
                return self._sock.getsockname()
            except OSError:
                return default
        return default

    def is_closing(self) -> bool:
        return self._closing

    def close(self) -> None:
        if self._closing:
            return
        self._closing = True
        try:
            self._loop.remove_reader(self._sock.fileno())
        except (OSError, ValueError):
            pass
        self._sock.close()


class _FallbackDatagramProtocol(asyncio.DatagramProtocol):
    """Adapter used when the event loop has no ``add_reader`` (Windows'
    default ProactorEventLoop): routes asyncio's one-datagram-per-wakeup
    transport callbacks into the endpoint.  Slower than the draining
    raw transport, but the stack stays functional on every loop."""

    def __init__(self, endpoint: "UtpEndpoint"):
        self._endpoint = endpoint

    def datagram_received(self, data, addr) -> None:
        self._endpoint.datagram_received(data, addr)

    def error_received(self, exc) -> None:
        self._endpoint.error_received(exc)


class UtpEndpoint:
    """A UDP socket multiplexing uTP connections.

    One endpoint per listen socket (acceptor side, ``accept_cb`` invoked
    per incoming connection like ``asyncio.start_server``), or per
    outgoing connection (connected-UDP socket, so ICMP port-unreachable
    surfaces as a fast ``ConnectionRefusedError`` instead of a timeout).
    """

    def __init__(self, accept_cb: Optional[Callable] = None):
        self.accept_cb = accept_cb
        self._conns: Dict[Tuple[Tuple[str, int], int], UtpConnection] = {}
        # _RawUdpTransport normally; asyncio's DatagramTransport on
        # loops without add_reader — only the shared sendto/close/
        # is_closing/get_extra_info subset may be called on it
        self._transport: Union[_RawUdpTransport,
                               asyncio.DatagramTransport, None] = None
        # set ONLY on the fallback transport of a connected socket: the
        # stock transports need an explicit sockaddr there (proactor's
        # WSASendTo rejects addr=None; _RawUdpTransport uses send())
        self._fallback_peer: Optional[tuple] = None
        self._remote: Optional[Tuple[str, int]] = None
        self.local_addr: Optional[Tuple[str, int]] = None
        self._accept_tasks: set = set()
        self._closed = False

    @classmethod
    async def create(cls, host: str = "0.0.0.0", port: int = 0,
                     accept_cb: Optional[Callable] = None,
                     remote_addr: Optional[Tuple[str, int]] = None,
                     ) -> "UtpEndpoint":
        import socket as _socket

        self = cls(accept_cb)
        loop = asyncio.get_running_loop()
        if remote_addr is not None:
            infos = await loop.getaddrinfo(
                remote_addr[0], remote_addr[1], type=_socket.SOCK_DGRAM)
        else:
            infos = await loop.getaddrinfo(
                host, port, type=_socket.SOCK_DGRAM,
                flags=_socket.AI_PASSIVE)
        # try every addrinfo entry (create_datagram_endpoint's family
        # fallback: an IPv6-first resolution on an IPv6-disabled host
        # must fall through to AF_INET, not fail the endpoint)
        last_exc: Optional[OSError] = None
        for family, stype, proto, _cn, target in infos:
            try:
                sock = _socket.socket(family, stype, proto)
            except OSError as exc:
                last_exc = exc
                continue
            try:
                sock.setblocking(False)
                if remote_addr is not None:
                    # UDP connect: instant, enables fast ICMP errors
                    sock.connect(target)
                    self._remote = remote_addr
                else:
                    sock.bind(target)
            except OSError as exc:
                # failure must not leak the fd (the old
                # create_datagram_endpoint closed it for us)
                sock.close()
                last_exc = exc
                continue
            break
        else:
            raise last_exc or OSError("getaddrinfo returned no usable address")
        try:
            # default UDP buffers (~208 KiB) overflow under window-sized
            # bursts — the kernel drops the excess silently, which reads
            # as pathological "loss" even on loopback.  The kernel caps
            # this at net.core.{r,w}mem_max; no error when it does.
            for opt in (_socket.SO_RCVBUF, _socket.SO_SNDBUF):
                try:
                    sock.setsockopt(_socket.SOL_SOCKET, opt, 4 << 20)
                except OSError:
                    pass
            try:
                self._transport = _RawUdpTransport(
                    loop, sock, self.datagram_received, self.error_received)
            except NotImplementedError:
                # Proactor loops have no add_reader: fall back to the
                # stock datagram transport (correct, just unbatched).
                # sock= alone leaves the transport's _address unset, so
                # a connected socket must still pass an explicit peer
                # on every sendto (proactor's WSASendTo cannot take
                # addr=None; review r5)
                if remote_addr is not None:
                    self._fallback_peer = sock.getpeername()
                transport, _proto = await loop.create_datagram_endpoint(
                    lambda: _FallbackDatagramProtocol(self), sock=sock)
                self._transport = transport
            self.local_addr = sock.getsockname()[:2]
        except BaseException:
            sock.close()
            raise
        return self

    def error_received(self, exc: OSError) -> None:
        # connected-UDP sockets get ICMP unreachable here: fail fast
        if self._remote is not None:
            for conn in list(self._conns.values()):
                conn.abort(ConnectionRefusedError(str(exc)))

    def datagram_received(self, data: bytes, addr) -> None:
        addr = addr[:2]
        try:
            packet = decode_packet(data)
        except PacketError:
            return
        ptype, conn_id = packet[0], packet[1]
        if self._remote is not None:
            addr = self._remote  # connected socket: normalize the key
        conn = self._conns.get((addr, conn_id))
        if conn is not None:
            conn.on_datagram(packet)
            return
        if ptype == ST_SYN and self.accept_cb is not None:
            self._accept(packet, addr)
        elif ptype not in (ST_RESET, ST_SYN):
            # unknown connection: tell the sender to go away
            self._send(encode_packet(
                ST_RESET, conn_id, _now_us(), 0, 0, 0, 0), addr)

    def _accept(self, packet, addr) -> None:
        conn_id, seq = packet[1], packet[5]
        # SYN retransmit (our ST_STATE was lost or slow): the live
        # acceptor is registered under conn_id+1 — packets from the
        # initiator carry that id, but retransmitted SYNs still carry the
        # original.  Re-ack through the existing connection instead of
        # clobbering it with a fresh one (whose new random seq would
        # desynchronize the peer that handshook against the first).
        existing = self._conns.get((addr, (conn_id + 1) & 0xFFFF))
        if existing is not None:
            existing._send_ack()
            return
        if len(self._conns) >= MAX_ACCEPTED_CONNS:
            return  # flood bound: drop the SYN, no state minted
        conn = UtpConnection(
            self, addr,
            recv_id=(conn_id + 1) & 0xFFFF, send_id=conn_id,
            seq=random.randrange(1 << 16), connected=True,
        )
        conn._ack = seq  # the SYN consumed seq 1
        self._conns[(addr, conn.recv_id)] = conn
        conn.start_timer()
        conn._send_ack()  # ST_STATE completes the handshake
        task = asyncio.ensure_future(
            self.accept_cb(conn.reader, conn.writer))
        self._accept_tasks.add(task)
        task.add_done_callback(self._accept_tasks.discard)

    # -- dialing --------------------------------------------------------
    async def connect(self, host: str, port: int, timeout: float = 10.0,
                      ) -> Tuple[asyncio.StreamReader, UtpWriter]:
        recv_id = random.randrange(1 << 16)
        conn = UtpConnection(
            self, (host, port),
            recv_id=recv_id, send_id=(recv_id + 1) & 0xFFFF, seq=1,
        )
        self._conns[((host, port), recv_id)] = conn
        conn.start_timer()
        conn.send_syn()
        await conn.wait_connected(timeout)
        return conn.reader, conn.writer

    # -- plumbing -------------------------------------------------------
    def _send(self, data: bytes, addr) -> None:
        if self._transport is None or self._transport.is_closing():
            return
        if self._remote is not None:
            # connected socket: no addr for the raw transport (it uses
            # send()); the fallback transports need the explicit peer
            self._transport.sendto(data, self._fallback_peer)
        else:
            self._transport.sendto(data, addr)

    def _unregister(self, conn: UtpConnection) -> None:
        self._conns.pop((conn.remote_addr, conn.recv_id), None)
        if self._remote is not None and not self._closed:
            # single-connection outgoing endpoint: retire the socket
            self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for conn in list(self._conns.values()):
            conn.abort(ConnectionResetError("endpoint closed"))
        for task in list(self._accept_tasks):
            task.cancel()
        if self._transport is not None:
            self._transport.close()


class _OwningWriter(UtpWriter):
    """Writer for one-shot outgoing connections: closing the stream also
    retires the ephemeral endpoint/socket behind it (matches the lifetime
    callers expect from ``asyncio.open_connection``)."""

    def __init__(self, conn: UtpConnection, endpoint: UtpEndpoint):
        super().__init__(conn)
        self._endpoint = endpoint

    async def wait_closed(self) -> None:
        await super().wait_closed()
        if self._conn._drain_timer is None:
            self._endpoint.close()
        # else: the LAST_ACK drain window owns the endpoint now — its
        # expiry unregisters the connection, which retires the
        # single-connection socket; closing here would slam the socket
        # shut before the peer's FIN can be acked (r5)


async def open_utp_connection(host: str, port: int, *,
                              timeout: float = 10.0,
                              ) -> Tuple[asyncio.StreamReader, UtpWriter]:
    """Dial ``host:port`` over uTP; drop-in for ``asyncio.open_connection``.

    Creates a dedicated connected-UDP socket so ICMP errors fail fast."""
    endpoint = await UtpEndpoint.create(remote_addr=(host, port))
    try:
        reader, writer = await endpoint.connect(host, port, timeout=timeout)
    except BaseException:
        endpoint.close()
        raise
    return reader, _OwningWriter(writer._conn, endpoint)
