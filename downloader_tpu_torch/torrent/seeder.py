"""A serving peer: pieces, ut_metadata, and peer exchange over the wire.

webtorrent both leeches and seeds (upstream lib/download.js:19 keeps
one long-lived client); this is the serving half.  It doubles as the hermetic
swarm for tests (no network egress needed) and as the listen socket a
leeching :class:`~.client.TorrentClient` runs so replicas downloading the
same torrent can trade pieces (seed-while-leech).

Supports partially-available content: construct with ``have`` (a live,
possibly shared set of piece indices) and call :meth:`add_piece` as pieces
verify — connected peers get ``HAVE`` broadcasts (BEP 3).  Peers that
advertise a listen port in their BEP 10 handshake are gossiped to the rest
of the swarm via ut_pex (BEP 11).
"""

from __future__ import annotations

import asyncio
import os
import random
import struct
from typing import Dict, Optional, Set, Tuple

from . import mse, wire
from .metainfo import Metainfo
from .storage import TorrentStorage


class Seeder:
    """Serves one torrent's pieces from ``root`` on a local TCP port.

    ``have`` is the set of piece indices available to serve; ``None`` means
    the content is complete.  The set may be shared with (and mutated by) a
    downloading client — :meth:`add_piece` announces new pieces to every
    connected peer.
    """

    def __init__(self, meta: Metainfo, root: Optional[str] = None,
                 peer_id: Optional[bytes] = None,
                 storage: Optional[TorrentStorage] = None,
                 have: Optional[Set[int]] = None,
                 unchoke_slots: int = 4,
                 rotate_interval: float = 10.0,
                 optimistic_interval: float = 30.0,
                 crypto: str = "prefer"):
        if storage is None:
            if root is None:
                raise ValueError("need root or storage")
            storage = TorrentStorage(meta, root)
        self.meta = meta
        self.storage = storage
        self.have = have  # live reference; None = everything
        self.peer_id = peer_id or (b"-DT0001-" + os.urandom(6).hex().encode())
        self._server: Optional[asyncio.base_events.Server] = None
        self._utp = None  # UtpEndpoint once started (uTP accept path)
        self.port: Optional[int] = None
        self.connections: int = 0
        self.bytes_served: int = 0
        self._conn_tasks: Set[asyncio.Task] = set()
        self._peers: Set[wire.PeerWire] = set()
        # peers that advertised a listen port: PeerWire -> (host, port)
        self._listen_addrs: Dict[wire.PeerWire, Tuple[str, int]] = {}
        # -- choking (tit-for-tat + optimistic, like webtorrent's engine;
        # upstream lib/download.js:9,19 — its torrent-stream core
        # slot-limits uploads so one peer cannot monopolize a seeder).
        # Regular slots go to the interested peers we served the most
        # bytes in the last rotation window (a seed reciprocates to the
        # peers actually draining it); one extra optimistic slot rotates
        # through the remaining interested peers so newcomers get a
        # chance to prove themselves.
        self.unchoke_slots = unchoke_slots
        self.rotate_interval = rotate_interval
        self.optimistic_interval = optimistic_interval
        # MSE acceptor policy: "require" = RC4-only payload; anything
        # else selects plaintext-after-handshake when the initiator
        # allows it (mse.accept docstring)
        self.crypto = crypto
        self._interested: Set[wire.PeerWire] = set()
        self._unchoked: Set[wire.PeerWire] = set()
        self._optimistic: Optional[wire.PeerWire] = None
        self._served_window: Dict[wire.PeerWire, int] = {}
        self._choker_task: Optional[asyncio.Task] = None

    def _available(self, index: int) -> bool:
        return self.have is None or index in self.have

    def _have_indices(self):
        return range(self.meta.num_pieces) if self.have is None else self.have

    async def start(self, host: str = "127.0.0.1", port: int = 0,
                    utp: bool = True) -> int:
        self._server = await asyncio.start_server(self._on_connect, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        if utp:
            # uTP listener on the SAME port number over UDP (BEP 29
            # convention — webtorrent serves both transports on one port,
            # upstream lib/download.js:19).  The accept path is
            # shared, so uTP peers get MSE sniffing, ut_pex, the lot.
            from .utp import UtpEndpoint

            try:
                self._utp = await UtpEndpoint.create(
                    host, self.port, accept_cb=self._on_connect)
            except OSError:
                self._utp = None  # UDP port taken: TCP-only is still fine
        self._choker_task = asyncio.create_task(self._choke_loop())
        return self.port

    async def stop(self) -> None:
        if self._choker_task is not None:
            self._choker_task.cancel()
            try:
                await self._choker_task
            except (asyncio.CancelledError, Exception):
                pass
            self._choker_task = None
        if self._utp is not None:
            self._utp.close()
            self._utp = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for task in list(self._conn_tasks):
            task.cancel()
        for task in list(self._conn_tasks):
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self.storage.close()  # drop cached fds (reopen-on-use if shared)

    async def add_piece(self, index: int) -> None:
        """Record a newly available piece and HAVE-broadcast it (BEP 3).

        Broadcasts run as background tasks: one stalled connection (a peer
        that stops reading, filling our write buffer) must not block the
        caller — for the seed-while-leech path the caller is the download's
        control loop.
        """
        if self.have is not None:
            self.have.add(index)
        for peer in list(self._peers):
            task = asyncio.create_task(self._quiet_send(peer.send_have(index)))
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)

    @staticmethod
    async def _quiet_send(coro) -> None:
        """Await a peer send, swallowing death-of-connection errors —
        the peer's own serve loop does the cleanup."""
        try:
            await coro
        except (ConnectionError, OSError, wire.WireError):
            pass

    # -- choking --------------------------------------------------------
    def is_unchoked(self, peer: wire.PeerWire) -> bool:
        return peer in self._unchoked

    async def _choke_loop(self) -> None:
        """Periodic tit-for-tat recompute; every ``optimistic_interval``
        the optimistic slot moves to a different interested-but-choked
        peer (the classic 10 s / 30 s cadence at the defaults)."""
        loop = asyncio.get_running_loop()
        next_optimistic = loop.time()  # first pass seats an optimistic
        while True:
            await asyncio.sleep(self.rotate_interval)
            rotate = loop.time() >= next_optimistic
            if rotate:
                next_optimistic = loop.time() + self.optimistic_interval
            await self._recompute_chokes(rotate_optimistic=rotate)

    async def _recompute_chokes(self, rotate_optimistic: bool = False) -> None:
        interested = [p for p in self._peers if p in self._interested]
        # reciprocate to the peers that actually drained us last window;
        # ties (fresh swarm) keep whoever is already unchoked seated so
        # the steady state doesn't churn
        ranked = sorted(
            interested,
            key=lambda p: (self._served_window.get(p, 0),
                           p in self._unchoked),
            reverse=True,
        )
        regular = set(ranked[:self.unchoke_slots])
        if (rotate_optimistic or self._optimistic not in interested
                or self._optimistic in regular):
            candidates = [p for p in interested
                          if p not in regular and p is not self._optimistic]
            if candidates:
                self._optimistic = random.choice(candidates)
            elif (self._optimistic not in interested
                    or self._optimistic in regular):
                self._optimistic = None
        target = set(regular)
        if self._optimistic is not None:
            target.add(self._optimistic)
        for peer in list(self._unchoked - target):
            self._unchoked.discard(peer)
            await self._quiet_send(peer.send_message(wire.MSG_CHOKE))
        for peer in list(target - self._unchoked):
            self._unchoked.add(peer)
            await self._quiet_send(peer.send_message(wire.MSG_UNCHOKE))
        self._served_window = {}

    async def _maybe_decrypt(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter):
        """Sniff the first bytes: plaintext BT handshake passes through
        (with the consumed prefix replayed), anything else must complete
        the MSE accept handshake.  ``crypto="require"`` refuses the
        plaintext path entirely (libtorrent's require posture: drop
        unencrypted inbound, review r5) and forces RC4 in the MSE
        negotiation."""
        first = b""
        verdict = None
        async with asyncio.timeout(mse.HANDSHAKE_TIMEOUT):
            while verdict is None:
                first += await reader.readexactly(1)
                verdict = mse.looks_like_plaintext_bt(first)
        require_rc4 = self.crypto == "require"
        if verdict:
            if require_rc4:
                raise mse.MSEError("plaintext peer refused (crypto=require)")
            return mse.MSEReader(reader, None, plain_prefix=first), writer
        enc_reader, enc_writer, _method = await mse.accept(
            reader, writer, self.meta.info_hash, first_bytes=first,
            allow_plaintext=not require_rc4,
            prefer_plaintext=not require_rc4,
        )
        return enc_reader, enc_writer

    async def _on_connect(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        # MSE/PE auto-detect (mse.py): a plaintext BitTorrent handshake
        # starts \x13"BitTorrent protocol"; anything else is treated as an
        # incoming MSE exchange.  Both kinds of peer are served.
        try:
            reader, writer = await self._maybe_decrypt(reader, writer)
        except (mse.MSEError, ConnectionError, OSError,
                asyncio.IncompleteReadError, TimeoutError):
            writer.close()
            return
        peer = wire.PeerWire(reader, writer)
        try:
            handshake = await peer.recv_handshake()
            if handshake.info_hash != self.meta.info_hash:
                await peer.close()
                return
            self.connections += 1
            peer.supports_fast = handshake.supports_fast
            await peer.send_handshake(self.meta.info_hash, self.peer_id)
            if handshake.supports_extensions:
                await peer.send_ext_handshake(
                    metadata_size=len(self.meta.info_bytes)
                )
            # register BEFORE snapshotting the bitfield, with no await in
            # between: a piece verified mid-handshake is then either in the
            # bitfield or HAVE-broadcast (never silently missed), and the
            # broadcast task cannot run before the bitfield is buffered
            self._peers.add(peer)
            if handshake.supports_fast and self.have is None:
                await peer.send_have_all()  # BEP 6: 5 bytes, any piece count
            elif handshake.supports_fast and not self.have:
                await peer.send_have_none()
            else:
                await peer.send_bitfield(wire.build_bitfield(
                    self._have_indices(), self.meta.num_pieces
                ))
            await self._serve(peer)
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            self._peers.discard(peer)
            self._listen_addrs.pop(peer, None)
            self._interested.discard(peer)
            freed = peer in self._unchoked
            self._unchoked.discard(peer)
            self._served_window.pop(peer, None)
            if peer is self._optimistic:
                self._optimistic = None
            if freed and self._interested:
                # departure freed a seat: promote a waiting peer now
                # (background — this connection's teardown must not
                # block on other peers' writes)
                task = asyncio.create_task(self._recompute_chokes())
                self._conn_tasks.add(task)
                task.add_done_callback(self._conn_tasks.discard)
            await peer.close()

    async def _serve(self, peer: wire.PeerWire) -> None:
        while True:
            msg_id, payload = await peer.recv_message()
            if msg_id is None:
                continue
            if msg_id == wire.MSG_INTERESTED:
                self._interested.add(peer)
                # a free slot (regular or the optimistic seat) unchokes
                # immediately — small swarms never wait for a rotation
                if len(self._unchoked) < self.unchoke_slots + 1:
                    self._unchoked.add(peer)
                    await peer.send_message(wire.MSG_UNCHOKE)
            elif msg_id == wire.MSG_NOT_INTERESTED:
                self._interested.discard(peer)
                if peer is self._optimistic:
                    self._optimistic = None
                if peer in self._unchoked:
                    # a freed seat promotes a waiting peer NOW — idling
                    # capacity until the next rotation wastes up to
                    # rotate_interval of upload time (review r5); the
                    # recompute also chokes this no-longer-interested
                    # peer via the target diff
                    await self._recompute_chokes()
            elif msg_id == wire.MSG_REQUEST:
                index, begin, length = struct.unpack(">III", payload)
                if (index >= self.meta.num_pieces or length > (1 << 17)
                        or begin + length > self.meta.piece_size(index)):
                    # malformed geometry is a protocol violation from any
                    # peer — fast extension or not, disconnect (a polite
                    # reject would let a hostile peer spin forever)
                    raise wire.WireError("bad request")
                if peer not in self._unchoked:
                    # choked peers receive NO blocks (BEP 3: a choke
                    # voids the request queue; a peer requesting anyway
                    # is either racing our choke or abusive) — fast
                    # peers get an explicit reject, legacy peers are
                    # ignored per spec
                    if getattr(peer, "supports_fast", False):
                        await peer.send_reject_request(index, begin, length)
                    continue
                if not self._available(index):
                    # valid request for a piece we haven't advertised
                    # (or a race against an in-flight HAVE): BEP 6 lets
                    # us reject politely; legacy peers get dropped since
                    # serving would leak preallocated zeros as content
                    if getattr(peer, "supports_fast", False):
                        await peer.send_reject_request(index, begin, length)
                        continue
                    raise wire.WireError("bad request")
                data = self.storage.read(
                    index * self.meta.piece_length + begin, length
                )
                await peer.send_piece(index, begin, data)
                self.bytes_served += len(data)
                self._served_window[peer] = (
                    self._served_window.get(peer, 0) + len(data))
            elif msg_id == wire.MSG_EXTENDED:
                await self._serve_extended(peer, payload)
            # choke/have/bitfield/cancel from a leech need no reply here

    async def _serve_extended(self, peer: wire.PeerWire, payload: bytes) -> None:
        ext_id, body = payload[0], payload[1:]
        if ext_id == wire.EXT_HANDSHAKE_ID:
            peer.handle_ext_handshake(body)
            await self._register_pex(peer)
            return
        # ut_metadata request addressed to the id we advertised
        from .bencode import bdecode_prefix

        header, _consumed = bdecode_prefix(body)
        if header.get(b"msg_type") == wire.MD_REQUEST:
            piece = header[b"piece"]
            total = len(self.meta.info_bytes)
            start = piece * wire.METADATA_PIECE_SIZE
            if start >= total:
                await peer.send_metadata_reject(piece)
                return
            chunk = self.meta.info_bytes[start:start + wire.METADATA_PIECE_SIZE]
            await peer.send_metadata_data(piece, total, chunk)

    # -- peer exchange (BEP 11) -----------------------------------------
    async def _register_pex(self, peer: wire.PeerWire) -> None:
        """After a peer's extended handshake: tell it about the swarm, and
        gossip its listen address (if advertised) to everyone else."""
        known = [a for p, a in self._listen_addrs.items() if p is not peer]
        if known and peer.peer_ut_pex is not None:
            try:
                await peer.send_pex(known)
            except (ConnectionError, OSError, wire.WireError):
                return
        if peer.peer_listen_port is None:
            return
        host = peer.writer.get_extra_info("peername")
        if host is None:
            return
        addr = (host[0], peer.peer_listen_port)
        self._listen_addrs[peer] = addr
        for other in list(self._peers):
            if other is peer or other.peer_ut_pex is None:
                continue
            try:
                await other.send_pex([addr])
            except (ConnectionError, OSError, wire.WireError):
                pass
