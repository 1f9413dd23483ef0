"""BitTorrent peer wire protocol (BEP 3) + extension protocol (BEP 10) +
metadata exchange (BEP 9) + peer exchange (BEP 11).

One :class:`PeerWire` wraps an asyncio stream pair and is used by both sides:
the leeching client and the in-package seeder.
"""

from __future__ import annotations

import asyncio
import dataclasses
import socket
import struct
from typing import Iterable, List, Optional, Tuple

from .bencode import bdecode_prefix, bencode

PSTR = b"BitTorrent protocol"
# reserved byte 5, bit 0x10: extension protocol (BEP 10);
# reserved byte 7, bit 0x04: fast extension (BEP 6)
RESERVED = bytes([0, 0, 0, 0, 0, 0x10, 0, 0x04])

MSG_CHOKE = 0
MSG_UNCHOKE = 1
MSG_INTERESTED = 2
MSG_NOT_INTERESTED = 3
MSG_HAVE = 4
MSG_BITFIELD = 5
MSG_REQUEST = 6
MSG_PIECE = 7
MSG_CANCEL = 8
# BEP 6 fast extension
MSG_SUGGEST_PIECE = 13
MSG_HAVE_ALL = 14
MSG_HAVE_NONE = 15
MSG_REJECT_REQUEST = 16
MSG_ALLOWED_FAST = 17
MSG_EXTENDED = 20

EXT_HANDSHAKE_ID = 0
UT_METADATA = b"ut_metadata"
UT_PEX = b"ut_pex"
METADATA_PIECE_SIZE = 1 << 14

# ut_metadata msg_type values (BEP 9)
MD_REQUEST = 0
MD_DATA = 1
MD_REJECT = 2

MAX_MESSAGE = 1 << 21  # sanity bound: piece messages are ~16 KiB + header


class WireError(ConnectionError):
    pass


@dataclasses.dataclass
class Handshake:
    info_hash: bytes
    peer_id: bytes
    supports_extensions: bool
    supports_fast: bool = False


class PeerWire:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        # negotiated extension ids: ours (what we told the peer) and theirs
        self.our_ut_metadata = 1
        self.our_ut_pex = 2
        self.peer_ut_metadata: Optional[int] = None
        self.peer_ut_pex: Optional[int] = None
        self.peer_metadata_size: Optional[int] = None
        # the peer's advertised listen port (``p`` in the BEP 10 handshake)
        self.peer_listen_port: Optional[int] = None

    # -- handshake ------------------------------------------------------
    async def send_handshake(self, info_hash: bytes, peer_id: bytes) -> None:
        self.writer.write(
            bytes([len(PSTR)]) + PSTR + RESERVED + info_hash + peer_id
        )
        await self.writer.drain()

    async def recv_handshake(self) -> Handshake:
        header = await self.reader.readexactly(1)
        pstrlen = header[0]
        pstr = await self.reader.readexactly(pstrlen)
        if pstr != PSTR:
            raise WireError(f"unknown protocol {pstr!r}")
        reserved = await self.reader.readexactly(8)
        info_hash = await self.reader.readexactly(20)
        peer_id = await self.reader.readexactly(20)
        return Handshake(
            info_hash=info_hash,
            peer_id=peer_id,
            supports_extensions=bool(reserved[5] & 0x10),
            supports_fast=bool(reserved[7] & 0x04),
        )

    # -- framing --------------------------------------------------------
    async def send_message(self, msg_id: int, payload: bytes = b"") -> None:
        frame = struct.pack(">IB", len(payload) + 1, msg_id) + payload
        self.writer.write(frame)
        await self.writer.drain()

    async def send_keepalive(self) -> None:
        self.writer.write(b"\x00\x00\x00\x00")
        await self.writer.drain()

    async def recv_message(self) -> Tuple[Optional[int], bytes]:
        """Returns (msg_id, payload); (None, b'') for a keep-alive."""
        raw_len = await self.reader.readexactly(4)
        (length,) = struct.unpack(">I", raw_len)
        if length == 0:
            return None, b""
        if length > MAX_MESSAGE:
            raise WireError(f"oversized message ({length} bytes)")
        body = await self.reader.readexactly(length)
        return body[0], body[1:]

    # -- core messages --------------------------------------------------
    async def send_bitfield(self, have: "bytes") -> None:
        await self.send_message(MSG_BITFIELD, have)

    async def send_request(self, index: int, begin: int, length: int) -> None:
        await self.send_message(MSG_REQUEST, struct.pack(">III", index, begin, length))

    async def send_cancel(self, index: int, begin: int, length: int) -> None:
        await self.send_message(MSG_CANCEL, struct.pack(">III", index, begin, length))

    async def send_piece(self, index: int, begin: int, data: bytes) -> None:
        await self.send_message(MSG_PIECE, struct.pack(">II", index, begin) + data)

    async def send_have(self, index: int) -> None:
        await self.send_message(MSG_HAVE, struct.pack(">I", index))

    # -- fast extension (BEP 6) -----------------------------------------
    async def send_have_all(self) -> None:
        await self.send_message(MSG_HAVE_ALL)

    async def send_have_none(self) -> None:
        await self.send_message(MSG_HAVE_NONE)

    async def send_reject_request(self, index: int, begin: int,
                                  length: int) -> None:
        await self.send_message(
            MSG_REJECT_REQUEST, struct.pack(">III", index, begin, length)
        )

    # -- extension protocol ---------------------------------------------
    async def send_ext_handshake(self, metadata_size: Optional[int] = None,
                                 listen_port: Optional[int] = None) -> None:
        payload: dict = {b"m": {
            UT_METADATA: self.our_ut_metadata,
            UT_PEX: self.our_ut_pex,
        }}
        if metadata_size is not None:
            payload[b"metadata_size"] = metadata_size
        if listen_port is not None:
            payload[b"p"] = listen_port
        await self.send_message(
            MSG_EXTENDED, bytes([EXT_HANDSHAKE_ID]) + bencode(payload)
        )

    def handle_ext_handshake(self, payload: bytes) -> None:
        data, _ = bdecode_prefix(payload)
        m = data.get(b"m", {})
        if UT_METADATA in m:
            self.peer_ut_metadata = m[UT_METADATA]
        if UT_PEX in m:
            self.peer_ut_pex = m[UT_PEX]
        if b"metadata_size" in data:
            self.peer_metadata_size = data[b"metadata_size"]
        port = data.get(b"p")
        if isinstance(port, int) and 0 < port < 65536:
            self.peer_listen_port = port

    async def send_metadata_request(self, piece: int) -> None:
        if self.peer_ut_metadata is None:
            raise WireError("peer does not support ut_metadata")
        msg = bencode({b"msg_type": MD_REQUEST, b"piece": piece})
        await self.send_message(
            MSG_EXTENDED, bytes([self.peer_ut_metadata]) + msg
        )

    def _their_ut_metadata(self) -> int:
        # BEP 10: outgoing extended messages use the id the RECEIVER
        # advertised in its handshake; fall back to ours for peers that
        # requested before handshaking
        return self.peer_ut_metadata or self.our_ut_metadata

    async def send_metadata_data(self, piece: int, total_size: int, data: bytes) -> None:
        header = bencode(
            {b"msg_type": MD_DATA, b"piece": piece, b"total_size": total_size}
        )
        await self.send_message(
            MSG_EXTENDED, bytes([self._their_ut_metadata()]) + header + data
        )

    async def send_metadata_reject(self, piece: int) -> None:
        msg = bencode({b"msg_type": MD_REJECT, b"piece": piece})
        await self.send_message(
            MSG_EXTENDED, bytes([self._their_ut_metadata()]) + msg
        )

    # -- peer exchange (BEP 11) -----------------------------------------
    async def send_pex(self, added: Iterable[Tuple[str, int]],
                       dropped: Iterable[Tuple[str, int]] = ()) -> None:
        if self.peer_ut_pex is None:
            raise WireError("peer does not support ut_pex")
        msg = bencode({
            b"added": pack_compact_peers(added),
            b"added.f": b"",
            b"dropped": pack_compact_peers(dropped),
        })
        await self.send_message(
            MSG_EXTENDED, bytes([self.peer_ut_pex]) + msg
        )

    async def close(self) -> None:
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except (ConnectionError, OSError):
            pass


def parse_bitfield(payload: bytes, num_pieces: int) -> set:
    have = set()
    for i in range(num_pieces):
        if payload[i // 8] & (0x80 >> (i % 8)):
            have.add(i)
    return have


def build_bitfield(have, num_pieces: int) -> bytes:
    out = bytearray((num_pieces + 7) // 8)
    for i in have:
        out[i // 8] |= 0x80 >> (i % 8)
    return bytes(out)


def pack_compact_peers(addrs: Iterable[Tuple[str, int]]) -> bytes:
    """IPv4 (host, port) pairs -> BEP 11/23 compact 6-byte entries.
    Non-IPv4 hosts are skipped on the send side (we gossip only ``added``;
    incoming ``added6`` is parsed by :func:`parse_pex`)."""
    out = bytearray()
    for host, port in addrs:
        try:
            out += socket.inet_aton(host) + struct.pack(">H", port)
        except OSError:
            continue
    return bytes(out)


def parse_pex(body: bytes) -> List[Tuple[str, int]]:
    """Extract usable (host, port) peers from a ut_pex message body
    (both the IPv4 ``added`` and IPv6 ``added6`` lists — same compact
    forms as tracker responses, so the tracker module's parsers own the
    decode)."""
    from .tracker import parse_compact_peers, parse_compact_peers6

    data, _ = bdecode_prefix(body)
    if not isinstance(data, dict):  # untrusted wire bytes
        return []
    out: List[Tuple[str, int]] = []
    added = data.get(b"added", b"")
    if isinstance(added, bytes):
        out.extend((p.host, p.port) for p in parse_compact_peers(added))
    added6 = data.get(b"added6", b"")
    if isinstance(added6, bytes):
        out.extend((p.host, p.port) for p in parse_compact_peers6(added6))
    return out
