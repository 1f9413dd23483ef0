"""Mainline DHT (BEP 5): trackerless peer discovery over KRPC/UDP.

The reference's webtorrent client discovers peers through the mainline DHT
in addition to trackers (upstream lib/download.js:19,64 — webtorrent
bundles ``bittorrent-dht``).  This module is a from-scratch asyncio
implementation of the same protocol:

- a KRPC node (bencoded queries/responses over UDP) answering ``ping``,
  ``find_node``, ``get_peers`` and ``announce_peer``
- a k-bucket routing table (k=8) over the 160-bit XOR metric
- iterative lookups (``alpha``-parallel) for ``get_peers``
- write-token validation for ``announce_peer`` (rotating HMAC secret,
  tokens accepted for up to ~10 minutes per BEP 5)
- a bounded per-infohash peer store for the server side

The torrent client uses :meth:`DHTNode.get_peers` as an additional peer
source next to tracker announces, covering magnets with no (or dead)
trackers.  :meth:`DHTNode.announce` is the write side: the client calls it
(best-effort) once its seed-while-leech listen socket is up, registering
that socket so other DHT nodes can find and leech from it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import hmac
import os
import socket
import struct
import time
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .bencode import bdecode, bencode
from .tracker import Peer, parse_compact_peers

K = 8                    # bucket size / closest-set size (BEP 5)
ALPHA = 3                # lookup concurrency
QUERY_TIMEOUT = 3.0      # per-query UDP timeout
LOOKUP_DEADLINE = 20.0   # hard wall-clock bound on one iterative lookup
MAX_LOOKUP_QUERIES = 64  # hard bound on nodes contacted per lookup
TOKEN_ROTATE_S = 300.0   # secret rotation period; previous secret stays valid
MAX_PEERS_PER_HASH = 256
MAX_STORED_HASHES = 1024


class DHTError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class NodeInfo:
    node_id: bytes
    host: str
    port: int

    @property
    def addr(self) -> Tuple[str, int]:
        return (self.host, self.port)


def xor_distance(a: bytes, b: bytes) -> int:
    return int.from_bytes(a, "big") ^ int.from_bytes(b, "big")


def pack_nodes(nodes: Iterable[NodeInfo]) -> bytes:
    """BEP 5 compact node info: 20-byte id + 4-byte IP + 2-byte port each."""
    out = bytearray()
    for node in nodes:
        try:
            ip = socket.inet_aton(node.host)
        except OSError:
            continue  # non-IPv4 (e.g. hostname): not representable
        out += node.node_id + ip + struct.pack(">H", node.port)
    return bytes(out)


def unpack_nodes(blob: bytes) -> List[NodeInfo]:
    nodes = []
    for off in range(0, len(blob) - len(blob) % 26, 26):
        node_id = blob[off:off + 20]
        host = socket.inet_ntoa(blob[off + 20:off + 24])
        (port,) = struct.unpack(">H", blob[off + 24:off + 26])
        if port:
            nodes.append(NodeInfo(node_id, host, port))
    return nodes


def pack_peers(peers: Iterable[Tuple[str, int]]) -> List[bytes]:
    """BEP 5 ``values``: list of 6-byte compact peer addresses."""
    out = []
    for host, port in peers:
        try:
            ip = socket.inet_aton(host)
        except OSError:
            continue
        out.append(ip + struct.pack(">H", port))
    return out


def unpack_peers(values: Iterable[bytes]) -> List[Peer]:
    """BEP 5 ``values`` (list of 6-byte compact addresses) -> peers.

    Delegates the per-entry decoding to the tracker module's
    :func:`~.tracker.parse_compact_peers` so all compact-peer surfaces
    (HTTP/UDP tracker, DHT) share one parser.
    """
    peers: List[Peer] = []
    for blob in values:
        if isinstance(blob, bytes) and len(blob) == 6:
            peers.extend(parse_compact_peers(blob))
    return peers


class RoutingTable:
    """k-bucket table over the XOR metric.

    Buckets are indexed by the position of the highest differing bit from
    our own id (i.e. shared-prefix length), each holding at most ``K``
    nodes, least-recently-seen first.  Full buckets drop new nodes unless a
    stale resident can be evicted — the standard BEP 5 policy favoring
    long-lived nodes.
    """

    def __init__(self, own_id: bytes, k: int = K):
        self.own_id = own_id
        self.k = k
        self.buckets: List[List[NodeInfo]] = [[] for _ in range(160)]
        self.last_seen: Dict[bytes, float] = {}

    def _bucket_index(self, node_id: bytes) -> int:
        dist = xor_distance(self.own_id, node_id)
        if dist == 0:
            return 0
        return 160 - dist.bit_length()

    def add(self, node: NodeInfo) -> None:
        if node.node_id == self.own_id or len(node.node_id) != 20:
            return
        bucket = self.buckets[self._bucket_index(node.node_id)]
        for i, existing in enumerate(bucket):
            if existing.node_id == node.node_id:
                # move to tail (most recently seen), refresh address
                bucket.pop(i)
                bucket.append(node)
                self.last_seen[node.node_id] = time.monotonic()
                return
        if len(bucket) < self.k:
            bucket.append(node)
            self.last_seen[node.node_id] = time.monotonic()
            return
        # full: evict the least-recently-seen node if it has gone quiet
        oldest = bucket[0]
        if time.monotonic() - self.last_seen.get(oldest.node_id, 0) > 15 * 60:
            self.last_seen.pop(oldest.node_id, None)
            bucket.pop(0)
            bucket.append(node)
            self.last_seen[node.node_id] = time.monotonic()

    def remove(self, node_id: bytes) -> None:
        bucket = self.buckets[self._bucket_index(node_id)]
        for i, existing in enumerate(bucket):
            if existing.node_id == node_id:
                bucket.pop(i)
                self.last_seen.pop(node_id, None)
                return

    def closest(self, target: bytes, count: int = K) -> List[NodeInfo]:
        everyone = [n for bucket in self.buckets for n in bucket]
        everyone.sort(key=lambda n: xor_distance(n.node_id, target))
        return everyone[:count]

    def __len__(self) -> int:
        return sum(len(b) for b in self.buckets)


class _Protocol(asyncio.DatagramProtocol):
    def __init__(self, node: "DHTNode"):
        self.node = node
        self.transport: Optional[asyncio.DatagramTransport] = None

    def connection_made(self, transport) -> None:
        self.transport = transport

    def datagram_received(self, data: bytes, addr) -> None:
        self.node._on_datagram(data, addr)


class DHTNode:
    """One mainline-DHT participant: client (lookups) + server (storage)."""

    def __init__(self, node_id: Optional[bytes] = None, logger=None):
        self.node_id = node_id or os.urandom(20)
        self.logger = logger
        self.table = RoutingTable(self.node_id)
        self.transport: Optional[asyncio.DatagramTransport] = None
        # txn -> (future, addr the query was sent to)
        self._pending: Dict[bytes, Tuple[asyncio.Future, Tuple[str, int]]] = {}
        self._secret = os.urandom(16)
        self._prev_secret = self._secret
        self._secret_rotated = time.monotonic()
        # info_hash -> {(host, port): announced_at}
        self._peer_store: Dict[bytes, Dict[Tuple[str, int], float]] = {}

    # -- lifecycle -------------------------------------------------------
    async def start(self, host: str = "0.0.0.0", port: int = 0) -> None:
        loop = asyncio.get_running_loop()
        self.transport, _ = await loop.create_datagram_endpoint(
            lambda: _Protocol(self), local_addr=(host, port)
        )

    @property
    def port(self) -> int:
        if self.transport is None:
            raise DHTError("node not started")
        return self.transport.get_extra_info("sockname")[1]

    async def close(self) -> None:
        if self.transport is not None:
            self.transport.close()
            self.transport = None
        for fut, _addr in self._pending.values():
            if not fut.done():
                fut.cancel()
        self._pending.clear()

    # -- routing-table persistence ---------------------------------------
    def dump_nodes(self, limit: int = 200) -> List[Tuple[str, int]]:
        """Known-good node addresses, most-recently-seen first — feed them
        back into :meth:`bootstrap` on the next start so a restarted
        service rejoins the DHT without waiting on the public routers."""
        nodes = [
            node for bucket in self.table.buckets for node in bucket
        ]
        nodes.sort(
            key=lambda n: self.table.last_seen.get(n.node_id, 0.0),
            reverse=True,
        )
        return [(n.host, n.port) for n in nodes[:limit]]

    def save_nodes(self, path: str) -> int:
        """Persist :meth:`dump_nodes` as JSON; returns the count saved."""
        import json

        nodes = self.dump_nodes()
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(nodes, fh)
        os.replace(tmp, path)
        return len(nodes)

    @staticmethod
    def load_nodes(path: str) -> List[Tuple[str, int]]:
        """Addresses previously saved with :meth:`save_nodes`; empty on
        any problem (a corrupt cache must not block bootstrap)."""
        import json

        try:
            with open(path, "r", encoding="utf-8") as fh:
                raw = json.load(fh)
            return [
                (str(host), int(port))
                for host, port in raw
                if 0 < int(port) < 65536
            ]
        except (OSError, ValueError, TypeError):
            return []

    async def bootstrap(self, nodes: Iterable[Tuple[str, int]]) -> int:
        """Ping the given routers and walk toward our own id to fill the
        table.  Returns the resulting routing-table size."""
        async def _ping(addr) -> None:
            try:
                await self._query(addr, b"ping", {})
            except (DHTError, asyncio.TimeoutError, OSError):
                pass

        # independent UDP round-trips: ping in parallel so dead routers
        # don't serialize their timeouts (this also runs under the
        # cross-job dht lock in the download stage)
        await asyncio.gather(*(_ping(addr) for addr in nodes))
        if len(self.table):
            await self._lookup(self.node_id, want_peers=False)
        return len(self.table)

    # -- public API ------------------------------------------------------
    async def get_peers(self, info_hash: bytes) -> List[Peer]:
        """Iterative BEP 5 lookup: returns peers announced for ``info_hash``."""
        peers, _ = await self._lookup(info_hash, want_peers=True)
        return peers

    async def announce(self, info_hash: bytes, port: int) -> int:
        """Announce ourselves as a peer for ``info_hash``.

        Runs a get_peers lookup to collect write tokens, then sends
        announce_peer to the closest responding nodes.  Returns the number
        of successful announces.
        """
        _, closest = await self._lookup(info_hash, want_peers=True)
        ok = 0
        for node, token in closest[:K]:
            if token is None:
                continue
            try:
                await self._query(node.addr, b"announce_peer", {
                    b"info_hash": info_hash,
                    b"port": port,
                    b"token": token,
                    b"implied_port": 0,
                })
                ok += 1
            except (DHTError, asyncio.TimeoutError, OSError):
                continue
        return ok

    # -- iterative lookup ------------------------------------------------
    async def _lookup(
        self, target: bytes, want_peers: bool
    ) -> Tuple[List[Peer], List[Tuple[NodeInfo, Optional[bytes]]]]:
        """Converging alpha-parallel lookup toward ``target``.

        Terminates on the standard Kademlia rule — the ``K`` closest nodes
        seen have all been queried (no unqueried candidate is closer than
        the current K-th closest response) — with hard caps on wall-clock
        (``LOOKUP_DEADLINE``) and total nodes contacted
        (``MAX_LOOKUP_QUERIES``) so a big or adversarial network can never
        hang a download: the caller sits outside the torrent stall
        watchdog.

        Returns (peers found, [(responding node, its write token)] sorted by
        distance to target).
        """
        shortlist: Dict[bytes, NodeInfo] = {
            n.node_id: n for n in self.table.closest(target, K)
        }
        queried: Set[Tuple[str, int]] = set()
        tokens: Dict[bytes, Optional[bytes]] = {}
        responded: Dict[bytes, NodeInfo] = {}
        peers: Dict[Tuple[str, int], Peer] = {}
        deadline = time.monotonic() + LOOKUP_DEADLINE

        while time.monotonic() < deadline and len(queried) < MAX_LOOKUP_QUERIES:
            candidates = sorted(
                (n for n in shortlist.values() if n.addr not in queried),
                key=lambda n: xor_distance(n.node_id, target),
            )[:ALPHA]
            if not candidates:
                break
            if len(responded) >= K:
                kth_best = sorted(
                    xor_distance(node_id, target) for node_id in responded
                )[K - 1]
                if xor_distance(candidates[0].node_id, target) >= kth_best:
                    break  # converged: nothing unqueried can improve the top K
            for node in candidates:
                queried.add(node.addr)

            async def _ask(node: NodeInfo):
                method = b"get_peers" if want_peers else b"find_node"
                args = (
                    {b"info_hash": target} if want_peers
                    else {b"target": target}
                )
                try:
                    resp = await self._query(node.addr, method, args)
                except (DHTError, asyncio.TimeoutError, OSError):
                    return
                node_id = resp.get(b"id", node.node_id)
                if not (isinstance(node_id, bytes) and len(node_id) == 20):
                    # untrusted wire data: a non-bytes/odd-length id would
                    # blow up xor_distance below — fall back to what we knew
                    node_id = node.node_id
                info = NodeInfo(node_id, node.host, node.port)
                responded[node_id] = info
                tokens[node_id] = resp.get(b"token")
                for peer in unpack_peers(resp.get(b"values", [])):
                    peers[(peer.host, peer.port)] = peer
                for found in unpack_nodes(resp.get(b"nodes", b"")):
                    shortlist.setdefault(found.node_id, found)

            await asyncio.gather(*(_ask(n) for n in candidates))

        ranked = sorted(
            responded.values(), key=lambda n: xor_distance(n.node_id, target)
        )
        return list(peers.values()), [
            (n, tokens.get(n.node_id)) for n in ranked
        ]

    # -- KRPC client -----------------------------------------------------
    def _next_txn(self) -> bytes:
        # random (not sequential) so off-path attackers can't predict the
        # next transaction id and forge responses
        while True:
            txn = os.urandom(2)
            if txn not in self._pending:
                return txn

    async def _query(self, addr: Tuple[str, int], method: bytes,
                     args: dict) -> dict:
        if self.transport is None:
            raise DHTError("node not started")
        addr = await self._resolve_addr(addr)
        txn = self._next_txn()
        payload = dict(args)
        payload[b"id"] = self.node_id
        msg = bencode({b"t": txn, b"y": b"q", b"q": method, b"a": payload})
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # remember who we asked: responses are only accepted from that addr
        self._pending[txn] = (fut, addr)
        try:
            self.transport.sendto(msg, addr)
            async with asyncio.timeout(QUERY_TIMEOUT):
                resp = await fut
        except TimeoutError:
            raise asyncio.TimeoutError(f"DHT query to {addr} timed out")
        finally:
            self._pending.pop(txn, None)
        node_id = resp.get(b"id")
        if isinstance(node_id, bytes) and len(node_id) == 20:
            self.table.add(NodeInfo(node_id, addr[0], addr[1]))
        return resp

    @staticmethod
    async def _resolve_addr(addr: Tuple[str, int]) -> Tuple[str, int]:
        """Hostname -> literal IP, so reply-source matching works (datagram
        sources always arrive as literal addresses)."""
        try:
            socket.inet_aton(addr[0])
            return addr
        except OSError:
            pass
        infos = await asyncio.get_running_loop().getaddrinfo(
            addr[0], addr[1], type=socket.SOCK_DGRAM, family=socket.AF_INET
        )
        return infos[0][4][0], addr[1]

    # -- KRPC server -----------------------------------------------------
    def _on_datagram(self, data: bytes, addr) -> None:
        try:
            msg = bdecode(data)
        except ValueError:
            return
        if not isinstance(msg, dict):
            return
        kind = msg.get(b"y")
        if kind == b"r":
            self._on_response(msg, addr)
        elif kind == b"q":
            try:
                self._on_query(msg, addr)
            except Exception as err:  # malformed queries must not kill the loop
                self._log("dht query handling failed", error=str(err))
        elif kind == b"e":
            fut = self._match_pending(msg, addr)
            if fut is not None:
                err = msg.get(b"e", [201, b"error"])
                fut.set_exception(DHTError(f"remote error {err!r}"))

    def _match_pending(self, msg: dict, addr) -> Optional[asyncio.Future]:
        """Resolve a reply to its pending query — only if the source address
        matches where the query went (BEP 5 forgery defence)."""
        txn = msg.get(b"t")
        entry = self._pending.get(txn) if isinstance(txn, bytes) else None
        if entry is None:
            return None
        fut, queried_addr = entry
        if (addr[0], addr[1]) != queried_addr:
            self._log("dht reply from unexpected address dropped",
                      expected=str(queried_addr), got=str(addr))
            return None
        return fut if not fut.done() else None

    def _on_response(self, msg: dict, addr) -> None:
        fut = self._match_pending(msg, addr)
        if fut is None:
            return
        resp = msg.get(b"r")
        if isinstance(resp, dict):
            fut.set_result(resp)
        else:
            fut.set_exception(DHTError("malformed response"))

    def _on_query(self, msg: dict, addr) -> None:
        if self.transport is None:
            return
        txn = msg.get(b"t", b"")
        method = msg.get(b"q")
        args = msg.get(b"a", {})
        if not isinstance(args, dict):
            args = {}
        sender_id = args.get(b"id")
        if isinstance(sender_id, bytes) and len(sender_id) == 20:
            self.table.add(NodeInfo(sender_id, addr[0], addr[1]))

        def reply(body: dict) -> None:
            body[b"id"] = self.node_id
            self.transport.sendto(
                bencode({b"t": txn, b"y": b"r", b"r": body}), addr
            )

        def error(code: int, text: str) -> None:
            self.transport.sendto(
                bencode({b"t": txn, b"y": b"e",
                         b"e": [code, text.encode()]}), addr
            )

        if method == b"ping":
            reply({})
        elif method == b"find_node":
            target = args.get(b"target", b"")
            reply({b"nodes": pack_nodes(self.table.closest(target, K))})
        elif method == b"get_peers":
            info_hash = args.get(b"info_hash", b"")
            body: dict = {b"token": self._make_token(addr)}
            stored = self._peer_store.get(info_hash)
            if stored:
                body[b"values"] = pack_peers(stored.keys())
            else:
                body[b"nodes"] = pack_nodes(self.table.closest(info_hash, K))
            reply(body)
        elif method == b"announce_peer":
            token = args.get(b"token", b"")
            if not self._check_token(addr, token):
                error(203, "bad token")
                return
            info_hash = args.get(b"info_hash", b"")
            if not isinstance(info_hash, bytes) or len(info_hash) != 20:
                error(203, "bad info_hash")
                return
            port = args.get(b"port", 0)
            if args.get(b"implied_port"):
                port = addr[1]
            if not isinstance(port, int) or not (0 < port < 65536):
                error(203, "bad port")
                return
            self._store_peer(info_hash, (addr[0], port))
            reply({})
        else:
            error(204, "method unknown")

    # -- tokens (BEP 5: opaque write token bound to requester IP) --------
    def _rotate_secrets(self) -> None:
        now = time.monotonic()
        elapsed = now - self._secret_rotated
        if elapsed > 2 * TOKEN_ROTATE_S:
            # idle gap longer than a full rotation cycle: a single-step
            # rotation would keep arbitrarily old tokens valid via
            # _prev_secret — retire both secrets outright
            self._secret = os.urandom(16)
            self._prev_secret = self._secret
            self._secret_rotated = now
        elif elapsed > TOKEN_ROTATE_S:
            self._prev_secret = self._secret
            self._secret = os.urandom(16)
            self._secret_rotated = now

    def _make_token(self, addr) -> bytes:
        self._rotate_secrets()
        return hmac.new(
            self._secret, addr[0].encode(), hashlib.sha1
        ).digest()[:8]

    def _check_token(self, addr, token: bytes) -> bool:
        self._rotate_secrets()
        for secret in (self._secret, self._prev_secret):
            want = hmac.new(secret, addr[0].encode(), hashlib.sha1).digest()[:8]
            if isinstance(token, bytes) and hmac.compare_digest(token, want):
                return True
        return False

    # -- peer store ------------------------------------------------------
    def _store_peer(self, info_hash: bytes, peer: Tuple[str, int]) -> None:
        if (info_hash not in self._peer_store
                and len(self._peer_store) >= MAX_STORED_HASHES):
            return
        store = self._peer_store.setdefault(info_hash, {})
        store[peer] = time.monotonic()
        if len(store) > MAX_PEERS_PER_HASH:
            oldest = min(store, key=store.get)
            store.pop(oldest, None)

    def _log(self, msg: str, **extra) -> None:
        if self.logger is not None:
            self.logger.info(msg, **extra)


def parse_bootstrap(spec: str) -> List[Tuple[str, int]]:
    """``host:port,host:port`` -> [(host, port)] (config/env format)."""
    out: List[Tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        try:
            out.append((host, int(port)))
        except ValueError:
            raise DHTError(f"bad bootstrap node {part!r}") from None
    return out
