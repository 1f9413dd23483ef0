"""The leeching client: magnet/.torrent -> files on disk.

Behavioral parity with the reference's webtorrent wrapper
(upstream lib/download.js:43-123):

- accepts magnet URIs, ``.torrent`` URLs, and local ``.torrent`` paths
  (the http method chains ``.torrent`` URLs here, lib/download.js:144-155)
- 240 s metadata timeout -> ``Metadata fetch stalled``
  (lib/download.js:47-50)
- 240 s no-progress watchdog -> error with ``code == 'ERRDLSTALL'``
  (lib/download.js:90-101)
- progress callback on a 30 s cadence (lib/download.js:78-88)
- resumes from pieces already on disk (webtorrent reuses ``downloadPath``
  contents; SURVEY.md §5 "checkpoint/resume")
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import random
import struct
from collections import Counter, deque
from typing import Awaitable, Callable, Dict, List, Optional, Set

import aiohttp

from ..utils.watchdog import MetadataTimeoutError, StallWatchdog
from . import mse
from . import resume as resume_mod
from . import tracker as tracker_mod
from . import utp
from . import wire
from .magnet import parse_magnet
from .metainfo import BLOCK_SIZE, Metainfo, parse_info_dict, parse_torrent_bytes
from .storage import TorrentStorage

ProgressCb = Callable[[float], Awaitable[None]]


class _MSERejected(Exception):
    """Internal marker: the MSE exchange itself failed (fallback-eligible).

    Carries the underlying error so "require" mode and exhausted retries
    re-raise the real cause."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause

CONNECT_TIMEOUT = 10.0
# outstanding 16 KiB requests per peer: 64 = 1 MiB in flight, measured
# fastest on the loopback swarm (sweep: 64 > 32 > 128 > 16) and in line
# with what mainstream clients keep queued
PIPELINE_DEPTH = 64
MAX_PEERS = 8
# biggest file we'll accept from a webseed that ignores Range requests —
# without ranges every piece re-streams the file prefix (quadratic)
WEBSEED_NO_RANGE_MAX = 32 << 20
# worker/session cap, like MAX_PEERS — a hostile url-list must not be able
# to spawn one task + HTTP session per entry
MAX_WEBSEEDS = 4
# pieces a peer worker assembles concurrently: claiming the next piece
# before the current one's tail blocks land keeps the request pipeline
# full across piece boundaries
MAX_ACTIVE_CLAIMS = 2


class _Assembly:
    """In-flight piece reassembly for one (worker, piece)."""

    __slots__ = ("buffer", "received", "requested", "rejects", "pending")

    def __init__(self, size: int):
        self.buffer = bytearray(size)
        self.received: Set[int] = set()
        self.requested: Set[int] = set()
        # unchoked REJECT_REQUEST counts per block (BEP 6)
        self.rejects: dict = {}
        # block offsets not yet requested, in order — the pump pops from
        # here (O(1) per request) instead of rescanning every block
        self.pending = deque(range(0, size, BLOCK_SIZE))

    def requeue(self, begin: int) -> None:
        """A request for ``begin`` was lost (reject): offer it again.

        Only offsets we actually requested re-enter the queue — a forged
        reject for a bogus offset must not reach the pump (a negative
        computed length would kill the connection; a misaligned one would
        wedge the piece)."""
        if begin not in self.requested:
            return
        self.requested.discard(begin)
        if begin not in self.received:
            self.pending.append(begin)

    def rebuild_pending(self) -> None:
        """After a choke wiped the peer's request queue: everything not
        yet received must be re-requested."""
        self.requested &= self.received
        size = len(self.buffer)
        self.pending = deque(
            b for b in range(0, size, BLOCK_SIZE)
            if b not in self.received
        )


class TorrentError(RuntimeError):
    pass


class _FileCompletion:
    """Per-file piece accounting: which files just became fully durable.

    A file is durable once every piece overlapping its byte range is
    verified and written (each such piece's ``storage.write_piece`` —
    including the slice that lands in this file — happens before its
    ``finish``, and finished pieces are never rewritten, so no write can
    touch the file afterwards).  ``mark`` is O(files overlapping the
    piece); completed file indices queue in ``completed`` for the drive
    loop to drain into the caller's ``on_file_complete`` callback.
    """

    __slots__ = ("_left", "_by_piece", "completed")

    def __init__(self, meta: Metainfo):
        self._left: List[int] = []
        self._by_piece: Dict[int, List[int]] = {}
        self.completed: deque = deque()
        for index, entry in enumerate(meta.files):
            if entry.length == 0:
                self._left.append(0)
                self.completed.append(index)  # nothing to transfer
                continue
            first = entry.offset // meta.piece_length
            last = (entry.offset + entry.length - 1) // meta.piece_length
            for piece in range(first, last + 1):
                self._by_piece.setdefault(piece, []).append(index)
            self._left.append(last - first + 1)

    def mark(self, piece: int) -> None:
        """Record ``piece`` done; queues any file it completed."""
        for index in self._by_piece.pop(piece, ()):
            self._left[index] -= 1
            if self._left[index] == 0:
                self.completed.append(index)


class _Swarm:
    """Shared download state across peer workers.

    Piece selection is rarest-first (classic BitTorrent: pick the piece the
    fewest connected peers advertise, so rare pieces replicate before their
    holders leave), with piece index as the deterministic tie-break.  When
    every piece is either done or in flight, the swarm enters endgame mode
    (BEP 3): idle workers duplicate-request in-flight pieces so one slow
    peer cannot stall the tail of the download.
    """

    def __init__(self, meta: Metainfo):
        self.meta = meta
        self.pending: Set[int] = set(range(meta.num_pieces))
        self.claimed: Set[int] = set()
        self.done: Set[int] = set()
        self.bytes_done = 0
        self.piece_event = asyncio.Event()
        # piece index -> number of connected peers advertising it
        self.availability: Counter = Counter()
        self.endgame = False
        # ut_pex gossip: (host, port) addresses workers hear about
        self.discovered: asyncio.Queue = asyncio.Queue()
        # our serving socket, advertised to peers (BEP 10 ``p``)
        self.listen_port: Optional[int] = None
        # accounting for observability (surfaced via download(stats_out=))
        self.hash_failures = 0
        self.bytes_resumed = 0
        self.bytes_from_webseeds = 0
        # optional per-file completion tracker (download(on_file_complete=)):
        # finish() feeds it; the drive loop drains its queue
        self.completion: "Optional[_FileCompletion]" = None

    @property
    def complete(self) -> bool:
        return len(self.done) == self.meta.num_pieces

    def _rarest(self, candidates: Set[int]) -> int:
        return min(candidates, key=lambda p: (self.availability[p], p))

    def claim(self, have: Set[int]) -> Optional[int]:
        candidates = self.pending & have
        if candidates:
            piece = self._rarest(candidates)
            self.pending.discard(piece)
            self.claimed.add(piece)
            return piece
        if not self.pending and self.claimed:
            # endgame: everything is in flight — duplicate-request an
            # unfinished claimed piece this peer has (requests for it stay
            # live on both workers; the loser cancels on the finish event)
            in_flight = (self.claimed - self.done) & have
            if in_flight:
                self.endgame = True
                return self._rarest(in_flight)
        return None

    def release(self, piece: int) -> None:
        if piece in self.done:
            return  # endgame duplicate: another worker already finished it
        self.claimed.discard(piece)
        self.pending.add(piece)

    def finish(self, piece: int) -> bool:
        """Mark ``piece`` verified+written. False if it was already done
        (an endgame duplicate landed second — caller must not re-write)."""
        if piece in self.done:
            return False
        self.claimed.discard(piece)
        # a dying endgame duplicate may have release()d it back to pending
        # before the winner finished — don't let it be claimed again
        self.pending.discard(piece)
        self.done.add(piece)
        self.bytes_done += self.meta.piece_size(piece)
        if self.completion is not None:
            self.completion.mark(piece)
        self.piece_event.set()
        return True


class TorrentClient:
    def __init__(self, logger=None, peer_id: Optional[bytes] = None,
                 dht=None, rate_limiter=None, crypto: str = "prefer",
                 transport: str = "auto", tracker_retries: int = 1):
        """``dht`` is an optional started :class:`~.dht.DHTNode`; when set,
        it is queried as an additional peer source next to trackers (the
        reference's webtorrent does the same via bittorrent-dht,
        upstream lib/download.js:19,64).  ``rate_limiter`` is an
        optional token bucket (``await consume(n)``) charged for every
        payload byte received from peers and webseeds.

        ``crypto`` controls outgoing MSE/PE obfuscation (the reference's
        webtorrent transport negotiates the same handshake,
        lib/download.js:19): ``"prefer"`` (default) attempts the MSE
        handshake and falls back to plaintext against peers that reject
        it, ``"require"`` drops peers that won't encrypt, ``"plaintext"``
        never initiates MSE.  Incoming connections (the seeder) always
        auto-detect both.

        ``transport`` picks the outgoing dial: ``"auto"`` (default,
        webtorrent parity — it dials TCP and uTP, lib/download.js:19)
        tries TCP and falls back to uTP (BEP 29) on the same port;
        ``"tcp"`` / ``"utp"`` pin one transport.  Incoming connections
        accept both regardless (the seeder listens on TCP and UDP)."""
        if crypto not in ("plaintext", "prefer", "require"):
            raise ValueError(f"unknown crypto mode {crypto!r}")
        if transport not in ("tcp", "utp", "auto"):
            raise ValueError(f"unknown transport mode {transport!r}")
        self.crypto = crypto
        self.transport = transport
        self.logger = logger
        self.rate_limiter = rate_limiter
        self.peer_id = peer_id or (
            b"-DT0001-" + bytes(random.randrange(48, 58) for _ in range(12))
        )
        self.dht = dht
        # quick per-tracker retries of transient announce failures
        # (timeouts, 5xx, resets) — concurrent across trackers, so a
        # flaky tracker backs off without serializing the healthy ones
        # (platform/errors.py taxonomy; config ``retry.tracker``)
        self.tracker_retries = max(int(tracker_retries), 0)
        # lingering seed servers: info_hash -> (Seeder, expiry task)
        self._lingering: dict = {}

    def serving_port(self, info_hash: bytes) -> Optional[int]:
        """Port of the lingering seed server for ``info_hash``, if any."""
        entry = self._lingering.get(info_hash)
        return entry[0].port if entry else None

    @property
    def is_seeding(self) -> bool:
        """True while any post-download server is still lingering."""
        return bool(self._lingering)

    async def close(self) -> None:
        """Stop any servers still seeding past their download (webtorrent's
        ``client.destroy()`` analogue — the reference keeps one long-lived
        client whose torrents seed until removed, lib/download.js:19,103)."""
        for server, expiry, unregister in list(self._lingering.values()):
            expiry.cancel()
            await server.stop()
            await unregister()
        self._lingering.clear()

    # ------------------------------------------------------------------
    async def download(
        self,
        uri: str,
        download_path: str,
        *,
        metadata_timeout: float = 240.0,
        stall_timeout: float = 240.0,
        progress_interval: float = 30.0,
        on_progress: Optional[ProgressCb] = None,
        peers: Optional[List[tracker_mod.Peer]] = None,
        listen: bool = True,
        listen_host: str = "0.0.0.0",
        seed_linger: float = 0.0,
        stats_out: Optional[dict] = None,
        cancel=None,
        progress_sink=None,
        on_file_complete=None,
        extra_webseeds=None,
    ) -> Metainfo:
        """Fetch the torrent behind ``uri`` into ``download_path``.

        While downloading, verified pieces are served back to the swarm on
        a listen socket (seed-while-leech, like the reference's webtorrent:
        concurrent replicas staging the same torrent trade pieces instead
        of all hammering the origin).  ``listen=False`` disables serving.

        ``seed_linger`` keeps the serve socket up for that many seconds
        AFTER the download completes (in the background — this call still
        returns immediately), so sibling replicas mid-download don't lose
        their source; :meth:`close` reaps lingering servers early.

        ``cancel`` is an optional control-plane token
        (:class:`~..control.cancel.CancelToken`): the drive loop checks
        it between piece batches, so a cancelled job stops requesting
        pieces within one scheduling tick and unwinds through the same
        orderly teardown as any other drive error (fast-resume sidecar
        saved, workers gathered, storage closed).

        ``progress_sink`` is an optional callable fed the cumulative
        verified byte count on every watchdog feed — the download
        stage's live flight-recorder transfer counter rides it.

        ``on_file_complete`` is an optional ``async (path, FileEntry)``
        callback invoked — from the drive loop, between piece batches —
        the moment an individual file's bytes are durable (every piece
        overlapping it verified and written; finished pieces are never
        rewritten).  The streaming staging pipeline rides it to upload
        early files while later ones still download.  Resumed/already-
        on-disk files are announced too, so a redelivered job streams
        its whole inventory.

        ``extra_webseeds`` is an optional list of additional BEP 19
        HTTP(S) webseed base URLs, merged (de-duplicated) with the ones
        the magnet/metainfo already carries — the origin plane's
        webseed/HTTP-mirror equivalence: a torrent job's
        ``Download.mirrors`` become always-on HTTP origins for the same
        piece-verified content.
        """
        meta, peers = await self._resolve(uri, peers, metadata_timeout)
        self._log("metainfo resolved", name=meta.name, pieces=meta.num_pieces)

        storage = TorrentStorage(meta, download_path)
        await asyncio.to_thread(self._preflight_disk, storage)
        await asyncio.to_thread(storage.preallocate)
        swarm = _Swarm(meta)
        if on_file_complete is not None:
            # installed BEFORE any piece can finish so finish() feeds it;
            # resume-scanned pieces (added to done directly) are marked
            # right after the scan below
            swarm.completion = _FileCompletion(meta)
        await self._resume_from_disk(storage, swarm)
        if swarm.completion is not None:
            for piece in swarm.done:
                swarm.completion.mark(piece)

        if swarm.complete:
            self._log("all pieces already on disk")
            await self._drain_file_completions(swarm, storage,
                                               on_file_complete)
            # a hash-scan proved the data: record it so the NEXT restart
            # is stat-only
            await asyncio.to_thread(
                resume_mod.save_resume, storage.root, meta, set(swarm.done)
            )
            if stats_out is not None:
                stats_out.update(self._swarm_stats(swarm, None))
            if on_progress is not None:
                await on_progress(1.0)
            return meta

        webseeds = self._webseed_urls(uri, meta)
        for url in extra_webseeds or ():
            if url not in webseeds:
                webseeds.append(url)
        if not peers and not webseeds:
            raise TorrentError("no peers available")

        server = None
        if listen:
            from .seeder import Seeder

            # share swarm.done by reference: the serve side's availability
            # tracks verified pieces with no extra bookkeeping
            server = Seeder(meta, storage=storage, have=swarm.done,
                            peer_id=self.peer_id, crypto=self.crypto)
            try:
                swarm.listen_port = await server.start(host=listen_host)
                self._log("serving swarm", port=swarm.listen_port)
            except OSError as err:
                self._log("listen socket failed; leech-only", error=str(err))
                server = None

        watchdog = StallWatchdog(stall_timeout, on_feed=progress_sink)
        watchdog.feed(swarm.bytes_done)

        completed = False
        try:
            await watchdog.watch(
                self._drive(swarm, storage, peers or [], webseeds, server,
                            progress_interval, on_progress, watchdog,
                            cancel=cancel, on_file_complete=on_file_complete)
            )
            completed = True
            # close the live counter: a fast download can finish between
            # reporter ticks, and the final total must reach the sink
            watchdog.feed(swarm.bytes_done)
        finally:
            if server is not None:
                if completed and seed_linger > 0:
                    self._linger(meta, server, seed_linger,
                                 swarm.listen_port)
                else:
                    await server.stop()
            if stats_out is not None:
                stats_out.update(self._swarm_stats(swarm, server))
            # all writers are stopped (the drive's finally gathered them),
            # so file mtimes are final: record the verified bitfield for
            # fast resume — on success AND on orderly failure (a stalled
            # job the queue redelivers resumes instantly instead of
            # re-hashing everything it already fetched)
            await asyncio.to_thread(
                resume_mod.save_resume, storage.root, meta, set(swarm.done)
            )
            # release cached file handles; a lingering background seeder
            # sharing this storage just reopens lazily
            storage.close()

        if on_progress is not None:
            await on_progress(1.0)
        return meta

    @staticmethod
    def _preflight_disk(storage: TorrentStorage) -> None:
        """Fail fast with a clear error when the volume can't hold the
        torrent — losing a multi-GB transfer to ENOSPC at piece N is the
        worst way to find out.  ALLOCATED bytes count as resume credit:
        preallocation sparse-truncates files to full apparent size, so
        ``st_size`` would claim a crashed first attempt already holds
        everything and reduce this check to a no-op on every retry.
        """
        from ..utils.disk import allocated_bytes, ensure_disk_space

        have = sum(
            allocated_bytes(storage.file_path(entry.path))
            for entry in storage.meta.files
        )
        os.makedirs(storage.root, exist_ok=True)
        ensure_disk_space(storage.root, storage.meta.total_length - have)

    @staticmethod
    def _swarm_stats(swarm: _Swarm, server) -> dict:
        """Per-download accounting for the caller's metrics."""
        return {
            "pieces": len(swarm.done),
            "bytes_total": swarm.bytes_done,
            "bytes_resumed": swarm.bytes_resumed,
            "bytes_from_webseeds": swarm.bytes_from_webseeds,
            "bytes_from_peers": (swarm.bytes_done - swarm.bytes_resumed
                                 - swarm.bytes_from_webseeds),
            "hash_failures": swarm.hash_failures,
            "bytes_served": server.bytes_served if server is not None else 0,
        }

    def _linger(self, meta: Metainfo, server, seconds: float,
                port: int) -> None:
        """Keep ``server`` seeding for ``seconds`` in the background; when
        it stops, tell the trackers (event=stopped) so they stop handing
        out our now-dead address."""
        info_hash = meta.info_hash

        async def _unregister() -> None:
            try:
                async with asyncio.timeout(5.0):  # dead trackers: bounded
                    await self._announce_all(meta.trackers, info_hash,
                                             left=0, port=port,
                                             event="stopped")
            except Exception as err:  # best-effort
                self._log("tracker unregister failed", error=str(err))

        async def _expire() -> None:
            # the finally owns teardown so every exit — natural expiry,
            # close(), or replacement by a re-download's new server —
            # stops the socket and withdraws the tracker registration
            try:
                await asyncio.sleep(seconds)
            finally:
                await server.stop()
                await _unregister()
                entry = self._lingering.get(info_hash)
                if entry is not None and entry[0] is server:
                    self._lingering.pop(info_hash, None)

        old = self._lingering.pop(info_hash, None)
        if old is not None:
            old[1].cancel()  # its finally retires the old server
        self._lingering[info_hash] = (
            server, asyncio.create_task(_expire()), _unregister
        )

    async def _drain_file_completions(self, swarm: _Swarm,
                                      storage: TorrentStorage,
                                      on_file_complete) -> None:
        """Announce files whose last piece just landed (download(
        on_file_complete=)); callback errors propagate like any other
        drive error so a broken consumer fails the download loudly."""
        completion = swarm.completion
        if completion is None or on_file_complete is None:
            return
        while completion.completed:
            index = completion.completed.popleft()
            entry = swarm.meta.files[index]
            await on_file_complete(storage.file_path(entry.path), entry)

    async def _drive(self, swarm: _Swarm, storage: TorrentStorage,
                     peers: List[tracker_mod.Peer], webseeds: List[str],
                     server, progress_interval: float,
                     on_progress: Optional[ProgressCb],
                     watchdog: StallWatchdog, cancel=None,
                     on_file_complete=None) -> None:
        """Run the download: a dynamic worker pool (seeded from trackers/
        DHT/x.pe, grown from ut_pex gossip), HAVE re-broadcast of finished
        pieces, and a best-effort DHT announce of our serving socket."""
        meta = swarm.meta
        reporter = asyncio.create_task(
            self._report_progress(swarm, watchdog, progress_interval,
                                  on_progress)
        )
        seen = {(p.host, p.port) for p in peers}
        backlog = list(peers)
        # separate pools: webseed workers must not consume MAX_PEERS slots
        ws_workers = [
            asyncio.create_task(self._webseed_worker(url, storage, swarm))
            for url in webseeds[:MAX_WEBSEEDS]
        ]
        workers: List[asyncio.Task] = []
        announce_task = None
        if server is not None:
            announce_task = asyncio.create_task(self._advertise(swarm))
        announced = set(swarm.done)  # resume pieces are in the bitfield
        try:
            while not swarm.complete:
                # cooperative cancellation, between piece batches: the
                # workers' in-flight block requests die with the cancel
                # in the finally below
                if cancel is not None:
                    cancel.raise_if_cancelled()
                # grow the pool from ut_pex gossip
                while not swarm.discovered.empty():
                    host, port = swarm.discovered.get_nowait()
                    if (host, port) not in seen:
                        seen.add((host, port))
                        backlog.append(tracker_mod.Peer(host, port))
                        self._log("pex peer discovered", host=host, port=port)
                peer_slots = MAX_PEERS - sum(
                    1 for w in workers if not w.done()
                )
                while backlog and peer_slots > 0:
                    addr = backlog.pop(0)
                    workers.append(asyncio.create_task(
                        self._peer_worker(addr, storage, swarm)
                    ))
                    peer_slots -= 1
                if (all(w.done() for w in workers)
                        and all(w.done() for w in ws_workers)
                        and not backlog):
                    raise TorrentError(
                        "all peer/webseed sources failed with pieces "
                        "remaining"
                    )
                try:
                    async with asyncio.timeout(0.5):
                        await swarm.piece_event.wait()
                except TimeoutError:
                    pass
                swarm.piece_event.clear()
                # stream per-file completion to the staging pipeline as
                # soon as a file's last piece lands — the whole point of
                # the overlap: egress starts while ingress continues
                await self._drain_file_completions(swarm, storage,
                                                   on_file_complete)
                if server is not None:
                    for index in swarm.done - announced:
                        announced.add(index)
                        await server.add_piece(index)
            # the loop exits the tick the last piece finishes, so any
            # files it completed are still queued — announce them before
            # returning control to the caller
            await self._drain_file_completions(swarm, storage,
                                               on_file_complete)
            # download complete: give the discovery registration a bounded
            # grace — a fast download must not cancel the re-announce that
            # makes the lingering seed findable by sibling replicas
            if announce_task is not None and not announce_task.done():
                try:
                    async with asyncio.timeout(5.0):
                        await announce_task
                except TimeoutError:
                    pass
        finally:
            reporter.cancel()
            if announce_task is not None:
                announce_task.cancel()
            for w in workers + ws_workers:
                w.cancel()
            await asyncio.gather(reporter, *workers, *ws_workers,
                                 return_exceptions=True)

    async def _advertise(self, swarm: _Swarm) -> None:
        """Register our serving socket with every discovery channel
        (best-effort): the DHT, and a tracker re-announce carrying the real
        listen port — real trackers hand that address to other announcers,
        so replicas staging the same torrent find each other.  Peers the
        re-announce returns feed the worker pool like ut_pex gossip.

        Channels run concurrently: a slow DHT walk or one dead tracker
        must not starve the others inside the completion grace window."""
        meta = swarm.meta
        port = swarm.listen_port
        left = max(meta.total_length - swarm.bytes_done, 0)

        async def _dht() -> None:
            try:
                ok = await self.dht.announce(meta.info_hash, port)
                self._log("dht announce", confirmed_by=ok)
            except Exception as err:
                self._log("dht announce failed", error=str(err))

        jobs = [self._announce_all(meta.trackers, meta.info_hash, left,
                                   port=port)]
        if self.dht is not None:
            jobs.append(_dht())
        results = await asyncio.gather(*jobs)
        for peer in results[0]:
            swarm.discovered.put_nowait((peer.host, peer.port))

    # ------------------------------------------------------------------
    async def _resolve(self, uri: str, peers, metadata_timeout: float):
        """uri -> (Metainfo, peers)."""
        if uri.startswith("magnet:"):
            magnet = parse_magnet(uri)
            if peers is None:
                # trackers and DHT are independent sources — overlap them
                # so slow/dead trackers don't serialize in front of the DHT
                tracker_peers, dht_peers = await asyncio.gather(
                    self._announce_all(
                        magnet.trackers, magnet.info_hash, left=1
                    ),
                    self._dht_peers(magnet.info_hash),
                )
                peers = self._merge_peers(
                    tracker_peers,
                    [tracker_mod.Peer(h, p) for h, p in magnet.peer_addrs],
                    dht_peers,
                )
            if not peers:
                raise TorrentError(
                    "magnet link needs reachable peers (trackers, DHT, or "
                    "x.pe all came up empty)"
                )
            try:
                async with asyncio.timeout(metadata_timeout):
                    meta = await self._fetch_metadata(magnet, peers)
            except TimeoutError:
                raise MetadataTimeoutError("Metadata fetch stalled") from None
            return meta, peers

        if uri.startswith(("http://", "https://")):
            async with aiohttp.ClientSession(trust_env=True) as session:
                async with session.get(uri) as resp:
                    resp.raise_for_status()
                    data = await resp.read()
            meta = parse_torrent_bytes(data)
        else:
            path = uri[len("file://"):] if uri.startswith("file://") else uri
            # graftlint: disable=blocking-call-in-async -- .torrent metainfo is KBs (bounded by piece-hash list)
            with open(path, "rb") as fh:
                meta = parse_torrent_bytes(fh.read())

        if peers is None:
            tracker_peers, dht_peers = await asyncio.gather(
                self._announce_all(
                    meta.trackers, meta.info_hash, left=meta.total_length
                ),
                self._dht_peers(meta.info_hash),
            )
            peers = self._merge_peers(tracker_peers, dht_peers)
        return meta, peers

    async def _dht_peers(self, info_hash: bytes) -> List[tracker_mod.Peer]:
        if self.dht is None:
            return []
        try:
            found = await self.dht.get_peers(info_hash)
        except Exception as err:
            self._log("dht lookup failed", error=str(err))
            return []
        if found:
            self._log("dht peers found", count=len(found))
        return found

    @staticmethod
    def _merge_peers(*groups) -> List[tracker_mod.Peer]:
        seen = set()
        out: List[tracker_mod.Peer] = []
        for group in groups:
            for peer in group:
                if (peer.host, peer.port) not in seen:
                    seen.add((peer.host, peer.port))
                    out.append(peer)
        return out

    async def _announce_all(self, trackers: List[str], info_hash: bytes,
                            left: int, port: int = 0,
                            event: str = "started") -> List[tracker_mod.Peer]:
        """Announce to every tracker concurrently (dead trackers must not
        serialize their timeouts) and pool the peers they return — dedup
        is owned by _merge_peers at the call sites.

        ``port=0`` marks a discover-only announce: we are not (yet)
        listening, and registering trackers must not hand our address out
        (0 is the BEP 23 "not connectable" convention).  The re-announce
        from :meth:`_advertise` passes the real serve port.
        """
        async def _one(url: str) -> List[tracker_mod.Peer]:
            try:
                return await tracker_mod.announce_with_retry(
                    url, info_hash, self.peer_id, port=port, left=left,
                    event=event, retries=self.tracker_retries,
                )
            except Exception as err:
                self._log("tracker announce failed", tracker=url,
                          event=event, error=str(err))
                return []

        groups = await asyncio.gather(*(_one(u) for u in trackers))
        return [peer for group in groups for peer in group]

    # -- metadata over ut_metadata (BEP 9) ------------------------------
    async def _fetch_metadata(self, magnet, peers) -> Metainfo:
        last_error: Optional[Exception] = None
        for peer_addr in peers:
            try:
                return await self._fetch_metadata_from(magnet, peer_addr)
            except (ConnectionError, OSError, asyncio.IncompleteReadError,
                    wire.WireError) as err:
                last_error = err
                continue
        raise TorrentError(f"metadata fetch failed from all peers: {last_error}")

    async def _fetch_metadata_from(self, magnet, peer_addr) -> Metainfo:
        peer = await self._connect(peer_addr, magnet.info_hash)
        try:
            # wait for their extended handshake
            while peer.peer_metadata_size is None:
                msg_id, payload = await peer.recv_message()
                if msg_id == wire.MSG_EXTENDED and payload[0] == wire.EXT_HANDSHAKE_ID:
                    peer.handle_ext_handshake(payload[1:])
            total = peer.peer_metadata_size
            num_pieces = (total + wire.METADATA_PIECE_SIZE - 1) // wire.METADATA_PIECE_SIZE
            chunks: dict = {}
            for i in range(num_pieces):
                await peer.send_metadata_request(i)
            while len(chunks) < num_pieces:
                msg_id, payload = await peer.recv_message()
                if msg_id != wire.MSG_EXTENDED or payload[0] == wire.EXT_HANDSHAKE_ID:
                    continue
                from .bencode import bdecode_prefix

                header, consumed = bdecode_prefix(payload[1:])
                if header.get(b"msg_type") == wire.MD_DATA:
                    chunks[header[b"piece"]] = payload[1 + consumed:]
                elif header.get(b"msg_type") == wire.MD_REJECT:
                    raise wire.WireError("peer rejected metadata request")
            info_bytes = b"".join(chunks[i] for i in range(num_pieces))[:total]
            if hashlib.sha1(info_bytes).digest() != magnet.info_hash:
                raise wire.WireError("metadata hash mismatch")
            return parse_info_dict(info_bytes, magnet.trackers)
        finally:
            await peer.close()

    # -- webseeds (BEP 19) ----------------------------------------------
    @staticmethod
    def _webseed_urls(uri: str, meta: Metainfo) -> List[str]:
        """HTTP seed URLs: ``url-list`` from the .torrent plus ``ws=`` from
        the magnet (both deduped, http(s) only)."""
        urls = list(meta.webseeds)
        if uri.startswith("magnet:"):
            try:
                for url in parse_magnet(uri).webseeds:
                    if url not in urls:
                        urls.append(url)
            except ValueError:
                pass
        return [u for u in urls if u.startswith(("http://", "https://"))]

    @staticmethod
    def _webseed_file_url(base: str, meta: Metainfo, entry) -> str:
        """BEP 19 URL construction: a base ending in ``/`` is a directory —
        append the torrent-relative path (which already starts with the
        torrent name); otherwise, for single-file torrents, the URL IS the
        file."""
        from urllib.parse import quote

        if len(meta.files) == 1 and not base.endswith("/"):
            return base
        prefix = base if base.endswith("/") else base + "/"
        return prefix + "/".join(quote(part) for part in entry.path.split("/"))

    async def _fetch_webseed_piece(self, session, base: str, meta: Metainfo,
                                   piece: int) -> bytes:
        """Fetch one piece over HTTP Range requests, spanning file
        boundaries in multi-file torrents."""
        start = piece * meta.piece_length
        end = start + meta.piece_size(piece)
        out = bytearray()
        for entry in meta.files:
            lo = max(start, entry.offset)
            hi = min(end, entry.offset + entry.length)
            if lo >= hi:
                continue
            url = self._webseed_file_url(base, meta, entry)
            file_lo, file_hi = lo - entry.offset, hi - entry.offset
            headers = {"Range": f"bytes={file_lo}-{file_hi - 1}"}
            async with asyncio.timeout(60):
                async with session.get(url, headers=headers) as resp:
                    if resp.status not in (200, 206):
                        raise OSError(f"webseed HTTP {resp.status} for {url}")
                    if resp.status == 206:
                        # bounded read: a hostile seed answering a ranged
                        # request with a huge body must not buffer into RAM
                        body = await self._read_bounded(resp, hi - lo)
                    else:
                        # server ignored Range: stream-slice the span out of
                        # the full body (bounded memory) and abort the rest.
                        # Viable only for small files — per-piece prefix
                        # re-transfer is quadratic, so retire big seeds.
                        if entry.length > WEBSEED_NO_RANGE_MAX:
                            raise OSError(
                                f"webseed ignores Range and file is "
                                f"{entry.length} bytes; retiring {url}"
                            )
                        body = await self._stream_slice(resp, file_lo, file_hi)
            if len(body) != hi - lo:
                raise OSError(
                    f"webseed short read: wanted {hi - lo}, got {len(body)}"
                )
            out += body
        return bytes(out)

    @staticmethod
    async def _read_bounded(resp, want: int) -> bytes:
        """Read exactly up to ``want`` bytes; error out (instead of
        buffering) if the server sends more."""
        got = bytearray()
        async for chunk in resp.content.iter_chunked(1 << 16):
            got += chunk
            if len(got) > want:
                raise OSError(
                    f"webseed overlong body: wanted {want}, got >{len(got)}"
                )
        return bytes(got)

    @staticmethod
    async def _stream_slice(resp, lo: int, hi: int) -> bytes:
        """Collect bytes [lo, hi) from a streaming response body without
        buffering the whole payload; closes the connection early once hi is
        reached."""
        got = bytearray()
        offset = 0
        async for chunk in resp.content.iter_chunked(1 << 16):
            start = max(lo - offset, 0)
            end = min(hi - offset, len(chunk))
            if start < end:
                got += chunk[start:end]
            offset += len(chunk)
            if offset >= hi:
                break
        return bytes(got)

    async def _webseed_worker(self, base_url: str, storage: TorrentStorage,
                              swarm: _Swarm) -> None:
        """Drains the swarm from an HTTP seed; participates in claim/release
        and endgame exactly like a peer worker (have = everything)."""
        meta = swarm.meta
        have = set(range(meta.num_pieces))
        failures = 0
        async with aiohttp.ClientSession(trust_env=True) as session:
            while not swarm.complete:
                piece = swarm.claim(have)
                if piece is None:
                    await asyncio.sleep(0.2)  # wait for a release or endgame
                    continue
                try:
                    data = await self._fetch_webseed_piece(
                        session, base_url, meta, piece
                    )
                    if self.rate_limiter is not None:
                        await self.rate_limiter.consume(len(data))
                except (aiohttp.ClientError, TimeoutError, OSError) as err:
                    swarm.release(piece)
                    failures += 1
                    self._log("webseed fetch failed", url=base_url,
                              piece=piece, error=str(err))
                    if failures >= 3:
                        return  # dead seed: leave the swarm to the peers
                    await asyncio.sleep(min(2 ** failures, 10.0))
                    continue
                if hashlib.sha1(data).digest() == meta.piece_hashes[piece]:
                    failures = 0  # consecutive, not cumulative: a healthy
                    # seed must survive rare transient errors over a long
                    # webseed-only download
                    if piece not in swarm.done:  # endgame duplicate guard
                        storage.write_piece(piece, data)
                        swarm.finish(piece)
                        swarm.bytes_from_webseeds += meta.piece_size(piece)
                else:
                    self._log("webseed piece hash mismatch", piece=piece,
                              url=base_url)
                    swarm.hash_failures += 1
                    swarm.release(piece)
                    failures += 1
                    if failures >= 3:
                        return

    # -- resume ---------------------------------------------------------
    async def _resume_from_disk(self, storage: TorrentStorage, swarm: _Swarm) -> None:
        meta = swarm.meta

        # fast path: the ``.dt-resume`` sidecar (resume.py) names pieces
        # verified before the last orderly exit whose files' size+mtime
        # fingerprints still match — those skip the hash entirely, so a
        # restart of a big torrent costs stat calls, not a full re-read
        trusted = await asyncio.to_thread(
            resume_mod.load_resume, storage.root, meta
        ) or set()

        def _scan() -> list:
            # runs in a worker thread: hashing a multi-GB torrent must not
            # block the event loop
            intact = []
            for index in range(meta.num_pieces):
                if index in trusted:
                    continue
                data = storage.read_piece(index)
                if hashlib.sha1(data).digest() == meta.piece_hashes[index]:
                    intact.append(index)
            return intact

        hashed = await asyncio.to_thread(_scan)
        for index in list(trusted) + hashed:
            swarm.pending.discard(index)
            swarm.done.add(index)
            swarm.bytes_done += meta.piece_size(index)
            swarm.bytes_resumed += meta.piece_size(index)
        if swarm.done:
            self._log("resumed pieces from disk", count=len(swarm.done),
                      fast_resume=len(trusted), rehashed=len(hashed))

    # -- progress -------------------------------------------------------
    async def _report_progress(self, swarm: _Swarm, watchdog: StallWatchdog,
                               interval: float, on_progress: Optional[ProgressCb]):
        total = swarm.meta.total_length or 1
        # the watchdog (and any progress_sink riding its feed) ticks on a
        # short cadence: the stall check only compares across its own
        # 240 s windows, but the flight-recorder profiler samples the
        # fed counters every few seconds and must not see a 30 s-flat
        # counter as a stalled transfer.  on_progress keeps the
        # reference's coarser telemetry cadence (lib/download.js:88).
        tick = min(interval, 1.0)
        elapsed = 0.0
        while True:
            await asyncio.sleep(tick)
            elapsed += tick
            watchdog.feed(swarm.bytes_done)
            if on_progress is not None and elapsed + 1e-9 >= interval:
                elapsed = 0.0
                await on_progress(swarm.bytes_done / total)

    # -- peer plumbing ---------------------------------------------------
    async def _connect(self, peer_addr, info_hash: bytes,
                       listen_port: Optional[int] = None) -> wire.PeerWire:
        # MSE/PE: "prefer" tries the encrypted handshake first and retries
        # plaintext on a fresh connection if the peer rejects it (the
        # handshake is unrecoverable mid-stream); "require" never falls
        # back; "plaintext" never initiates.  Only a failure DURING the MSE
        # exchange triggers the retry — a dead address (TCP connect
        # failure) or an error after encryption is already up propagates
        # immediately, so dead peers are not dialed twice and an
        # encryption-capable peer is never silently downgraded.
        attempts = {"plaintext": [False], "prefer": [True, False],
                    "require": [True]}[self.crypto]
        for use_mse in attempts:
            last_attempt = use_mse is attempts[-1]
            try:
                return await self._connect_once(
                    peer_addr, info_hash, listen_port, use_mse
                )
            except _MSERejected as rejected:
                if last_attempt:
                    raise rejected.cause
                if self.logger is not None:
                    self.logger.debug(
                        "MSE handshake rejected; retrying plaintext",
                        peer=str(peer_addr), error=str(rejected.cause),
                    )
        raise AssertionError("unreachable")  # pragma: no cover

    async def _open_stream(self, peer_addr):
        """Dial the peer per the transport policy.  ``auto`` gives TCP
        the first 60% of the budget, then falls back to uTP on the same
        port — a NAT'd or TCP-filtered peer is usually still reachable
        over UDP (the reference's webtorrent dials both in parallel;
        sequential-with-fallback avoids double-connecting the common
        case)."""
        if self.transport == "tcp":
            async with asyncio.timeout(CONNECT_TIMEOUT):
                return await asyncio.open_connection(
                    peer_addr.host, peer_addr.port)
        if self.transport == "utp":
            return await utp.open_utp_connection(
                peer_addr.host, peer_addr.port, timeout=CONNECT_TIMEOUT)
        try:
            async with asyncio.timeout(CONNECT_TIMEOUT * 0.6):
                return await asyncio.open_connection(
                    peer_addr.host, peer_addr.port)
        except (OSError, TimeoutError) as err:
            if self.logger is not None:
                self.logger.debug(
                    "tcp dial failed; falling back to uTP",
                    peer=str(peer_addr), error=str(err),
                )
            return await utp.open_utp_connection(
                peer_addr.host, peer_addr.port,
                timeout=CONNECT_TIMEOUT * 0.4)

    async def _connect_once(self, peer_addr, info_hash: bytes,
                            listen_port: Optional[int],
                            use_mse: bool) -> wire.PeerWire:
        reader, writer = await self._open_stream(peer_addr)
        if use_mse:
            try:
                # bound the whole exchange with the connect budget: a peer
                # that reads our DH bytes but never answers (e.g. a
                # plaintext-only implementation waiting for more
                # "handshake") must not pin the dial for the full
                # mse.HANDSHAKE_TIMEOUT
                async with asyncio.timeout(CONNECT_TIMEOUT):
                    reader, writer, _method = await mse.initiate(
                        reader, writer, info_hash,
                        allow_plaintext=self.crypto != "require",
                    )
            except (mse.MSEError, EOFError, ConnectionError,
                    TimeoutError) as err:
                writer.close()
                raise _MSERejected(err) from err
            except BaseException:
                writer.close()
                raise
        peer = wire.PeerWire(reader, writer)
        try:
            await peer.send_handshake(info_hash, self.peer_id)
            handshake = await peer.recv_handshake()
            if handshake.info_hash != info_hash:
                raise wire.WireError("infohash mismatch in handshake")
            if handshake.peer_id == self.peer_id:
                # tracker/pex can echo our own advertised address back
                raise wire.WireError("connected to self")
            if handshake.supports_extensions:
                await peer.send_ext_handshake(listen_port=listen_port)
            return peer
        except BaseException:
            # close on ANY failure (including cancellation from the caller's
            # metadata timeout) — a leaked open connection keeps the remote
            # peer's transport alive indefinitely
            await peer.close()
            raise

    async def _peer_worker(self, peer_addr, storage: TorrentStorage,
                           swarm: _Swarm) -> None:
        meta = swarm.meta
        try:
            peer = await self._connect(peer_addr, meta.info_hash,
                                       listen_port=swarm.listen_port)
        except Exception as err:
            self._log("peer connect failed", peer=str(peer_addr), error=str(err))
            return
        have: Set[int] = set()
        choked = True
        interested_sent = False

        # per-piece assembly state: up to MAX_ACTIVE_CLAIMS pieces are in
        # flight at once, so the request pipeline never drains while the
        # tail blocks of one piece are still in transit (a single-claim
        # worker stalls at every piece boundary)
        active: Dict[int, _Assembly] = {}

        async def _add_have(indices: Set[int]) -> None:
            nonlocal interested_sent
            fresh = indices - have
            have.update(fresh)
            swarm.availability.update(fresh)
            if not interested_sent:
                await peer.send_message(wire.MSG_INTERESTED)
                interested_sent = True

        def _blocks(piece: int) -> List[int]:
            return list(range(0, meta.piece_size(piece), BLOCK_SIZE))

        async def _abandon_if_done_elsewhere() -> None:
            # endgame: another worker finished one of our pieces first —
            # cancel its in-flight requests (BEP 3) and free the slot
            for piece in [p for p in active if p in swarm.done]:
                asm = active.pop(piece)
                for begin in asm.requested - asm.received:
                    length = min(BLOCK_SIZE, meta.piece_size(piece) - begin)
                    await peer.send_cancel(piece, begin, length)

        async def _pump_requests() -> None:
            await _abandon_if_done_elsewhere()
            if choked:
                return
            outstanding = sum(
                len(a.requested - a.received) for a in active.values()
            )
            while outstanding < PIPELINE_DEPTH:
                for piece, asm in list(active.items()):
                    while asm.pending and outstanding < PIPELINE_DEPTH:
                        begin = asm.pending.popleft()
                        if begin in asm.requested or begin in asm.received:
                            continue
                        length = min(
                            BLOCK_SIZE, meta.piece_size(piece) - begin
                        )
                        await peer.send_request(piece, begin, length)
                        asm.requested.add(begin)
                        outstanding += 1
                if outstanding >= PIPELINE_DEPTH:
                    return
                if len(active) >= MAX_ACTIVE_CLAIMS:
                    return
                piece = swarm.claim(have)
                if piece is None or piece in active:
                    # nothing claimable — or endgame handed back one of
                    # our own in-flight pieces
                    return
                active[piece] = _Assembly(meta.piece_size(piece))

        idle_rounds = 0
        try:
            while not swarm.complete:
                try:
                    # bounded recv so an idle (unchoked but messageless)
                    # connection still re-pumps requests — e.g. to pick up a
                    # piece another worker released
                    async with asyncio.timeout(5.0):
                        msg_id, payload = await peer.recv_message()
                    idle_rounds = 0
                except TimeoutError:
                    idle_rounds += 1
                    if idle_rounds % 12 == 0:  # ~60 s idle: BEP 3 keep-alive
                        await peer.send_keepalive()
                    await _pump_requests()
                    continue
                if msg_id is None:
                    continue
                if msg_id == wire.MSG_BITFIELD:
                    await _add_have(wire.parse_bitfield(payload,
                                                       meta.num_pieces))
                elif msg_id == wire.MSG_HAVE:
                    (index,) = struct.unpack(">I", payload)
                    await _add_have({index})
                elif msg_id == wire.MSG_HAVE_ALL:  # BEP 6
                    await _add_have(set(range(meta.num_pieces)))
                elif msg_id == wire.MSG_HAVE_NONE:  # BEP 6
                    swarm.availability.subtract(have)
                    have.clear()
                elif msg_id == wire.MSG_REJECT_REQUEST:  # BEP 6
                    index, begin, _length = struct.unpack(">III", payload)
                    asm = active.get(index)
                    if asm is None:
                        continue
                    asm.requeue(begin)
                    if choked:
                        # BEP 6: fast peers reject all in-flight requests
                        # when choking — the piece is fine, the unchoke
                        # re-pump re-requests it; the blocks we already
                        # hold stay held
                        continue
                    asm.rejects[begin] = asm.rejects.get(begin, 0) + 1
                    if asm.rejects[begin] >= 2:
                        # repeatedly refused while unchoked: this peer
                        # won't serve the piece — hand it to the others
                        if index in have:
                            have.discard(index)
                            swarm.availability[index] -= 1
                        swarm.release(index)
                        active.pop(index, None)
                    await _pump_requests()
                elif msg_id == wire.MSG_UNCHOKE:
                    choked = False
                    await _pump_requests()
                elif msg_id == wire.MSG_CHOKE:
                    choked = True
                    # BEP 3: a choke discards the peer's request queue, so
                    # undelivered requests must be re-sent after unchoke
                    for asm in active.values():
                        asm.rebuild_pending()
                elif msg_id == wire.MSG_EXTENDED:
                    if payload[0] == wire.EXT_HANDSHAKE_ID:
                        peer.handle_ext_handshake(payload[1:])
                    elif payload[0] == peer.our_ut_pex:
                        # ut_pex gossip (BEP 11): hand new addresses to the
                        # pool manager in download()
                        for addr in wire.parse_pex(payload[1:]):
                            swarm.discovered.put_nowait(addr)
                elif msg_id == wire.MSG_PIECE:
                    if self.rate_limiter is not None:
                        await self.rate_limiter.consume(len(payload))
                    index, begin = struct.unpack(">II", payload[:8])
                    data = payload[8:]
                    asm = active.get(index)
                    if asm is None:
                        continue
                    if (begin % BLOCK_SIZE
                            or begin + len(data) > len(asm.buffer)):
                        # untrusted wire bytes: a misaligned or oversized
                        # block would silently grow the buffer (bytearray
                        # slice assignment appends past the end) and
                        # poison the completion check
                        continue
                    asm.buffer[begin:begin + len(data)] = data
                    asm.received.add(begin)
                    if asm.received == set(_blocks(index)):
                        piece_bytes = bytes(asm.buffer)
                        digest = hashlib.sha1(piece_bytes).digest()
                        if digest == meta.piece_hashes[index]:
                            # skip when an endgame duplicate landed second —
                            # the winner already wrote it (no await between
                            # the check and finish, so this is atomic)
                            if index not in swarm.done:
                                storage.write_piece(index, piece_bytes)
                                swarm.finish(index)
                        else:
                            self._log("piece hash mismatch", piece=index)
                            swarm.hash_failures += 1
                            swarm.release(index)
                        active.pop(index, None)
                    await _pump_requests()
        except (asyncio.IncompleteReadError, ConnectionError, OSError,
                wire.WireError, struct.error, IndexError, ValueError,
                AttributeError, TypeError) as err:
            # struct/Index/Value/Attribute/Type errors come from malformed
            # frames (e.g. a bencoded non-dict where a dict belongs) —
            # untrusted wire bytes, so treat them like a dead peer
            self._log("peer connection lost", peer=str(peer_addr), error=str(err))
        finally:
            for piece in active:
                swarm.release(piece)
            # this peer's copies no longer count toward piece availability
            swarm.availability.subtract(have)
            await peer.close()

    def _log(self, msg: str, **extra) -> None:
        if self.logger is not None:
            self.logger.info(msg, **extra)
