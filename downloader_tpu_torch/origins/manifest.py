"""HLS-style segment-manifest ingest (live + VOD).

A ``source_kind: MANIFEST`` job's ``source_uri`` names a *media
playlist* (the ``#EXTM3U`` / ``#EXTINF`` / ``#EXT-X-ENDLIST`` subset
every HLS/DASH-adjacent packager emits).  :class:`ManifestIngest` polls
it at a bounded interval, downloads each new segment through the origin
plane's :class:`~.racing.SegmentFetcher` (EWMA-ordered mirrors,
first-byte hedge, per-origin breaker/retry seams), and announces every
durable segment into the job's FileStream — so the streaming pipeline's
incremental filter + bounded upload pool stage segments while later
ones are still being produced.  The job settles DONE when the playlist
ends (``#EXT-X-ENDLIST``); a playlist that stops changing without
ending raises :class:`ManifestStalled` (``ERRDLSTALL``: the
orchestrator acks + drops, the dead-live-stream policy).

Supported tags (unknown tags are ignored, like real players):

- ``#EXT-X-TARGETDURATION:<s>`` — drives the refresh interval
  (``target/2`` clamped to ``origins.manifest.min_poll``/``max_poll``)
- ``#EXT-X-MEDIA-SEQUENCE:<n>`` — segment identity across refreshes
  (a sliding live window must not re-download renumbered lines)
- ``#EXTINF:<duration>[,title]`` — the next line is a segment URI,
  resolved against the *fetching origin's* playlist URL (so relative
  URIs ride whichever mirror serves the segment)
- ``#EXT-X-ENDLIST`` — no further segments: finish and settle

VOD fast path: a playlist that is already ended on first fetch skips
the polling machinery entirely and just drains its segment list.
"""

from __future__ import annotations

import asyncio
import os
import posixpath
import time
import urllib.parse
import zlib
from dataclasses import dataclass
from typing import List, Optional

from ..platform import faults
from ..platform.config import cfg_get
from .plan import Origin
from .racing import SegmentFetcher

DEFAULT_MIN_POLL = 0.25
DEFAULT_MAX_POLL = 6.0
DEFAULT_STALL_TIMEOUT = 240.0  # the transfer watchdog's posture
DEFAULT_LIVE_WINDOW = 0  # 0 = ingest from the playlist's first segment


class ManifestStalled(RuntimeError):
    """A live playlist stopped producing segments without ending."""

    code = "ERRDLSTALL"


class _HedgeTimeout(RuntimeError):
    """An origin spent the whole hedge window without answering.

    PERMANENT under the taxonomy ON PURPOSE: the hedge is the
    *fetcher's* impatience, not the origin's verdict — the next origin
    should get the segment after ONE window, without the Retrier
    re-asking the slow origin (attempts × hedge of added latency) and
    without ``record_failure`` opening a healthy-but-far origin's
    cross-job breaker over what may just be cold-cache TTFB.
    """

    fault_class = "permanent"


@dataclass
class Segment:
    seq: int
    uri: str
    duration: float = 0.0


@dataclass
class MediaPlaylist:
    target_duration: float
    media_sequence: int
    segments: List[Segment]
    ended: bool


def parse_playlist(text: str) -> MediaPlaylist:
    """Parse an HLS-style media playlist (see module doc).

    Raises ``ValueError`` (PERMANENT under the taxonomy: a mis-submitted
    manifest job must fail fast, not burn retries) when the payload is
    not a playlist at all.
    """
    if "#EXTM3U" not in text[:256]:
        raise ValueError("not an HLS playlist (missing #EXTM3U header)")
    target = 0.0
    media_seq = 0
    ended = False
    segments: List[Segment] = []
    pending: Optional[float] = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#EXT-X-TARGETDURATION:"):
            try:
                target = float(line.split(":", 1)[1])
            except ValueError:
                pass
        elif line.startswith("#EXT-X-MEDIA-SEQUENCE:"):
            try:
                media_seq = int(line.split(":", 1)[1])
            except ValueError:
                pass
        elif line.startswith("#EXTINF:"):
            try:
                pending = float(line.split(":", 1)[1].split(",", 1)[0])
            except ValueError:
                pending = 0.0
        elif line.startswith("#EXT-X-ENDLIST"):
            ended = True
        elif line.startswith("#"):
            continue  # unknown tag: ignored, like real players
        else:
            segments.append(Segment(
                seq=media_seq + len(segments), uri=line,
                duration=pending or 0.0,
            ))
            pending = None
    return MediaPlaylist(target_duration=target, media_sequence=media_seq,
                         segments=segments, ended=ended)


class ManifestIngest:
    """Poll one playlist, land its segments, announce each durably.

    ``origins`` is the job's origin set where each URL is that origin's
    copy of the PLAYLIST; segment URIs resolve per-origin, so a mirror
    serves its own segments.  ``announce(path, size)`` is the FileStream
    hand-off (None in barrier/standalone use); ``progress(percent)``
    emits the download stage's 0-50 telemetry band (capped at 49 while
    the playlist is live — 50 is the download-complete milestone the
    caller owns).
    """

    def __init__(self, origins: List[Origin], session, *, retrier,
                 health, cancel, record=None, metrics=None, logger=None,
                 config=None, limiter=None, announce=None, progress=None):
        self.origins = origins
        self.session = session
        self.cancel = cancel
        self.record = record
        self.logger = logger
        self.limiter = limiter
        self.announce = announce
        self.progress = progress
        self.fetcher = SegmentFetcher(
            origins, retrier=retrier, health=health, cancel=cancel,
            record=record, metrics=metrics, logger=logger, config=config,
        )
        self.min_poll = float(cfg_get(
            config, "origins.manifest.min_poll", DEFAULT_MIN_POLL
        ))
        self.max_poll = float(cfg_get(
            config, "origins.manifest.max_poll", DEFAULT_MAX_POLL
        ))
        self.stall_timeout = float(cfg_get(
            config, "origins.manifest.stall_timeout",
            DEFAULT_STALL_TIMEOUT
        ))
        self.live_window = int(cfg_get(
            config, "origins.manifest.live_window", DEFAULT_LIVE_WINDOW
        ))
        self._headers = {"Accept-Encoding": "identity"}
        self._moved_total = 0

    # -- mechanism -------------------------------------------------------
    async def _get(self, url: str, hedge: float):
        """One GET with the hedge window bounding time-to-headers."""
        coro = self.session.get(url, headers=self._headers)
        if hedge > 0:
            try:
                return await asyncio.wait_for(coro, hedge)
            except asyncio.TimeoutError:
                raise _HedgeTimeout(
                    f"no response within the {hedge:g}s hedge window"
                ) from None
        return await coro

    @staticmethod
    def _decoder_for(resp):
        """Mirror of the whole-file HTTP path's Content-Encoding
        defense: the session never decompresses and we ask for
        identity, but a misbehaving CDN can still send gzip — decode
        it rather than staging compressed bytes as media."""
        enc = resp.headers.get("Content-Encoding", "").strip().lower()
        if enc in ("", "identity"):
            return None
        if enc in ("gzip", "x-gzip", "deflate"):
            return zlib.decompressobj(zlib.MAX_WBITS | 32)
        raise RuntimeError(f"unsupported Content-Encoding: {enc}")

    async def _fetch_playlist(self) -> str:
        cell = {}

        async def fetch_one(origin: Origin, hedge: float) -> int:
            if faults.enabled():
                await faults.fire("origin.playlist", key=origin.url)
            # per-attempt liveness bound (see _fetch_segment)
            async with asyncio.timeout(max(self.stall_timeout, 1.0)):
                resp = await self._get(origin.url, hedge)
                try:
                    resp.raise_for_status()
                    text = await resp.text()
                finally:
                    resp.release()
            cell["text"] = text
            return len(text)

        await self.fetcher.fetch(fetch_one, what="playlist")
        return cell["text"]

    async def _fetch_segment(self, segment: Segment, dest: str) -> int:
        tmp = dest + ".part"
        record = self.record

        async def fetch_one(origin: Origin, hedge: float) -> int:
            url = urllib.parse.urljoin(origin.url, segment.uri)
            if faults.enabled():
                await faults.fire("origin.segment", key=url)
            moved = 0
            # per-ATTEMPT liveness bound: the ingest loop's own stall
            # check cannot fire while blocked inside this fetch, and a
            # sole origin gets no hedge window — without this bound a
            # mid-body black-hole would ride aiohttp's 5-minute session
            # default × retry attempts before the contract ("liveness
            # is the ingest's stall_timeout") meant anything
            async with asyncio.timeout(max(self.stall_timeout, 1.0)):
                resp = await self._get(url, hedge)
                try:
                    resp.raise_for_status()
                    decoder = self._decoder_for(resp)
                    hop_mark = time.monotonic()
                    # graftlint: disable=blocking-call-in-async -- one open(2); the segment body loop below awaits per chunk
                    with open(tmp, "wb") as fh:
                        async for chunk in resp.content.iter_any():
                            if record is not None:
                                record.note_hop(
                                    "socket_read", len(chunk),
                                    time.monotonic() - hop_mark)
                            self.cancel.raise_if_cancelled()
                            if self.limiter is not None:
                                await self.limiter.consume(len(chunk))
                            data = (decoder.decompress(chunk)
                                    if decoder else chunk)
                            write_mark = time.monotonic()
                            if data:
                                fh.write(data)
                                if record is not None:
                                    record.note_hop(
                                        "disk_write", len(data),
                                        time.monotonic() - write_mark)
                                moved += len(data)
                            if record is not None:
                                record.note_transfer(
                                    "download",
                                    self._moved_total + moved,
                                )
                            hop_mark = time.monotonic()
                        if decoder is not None:
                            tail = decoder.flush()
                            if tail:
                                fh.write(tail)
                                moved += len(tail)
                finally:
                    resp.close()
            # durable only on a complete body: a failed-over retry
            # restarts the temp file, never stitches two origins
            os.replace(tmp, dest)
            return moved

        moved = await self.fetcher.fetch(
            fetch_one, what=f"segment seq={segment.seq}"
        )
        self._moved_total += moved
        return moved

    # -- naming ----------------------------------------------------------
    @staticmethod
    def _segment_name(segment: Segment) -> str:
        path = urllib.parse.urlsplit(segment.uri).path
        name = posixpath.basename(path)
        if not name:
            name = f"seg{segment.seq:08d}.ts"
        # keep names collision-proof across sequence reuse without
        # losing the media extension the filter keys on
        return name

    def _dest(self, download_path: str, segment: Segment,
              used: set) -> str:
        name = self._segment_name(segment)
        if name in used:
            name = f"{segment.seq:08d}-{name}"
        used.add(name)
        return os.path.join(download_path, name)

    # -- the ingest loop -------------------------------------------------
    def _poll_interval(self, playlist: MediaPlaylist) -> float:
        base = (playlist.target_duration / 2.0
                if playlist.target_duration > 0 else 1.0)
        return min(max(base, self.min_poll), self.max_poll)

    async def _emit_progress(self, fetched: int, known: int,
                             ended: bool) -> None:
        if self.progress is None:
            return
        percent = int(50 * fetched / known) if known else 0
        if not ended:
            percent = min(percent, 49)
        await self.progress(min(percent, 50))

    async def run(self, playlist_url: str, download_path: str) -> int:
        """Ingest until ``#EXT-X-ENDLIST`` (or VOD drain); returns bytes
        landed.  Raises :class:`ManifestStalled` when a live playlist
        goes ``origins.manifest.stall_timeout`` without producing."""
        os.makedirs(download_path, exist_ok=True)
        done_seqs: set = set()
        used_names: set = set()
        total = 0
        fetched = 0
        last_change = time.monotonic()
        first = True
        final_text = ""
        while True:
            self.cancel.raise_if_cancelled()
            text = await self._fetch_playlist()
            playlist = parse_playlist(text)
            final_text = text
            segments = playlist.segments
            if first:
                if self.record is not None:
                    self.record.event(
                        "manifest_open", segments=len(segments),
                        ended=playlist.ended,
                        target_duration=playlist.target_duration,
                    )
                if (not playlist.ended and self.live_window > 0
                        and len(segments) > self.live_window):
                    skipped = segments[:-self.live_window]
                    done_seqs.update(s.seq for s in skipped)
                    segments = segments[-self.live_window:]
                    if self.logger is not None:
                        self.logger.info(
                            "manifest: joining at the live edge",
                            skipped=len(skipped),
                            window=self.live_window,
                        )
                first = False
            new = [s for s in segments if s.seq not in done_seqs]
            if new and self.record is not None:
                self.record.event("manifest_refresh", new=len(new),
                                  head_seq=new[0].seq,
                                  ended=playlist.ended)
            if new or playlist.ended:
                last_change = time.monotonic()
            known = len(done_seqs) + len(new)
            for segment in new:
                self.cancel.raise_if_cancelled()
                dest = self._dest(download_path, segment, used_names)
                moved = await self._fetch_segment(segment, dest)
                total += moved
                fetched += 1
                done_seqs.add(segment.seq)
                last_change = time.monotonic()
                if self.logger is not None:
                    self.logger.info("manifest: segment landed",
                                     seq=segment.seq, bytes=moved,
                                     file=os.path.basename(dest))
                if self.announce is not None:
                    # the streaming pipeline may stage this segment NOW,
                    # while the playlist keeps producing later ones
                    await self.announce(dest, moved)
                await self._emit_progress(fetched, known, playlist.ended)
            if playlist.ended:
                if self.record is not None:
                    self.record.event("manifest_end",
                                      segments=len(done_seqs),
                                      bytes=total)
                break
            idle = time.monotonic() - last_change
            if idle > self.stall_timeout:
                raise ManifestStalled(
                    f"live playlist unchanged for {idle:.0f}s "
                    f"(stall budget {self.stall_timeout:.0f}s)"
                )
            await self.cancel.guard(
                asyncio.sleep(self._poll_interval(playlist))
            )
        # provenance: keep the final playlist beside the segments (its
        # extension is not media, so the filter never stages it)
        name = posixpath.basename(
            urllib.parse.urlsplit(playlist_url).path
        ) or "playlist.m3u8"
        try:
            # graftlint: disable=blocking-call-in-async -- playlist text is KBs, written once at ingest end
            with open(os.path.join(download_path, name), "w") as fh:
                fh.write(final_text)
        except OSError:
            pass
        return total
