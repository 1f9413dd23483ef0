"""Download stage: protocol-dispatched media fetch.

Behavioral parity with upstream lib/download.js:

- download dir = ``<config.instance.download_path>/<media.id>``, with
  relative paths resolved against the repo root (lib/download.js:234-240)
- protocol chosen by the ``SourceType`` enum name, lowercased
  (lib/download.js:243,256-260); unsupported -> ``Protocol not supported.``
- progress 0 emitted before the fetch and 50 after (lib/download.js:255,272)
- methods:
  * ``torrent`` — magnet/metainfo fetch with the 240 s metadata timeout and
    240 s no-progress stall watchdog raising ``ERRDLSTALL``
    (lib/download.js:43-123); progress maps to 0-50%
  * ``http``   — streaming download; ``.torrent`` URLs chain to the torrent
    method (lib/download.js:134-167)
  * ``file``   — gated by ``ALLOW_FILE_URLS=true``; ``file://`` copy
    (lib/download.js:177-189)
  * ``bucket`` — ``bucket://endpoint,bucket,accessKey,secretKey,subFolder``
    fan-in from another object store (lib/download.js:199-227)
- returns ``{"path": download_path}`` (lib/download.js:273-275)
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import hashlib
import json
import os
import posixpath
import re
import socket
import time
import urllib.parse
import urllib.request
import zlib

import aiohttp

from .. import schemas
from ..platform import faults, vfs
from ..platform.errors import Retrier
from ..store import scrub
from ..store.cache import ContentCache, Singleflight, cache_key
from ..utils.disk import ensure_disk_space as _ensure_disk_space
from ..utils.hashing import md5_file_hex
from ..utils.watchdog import STALL_TIMEOUT_SECONDS, StallWatchdog
from .base import Job, StageContext, StageFn

# Repo root, for resolving relative download paths the way the reference
# resolves against ``path.join(__dirname, '..')`` (lib/download.js:234-240).
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Progress telemetry interval (reference: 30 s, lib/download.js:88).
PROGRESS_INTERVAL_SECONDS = 30.0

_CHUNK = 1 << 20  # 1 MiB read chunks for streaming HTTP


def _landed_rel_digests(job, root: str) -> "dict[str, str]":
    """``job.landed_digests`` re-keyed relative to ``root`` (the
    workdir), for the cache manifest: the landing-site digests become
    the entry's scrub/verify ground truth.  Paths outside ``root`` —
    and protocols that never stamp digests (torrent) — just yield
    fewer entries; files without one are not re-verifiable, which is
    exactly the pre-digest behavior."""
    digests = getattr(job, "landed_digests", None) or {}
    root = os.path.abspath(root)
    out = {}
    for path, digest in digests.items():
        if os.path.commonpath([os.path.abspath(path), root]) != root:
            continue
        rel = os.path.relpath(os.path.abspath(path), root)
        out[rel.replace(os.sep, "/")] = digest
    return out


class _LandHasher:
    """Hash-on-land: inline md5 over bytes as the chunked write loop
    lands them — integrity comes free with the copy, no second read
    pass.  Each ``update`` is billed to the ``hash`` hop so the ledger
    shows integrity's true CPU cost even when it rides the write loop
    instead of a separate pass.  ``nbytes`` lets the caller prove the
    hasher saw every byte of the final entity before trusting it (a
    spliced or resumed landing bypasses userspace, so the hasher stays
    short and the promote-time fallback read takes over)."""

    def __init__(self, record=None):
        self._md5 = hashlib.md5()
        self._record = record
        self.nbytes = 0

    def update(self, data) -> None:
        mark = time.monotonic()
        self._md5.update(data)
        if self._record is not None:
            self._record.note_hop("hash", len(data),
                                  time.monotonic() - mark)
        self.nbytes += len(data)

    def hexdigest(self) -> str:
        return self._md5.hexdigest()

# Zero-copy body landing (r5): plain-HTTP bodies with a known length
# splice socket -> pipe -> file entirely in the kernel, skipping both
# userspace copies (socket recv + file write), which profile as ~70% of
# staging CPU per byte.  TLS responses can't splice (decryption happens
# in userspace) and chunked/encoded bodies fall back to the streaming
# loop.  SPLICE_OK gates on the syscall's availability (Linux 2.6.17+,
# Python 3.10+).
SPLICE_OK = hasattr(os, "splice")
_SPLICE_DISABLED_ENV = "HTTP_NO_SPLICE"
# one thread-side select+splice slice per event-loop hop: big enough to
# amortize the to_thread dispatch, small enough to keep watchdog/
# progress/rate-limit feedback flowing
_SPLICE_SLICE = 8 << 20
_SPLICE_PIPE_SIZE = 1 << 20
# grown socket receive buffer for spliced connections: bigger per-splice
# moves amortize the ~200 us/syscall kernel cost (A/B measured ~10-15%
# off the cpu_s_per_gb floor).  An EXPLICIT SO_RCVBUF permanently
# disables TCP receive autotuning and silently clamps at rmem_max, so
# the grow is only safe when the locked window — min(request, rmem_max)
# — is at least what autotuning itself could have reached, which is
# tcp_rmem[2] (independent of rmem_max; default ~6 MB).  Gating on
# rmem_max alone (pre-r6) still shrank the window on hosts with
# rmem_max between 1 MiB and tcp_rmem[2] (advisor r5).
_SPLICE_RCVBUF = 8 << 20


def _read_proc_int(path: str, field: int = 0) -> "int | None":
    try:
        with open(path) as fh:
            return int(fh.read().split()[field])
    except (OSError, ValueError, IndexError):
        return None


@functools.lru_cache(maxsize=1)
def _rcvbuf_grow_ok() -> bool:
    rmem_max = _read_proc_int("/proc/sys/net/core/rmem_max")
    if rmem_max is None:
        return False
    autotune_ceiling = _read_proc_int("/proc/sys/net/ipv4/tcp_rmem", 2)
    if autotune_ceiling is None:
        # can't see the autotuning ceiling: only grow when the locked
        # buffer honors the full request (never a shrink vs any ceiling
        # the kernel default could plausibly reach)
        return rmem_max >= _SPLICE_RCVBUF
    return min(_SPLICE_RCVBUF, rmem_max) >= autotune_ceiling

# Segmented HTTP: entities smaller than this aren't worth the extra
# connections (segment setup costs more than the parallelism returns)
SEG_MIN_SIZE = 8 << 20
# state checkpoint cadence while segments stream (crash-resume fidelity)
SEG_STATE_INTERVAL = 2.0


def _write_all(fd: int, view, pos: "int | None",
               thread_ok: bool = False) -> None:
    """Write a full buffer at ``pos`` (None = the fd's own offset),
    through the VFS shim so disk drills (platform/vfs.py) reach the
    landing loop.  ``thread_ok`` attests the caller is off the event
    loop (latency drills only enact there)."""
    vfs.write_all(fd, view, pos, seam="disk.write", thread_ok=thread_ok)


def _spliceable(resp) -> bool:
    """True when this response's body can land via kernel splice."""
    if not SPLICE_OK or os.environ.get(_SPLICE_DISABLED_ENV):
        return False
    if resp.content_length is None:
        return False  # chunked framing is parsed in userspace
    conn = getattr(resp, "connection", None)
    if conn is None or conn.transport is None:
        return False
    transport = conn.transport
    if transport.get_extra_info("sslcontext") is not None:
        return False  # TLS payload decrypts in userspace
    sock = transport.get_extra_info("socket")
    if sock is None:
        return False
    try:
        sock.fileno()
    except (OSError, ValueError):
        return False
    return True


def _splice_slice_blocking(sock_fd: int, pipe_r: int, pipe_w: int,
                           out_fd: int, want: int, timeout: float,
                           abort_fd: int,
                           out_offset: "int | None" = None) -> int:
    """Move up to ``want`` bytes socket -> pipe -> file in the kernel.

    Runs in a worker thread.  The socket stays nonblocking; readiness
    comes from select, which also watches ``abort_fd`` so the event-loop
    side can interrupt instantly (a cancelled to_thread otherwise leaves
    this thread selecting on fds the caller is about to close — an fd
    recycling hazard).  ``out_offset`` writes at an explicit file
    position (segmented downloads share one fd across concurrent
    segments); None uses — and advances — the fd's own offset.
    Returns bytes moved; 0 means EOF before any byte of this slice.
    """
    import select as select_mod

    # poll, not select: select raises ValueError for any fd >= 1024,
    # and this process also runs swarm peers/DHT/segmented connections
    # (review r5)
    poller = select_mod.poll()
    poller.register(sock_fd, select_mod.POLLIN)
    poller.register(abort_fd, select_mod.POLLIN)
    moved = 0
    while moved < want:
        ready = {fd for fd, _ev in poller.poll(timeout * 1000.0)}
        if abort_fd in ready:
            return moved
        if not ready:
            if moved:
                return moved  # partial progress: caller re-slices
            raise TimeoutError("splice: no socket data within timeout")
        try:
            n = os.splice(sock_fd, pipe_w,
                          min(want - moved, _SPLICE_PIPE_SIZE))
        except BlockingIOError:
            continue  # readiness raced away
        if n == 0:
            return moved  # EOF
        left = n
        while left:
            if out_offset is None:
                left -= os.splice(pipe_r, out_fd, left)
            else:
                got = os.splice(pipe_r, out_fd, left,
                                offset_dst=out_offset + moved + (n - left))
                left -= got
        moved += n
    return moved


class _EntityChangedDuringSegments(Exception):
    """A segment's If-Range missed: the origin entity changed mid-flight.

    ``race_abort`` marks it fatal to a whole racing attempt when the
    PRIMARY origin raises it (origins/racing.py re-raises instead of
    failing over): every already-landed byte was validated against the
    old entity, so no mirror can rescue the attempt.  ``fault_class``
    permanent keeps the per-origin Retrier from re-asking an origin
    that just answered deterministically (a mirror serving a different
    entity fails over instantly; the single-origin segmented path never
    routes this through a retrier, so its restart behavior is
    unchanged).
    """

    race_abort = True
    fault_class = "permanent"


def _is_encoded(headers) -> bool:
    """True when the response body is Content-Encoding-compressed — byte
    ranges and on-disk offsets are only meaningful against identity."""
    return headers.get(
        "Content-Encoding", ""
    ).strip().lower() not in ("", "identity")




def choose_validator(headers) -> "str | None":
    """Pick the entity validator to store beside a partial download.

    If-Range requires a STRONG validator (RFC 7232 §3.2): a weak ETag can
    name byte-different entities, which is exactly what range stitching
    must not tolerate.  Last-Modified is itself weak (1 s granularity);
    RFC 7232 §2.2.2 lets a client treat it as strong only when the origin
    offered no ETag at all AND the date is at least 60 seconds older than
    the response's own Date — outside the window in which clock skew and
    sub-minute regeneration could produce two different entities with the
    same timestamp.  Otherwise: None (restart from byte 0 on redelivery
    rather than risk stitching two entities).
    """
    etag = headers.get("ETag", "")
    if etag.startswith("W/"):
        return None  # weak ETag: origin admits byte-level ambiguity
    if etag:
        return etag
    last_modified = headers.get("Last-Modified")
    if not last_modified:
        return None
    from email.utils import parsedate_to_datetime

    try:
        modified = parsedate_to_datetime(last_modified)
        date = parsedate_to_datetime(headers["Date"])
    except (KeyError, ValueError, TypeError):
        return None
    if (date - modified).total_seconds() >= 60.0:
        return last_modified
    return None


def job_download_dir(config, media_id: str) -> str:
    """The per-job workdir ``<instance.download_path>/<media.id>``, with
    relative paths resolved against the repo root exactly like the stage
    itself resolves them (reference lib/download.js:234-240).  Shared
    with the orchestrator's cancelled-job cleanup so both sides always
    name the same directory."""
    configured = getattr(
        getattr(config, "instance", None), "download_path", "downloading"
    )
    prefix = "" if os.path.isabs(configured) else _REPO_ROOT
    return os.path.join(prefix, configured, media_id)


async def _join_offloaded(fn, *args):
    """Run ``fn(*args)`` on the default executor, JOINING the worker
    before propagating cancellation.  The cancel settle path removes
    the job workdir the moment the delivery settles; a bare
    ``asyncio.to_thread`` abandons its still-running thread on cancel,
    and that thread's writes would race the rmtree (re-creating the
    directories it just deleted — an orphan workdir until the next
    boot's recovery sweep).  A SECOND cancellation during the join
    abandons it, the same double-cancel posture as the torrent drive
    loop's cleanup join."""
    loop = asyncio.get_running_loop()
    fut = loop.run_in_executor(None, functools.partial(fn, *args))
    try:
        return await asyncio.shield(fut)
    except asyncio.CancelledError:
        if not fut.done():
            try:
                await asyncio.wait({fut})
            except asyncio.CancelledError:
                pass
        if fut.done() and not fut.cancelled():
            # the cancel wins, but the worker's own failure (ENOSPC…)
            # must be consumed or asyncio logs "exception was never
            # retrieved" at GC on a routine cancel path
            fut.exception()
        raise


def make_bucket_client(endpoint: str, access_key: str, secret_key: str,
                       ssl: bool = True):
    """Default factory for the ``bucket`` method's ad-hoc client
    (reference builds a MinIO client inline, lib/download.js:210-215)."""
    from ..store.s3 import S3ObjectStore

    # default-https matches the reference's hardcoded `useSSL: true`
    # (lib/download.js:212); an explicit scheme in the endpoint wins
    return S3ObjectStore.from_endpoint(endpoint, access_key, secret_key, ssl=ssl)


def parse_bucket_uri(resource_url: str) -> dict:
    """Parse ``bucket://endpoint,bucket,accessKey,secretKey,subFolder``
    (reference lib/download.js:201-207)."""
    params = resource_url.split(",")
    if len(params) < 5:
        raise ValueError(
            "bucket URI must be bucket://endpoint,bucket,accessKey,secretKey,subFolder"
        )
    return {
        "endpoint": params[0].replace("bucket://", "", 1),
        "bucket": params[1],
        "access_key": params[2],
        "secret_key": params[3],
        "sub_folder": params[4],
    }


async def stage_factory(ctx: StageContext) -> StageFn:
    logger = ctx.logger
    telemetry = ctx.telemetry
    downloading = schemas.TelemetryStatus.Value("DOWNLOADING")
    bucket_client_factory = getattr(ctx, "bucket_client_factory", None) or make_bucket_client
    # cooperative cancellation (control/cancel.py): checked at every
    # chunk/piece loop below so a cancelled job unwinds within one chunk
    cancel = ctx.cancel

    # service-wide ingress cap (bytes/s), shared by every job's transfers
    # regardless of protocol; unset = unlimited (reference behavior).
    # Memoized across jobs via ctx.resources so concurrency can't
    # multiply the cap.
    from ..utils.ratelimit import shared_bucket

    limiter = shared_bucket(ctx.resources, ctx.config, "download_rate_limit")
    # per-tenant ingress quota (control/tenancy.py): when the job's
    # tenant carries a download_rate_limit, it stacks UNDER the service
    # cap (the transfer pays both buckets); no tenant table / no quota =
    # the service limiter unchanged
    from ..control.tenancy import stage_limiter

    limiter = stage_limiter(ctx, "ingress", limiter)

    # dependency fault tolerance (platform/errors.py): origin fetches
    # ride the "http" retry policy (transient network errors/5xx back
    # off in-process instead of burning a broker redelivery — the
    # .partial resume point makes each retry cheaper than the last);
    # shared with the orchestrator via ctx.resources
    retrier = Retrier.shared(ctx.resources, ctx.config,
                             metrics=ctx.metrics, logger=ctx.logger)

    # hash-on-land (zero-copy staging ratchet): when staged-set integrity
    # is on, the content digest is computed AT the landing moment —
    # inline with the chunked write loop, or one hot page-cache read at
    # promote — and carried on ``job.landed_digests`` so upload/manifest
    # never burn a second full read pass per staged file.
    from .manifest import integrity_enabled as _integrity_enabled
    hash_on_land = _integrity_enabled(ctx.config)

    # io_uring spike (zero-copy staging ratchet): opt-in landing of
    # segmented chunks through a kernel submission ring instead of one
    # pwrite syscall each.  The knob turns the probe on, the probe turns
    # the ring on — an older kernel or seccomp-filtered container
    # silently keeps the plain pwrite path.
    from ..platform.config import cfg_get
    use_io_uring = bool(cfg_get(ctx.config, "download.io_uring", False))

    # Parallel ranged HTTP: HTTP_SEGMENTS / instance.http_segments
    # connections per download (default 1 = the reference's single
    # stream).  Misconfiguration fails loudly, like the rate limit.
    raw_segments = os.environ.get("HTTP_SEGMENTS") or getattr(
        ctx.config.instance, "http_segments", 1
    )
    try:
        seg_count = int(raw_segments)
    except (TypeError, ValueError):
        raise ValueError(
            f"http_segments must be an integer, got {raw_segments!r}"
        ) from None
    if seg_count < 1 or seg_count > 64:
        raise ValueError(f"http_segments must be in [1, 64], got {seg_count}")

    async def _announce_file(job: Job, path: str, size=None) -> None:
        """Streaming hand-off: tell the pipeline this file's bytes are
        final (stages/base.py FileStream).  No-op in barrier mode and in
        standalone stage use (``job.file_stream`` is None there).
        getattr, not attribute access: jobs are duck-typed here, like
        ``cache_report`` below."""
        stream = getattr(job, "file_stream", None)
        if stream is not None:
            await stream.emit(path, size)

    # One long-lived DHT node shared by every torrent job the orchestrator
    # runs (webtorrent likewise keeps a single bundled DHT instance for the
    # client's lifetime, lib/download.js:19).  Created lazily on the first
    # torrent download, memoized in the cross-job ``ctx.resources`` dict,
    # closed once via ``ctx.cleanups`` at orchestrator shutdown.
    async def _shared_dht(logger):
        import asyncio

        bootstrap_spec = os.environ.get("DHT_BOOTSTRAP") or getattr(
            ctx.config.instance, "dht_bootstrap", None
        )
        if not bootstrap_spec:
            return None
        lock = ctx.resources.setdefault("dht_lock", asyncio.Lock())
        async with lock:
            if "dht_node" in ctx.resources:
                return ctx.resources["dht_node"]
            from ..torrent.dht import DHTNode, parse_bootstrap

            routers = parse_bootstrap(bootstrap_spec)  # validate BEFORE binding
            # routing-table cache: a restarted service rejoins the DHT from
            # the nodes it knew, not just the public routers
            state_path = os.environ.get("DHT_STATE_PATH") or getattr(
                ctx.config.instance, "dht_state_path", None
            )
            if state_path:
                cached = DHTNode.load_nodes(state_path)
                if cached:
                    logger.info("dht node cache loaded", count=len(cached))
                routers = routers + cached
            node = DHTNode(logger=logger)
            await node.start()
            try:
                found = await node.bootstrap(routers)
            except BaseException:
                await node.close()
                raise
            if found == 0:
                # transient DNS/network failure must not memoize a dead
                # node for the process lifetime — retry on the next job
                logger.warn("dht bootstrap found no routers; will retry")
                await node.close()
                return None
            logger.info("dht bootstrapped", routing_table=found)
            ctx.resources["dht_node"] = node

            async def _shutdown_dht() -> None:
                if state_path:
                    try:
                        saved = node.save_nodes(state_path)
                        logger.info("dht node cache saved", count=saved)
                    except OSError as err:
                        logger.warn("dht node cache save failed",
                                    error=str(err))
                await node.close()

            ctx.cleanups.append(_shutdown_dht)
            return node

    async def torrent(resource_url: str, file_id: str, download_path: str, job: Job):
        try:
            from ..torrent import TorrentClient
        except ImportError as err:
            raise NotImplementedError(
                "torrent downloads need downloader_tpu_torch.torrent"
            ) from err

        logger.info("torrent", url=resource_url[:25] + "...")

        # DHT peer discovery (BEP 5) — the reference's webtorrent bundles
        # bittorrent-dht (lib/download.js:19).  Bootstrap routers come from
        # DHT_BOOTSTRAP=host:port,... or config.instance.dht_bootstrap;
        # unset means tracker-only discovery.
        # MSE/PE mode for outgoing peer connections: TORRENT_CRYPTO env or
        # config.instance.torrent_crypto — prefer (default) | require |
        # plaintext.  Incoming (seed-while-leech) always auto-detects.
        crypto = os.environ.get("TORRENT_CRYPTO") or getattr(
            ctx.config.instance, "torrent_crypto", None
        ) or "prefer"
        # Transport for outgoing dials: TORRENT_TRANSPORT env or
        # config.instance.torrent_transport — auto (default: TCP with a
        # uTP/BEP 29 fallback, webtorrent parity) | tcp | utp.
        transport = os.environ.get("TORRENT_TRANSPORT") or getattr(
            ctx.config.instance, "torrent_transport", None
        ) or "auto"
        # tracker announces ride the "tracker" retry policy: attempts-1
        # quick in-client retries per tracker (concurrent across
        # trackers, so a flaky one never serializes the swarm bootstrap)
        tracker_retries = max(
            retrier.policy("tracker").attempts - 1, 0
        )
        client = TorrentClient(logger=logger, dht=await _shared_dht(logger),
                               rate_limiter=limiter, crypto=crypto,
                               transport=transport,
                               tracker_retries=tracker_retries)

        # seed-while-leech: verified pieces are served back to the swarm
        # during the download; SEED_LINGER/config.instance.seed_linger keeps
        # serving that many seconds after completion so concurrent replicas
        # staging the same torrent don't lose their source.  The reference
        # removes the torrent on done (lib/download.js:110-120), so the
        # parity default is 0.
        raw_linger = os.environ.get("SEED_LINGER") or getattr(
            ctx.config.instance, "seed_linger", 0
        )
        try:
            seed_linger = float(raw_linger)
        except (TypeError, ValueError):
            seed_linger = 0.0
        if seed_linger > 0:
            # reap lingering servers at service shutdown
            if "torrent_clients" not in ctx.resources:
                ctx.resources["torrent_clients"] = []

                async def _close_all() -> None:
                    for c in ctx.resources["torrent_clients"]:
                        await c.close()

                ctx.cleanups.append(_close_all)
            clients = ctx.resources["torrent_clients"]
            # prune clients whose linger expired so the list stays bounded
            # by concurrently-seeding jobs, not total jobs ever run
            clients[:] = [c for c in clients if c.is_seeding]
            clients.append(client)

        last_emitted = [None]

        async def on_progress(fraction: float) -> None:
            # download occupies the 0-50% band; only emit on integer change
            # (reference lib/download.js:80-87)
            percent = int(fraction * 100 / 2)
            if percent != last_emitted[0]:
                last_emitted[0] = percent
                await telemetry.emit_progress(file_id, downloading, percent)
                # coalesced same-content jobs ride this fetch: re-broadcast
                # so each waiter re-emits through its own telemetry
                report = getattr(job, "cache_report", None)
                if report is not None:
                    report(percent)

        stats: dict = {}
        record = ctx.record

        async def _file_done(path: str, entry) -> None:
            # per-file completion out of the client's drive loop: the
            # file's last overlapping piece is verified and on disk
            await _announce_file(job, path, entry.length)

        # origin plane: a torrent job's http(s) mirrors are webseeds by
        # another name (BEP 19) — the swarm treats them as always-on
        # HTTP origins for the same piece-verified content, which is
        # exactly the webseed/HTTP-mirror equivalence
        extra_webseeds = [
            m for m in (getattr(job, "mirrors", ()) or ())
            if isinstance(m, str)
            and m.startswith(("http://", "https://"))
        ]
        await client.download(
            resource_url,
            download_path,
            metadata_timeout=STALL_TIMEOUT_SECONDS,
            stall_timeout=STALL_TIMEOUT_SECONDS,
            progress_interval=PROGRESS_INTERVAL_SECONDS,
            on_progress=on_progress,
            seed_linger=seed_linger,
            stats_out=stats,
            cancel=cancel,
            extra_webseeds=extra_webseeds or None,
            # live verified-byte counter for the transfer profiler's
            # per-job throughput/stall sampling (rides the client's own
            # watchdog feeds)
            progress_sink=(None if record is None else
                           lambda n: record.note_transfer("download",
                                                          int(n))),
            on_file_complete=(None if getattr(job, "file_stream", None)
                              is None else _file_done),
        )
        if ctx.record is not None and stats:
            ctx.record.add_bytes(
                "downloaded",
                stats.get("bytes_from_peers", 0)
                + stats.get("bytes_from_webseeds", 0),
            )
        if ctx.metrics is not None and stats:
            m = ctx.metrics
            m.bytes_downloaded.labels(protocol="torrent-peer").inc(
                stats["bytes_from_peers"]
            )
            m.bytes_downloaded.labels(protocol="torrent-webseed").inc(
                stats["bytes_from_webseeds"]
            )
            # bytes NOT refetched thanks to on-disk pieces + the
            # fast-resume sidecar: resume effectiveness at a glance
            m.bytes_downloaded.labels(protocol="torrent-resumed").inc(
                stats["bytes_resumed"]
            )
            m.torrent_hash_failures.inc(stats["hash_failures"])
            m.torrent_bytes_served.inc(stats["bytes_served"])
        if stats:
            logger.info("torrent complete", **{
                k: v for k, v in stats.items()
            })

    async def http(resource_url: str, file_id: str, download_path: str, job: Job):
        logger.info("http", url=resource_url)
        parsed = urllib.parse.urlparse(resource_url)
        filename = posixpath.basename(parsed.path)

        # .torrent files chain to the torrent downloader
        # (reference lib/download.js:144-155)
        if posixpath.splitext(parsed.path)[1] == ".torrent":
            logger.info("downloading a .torrent, chaining to torrent downloader")
            return await torrent(resource_url, file_id, download_path, job)

        os.makedirs(download_path, exist_ok=True)
        output = os.path.join(download_path, filename)
        # bytes stream into ``<name>.partial`` and are renamed on completion,
        # so ``output`` existing is a completion marker and the partial file
        # is a byte-level resume point across job redeliveries — the
        # reference restarts every HTTP download from zero (SURVEY.md §5).
        # ``<name>.partial.meta`` stores the entity validator (ETag or
        # Last-Modified) the partial bytes came from; resume only happens
        # when one exists, sent as ``If-Range`` so a changed entity comes
        # back as a full 200 instead of being stitched onto stale bytes.
        partial = output + ".partial"
        meta = partial + ".meta"

        # the watchdog's feed taps double as the flight recorder's live
        # transfer counter: the profiler samples it into per-job
        # throughput events (a stalled transfer is visibly flat in
        # GET /v1/jobs/{id}/events minutes before this watchdog fires)
        record = ctx.record
        watchdog = StallWatchdog(
            STALL_TIMEOUT_SECONDS,
            on_feed=(None if record is None
                     else lambda n: record.note_transfer("download", n)),
        )
        # identity: a Content-Encoding-compressed body would be written to
        # disk raw (the session doesn't decompress), and byte-range offsets
        # are only meaningful against the unencoded entity
        base_headers = {"Accept-Encoding": "identity"}

        def _entity_complete(resp, offset: int) -> bool:
            # 416 Content-Range is ``bytes */<total>``
            match = re.fullmatch(
                r"bytes \*/(\d+)", resp.headers.get("Content-Range", "")
            )
            return bool(match) and int(match.group(1)) == offset

        def _content_range(resp) -> "tuple | None":
            # satisfied-range form: ``bytes <start>-<end>/<total>``
            match = re.fullmatch(
                r"bytes (\d+)-(\d+)/(\d+)",
                resp.headers.get("Content-Range", ""),
            )
            return tuple(map(int, match.groups())) if match else None

        def _read_validator() -> str:
            try:
                with open(meta) as fh:
                    return fh.read().strip()
            except OSError:
                return ""

        def _remove_meta() -> None:
            try:
                os.remove(meta)
            except OSError:
                pass

        def _discard_partial() -> None:
            # order matters: the stale bytes must be gone BEFORE any new
            # validator is recorded — a crash between the two must never
            # leave a fresh validator paired with old-entity bytes
            try:
                os.remove(partial)
            except OSError:
                pass
            _remove_meta()

        def _write_validator(resp) -> None:
            validator = choose_validator(resp.headers)
            if validator:
                with open(meta, "w") as fh:
                    fh.write(validator)
            else:
                _remove_meta()

        async def _path_digest(path: str) -> "str | None":
            """md5 of the completed entity at ``path``, for the
            pre-promote recovery sidecar and ``job.landed_digests``.
            Free when the inline hasher provably saw every written
            byte; otherwise one read pass while the landing is still
            page-cache hot, billed to the ``hash`` hop."""
            if not hash_on_land:
                return None
            try:
                size = os.path.getsize(path)
            except OSError:
                return None
            hasher = land_hasher[0]
            if hasher is not None and hasher.nbytes == size:
                return hasher.hexdigest()
            mark = time.monotonic()
            # graftlint: disable=second-pass-read -- the blessed landing-site hash: resumed/spliced/segmented landings have no complete inline hasher, and the torn-tail recovery sidecar must hold the digest BEFORE the rename
            digest = await asyncio.to_thread(md5_file_hex, path)
            if record is not None:
                record.note_hop("hash", size, time.monotonic() - mark)
            return digest

        def _stamp_digest(digest: "str | None") -> None:
            digests = getattr(job, "landed_digests", None)
            if digest is not None and digests is not None:
                digests[os.path.abspath(output)] = digest

        def _note_sidecar(digest: "str | None") -> None:
            if digest is not None:
                scrub.note_landed(download_path,
                                  os.path.basename(output), digest)

        async def _promote() -> None:
            # crash-consistent publish: the entity's digest is first
            # persisted DURABLY to the workdir recovery sidecar
            # (.landed.json), THEN the data rename runs
            # fsync-before-rename through the VFS shim, off the loop
            # (a multi-GB landing's fsync would stall every other
            # job's transfer).  Boot recovery (store/scrub.py
            # verify_landed) re-hashes sidecar-named outputs and
            # demotes any mismatch — the torn-tail crash, where the
            # size still checks out but the tail pages never reached
            # the disk — back to re-fetch instead of serving the hole.
            digest = await _path_digest(partial)
            await asyncio.to_thread(_note_sidecar, digest)
            await asyncio.to_thread(vfs.promote, partial, output,
                                    key=output)
            _remove_meta()
            _stamp_digest(digest)

        def _decoder_for(resp):
            # the session never decompresses (auto_decompress=False) and we
            # ask for identity, but a misbehaving origin/CDN can still send
            # Content-Encoding — decode it rather than staging gzip bytes
            # as media.  MAX_WBITS|32 auto-detects gzip and zlib framing.
            enc = resp.headers.get("Content-Encoding", "").strip().lower()
            if enc in ("", "identity"):
                return None
            if enc in ("gzip", "x-gzip", "deflate"):
                return zlib.decompressobj(zlib.MAX_WBITS | 32)
            raise RuntimeError(f"unsupported Content-Encoding: {enc}")

        fetched = [0]  # cumulative across resume rounds, for the watchdog
        # hash-on-land carrier: the inline hasher (if the chunked write
        # loop ran start-to-finish) survives _fetch's return paths here
        land_hasher: list = [None]

        async def _settle_digest() -> None:
            """Stamp ``job.landed_digests[output]`` for the exit paths
            that never ran ``_promote`` (a validated pre-existing
            output from an earlier attempt), so the upload stage and
            the staged manifest never re-read the file just to hash it
            (the r3-r5 second pass).  Promoting paths stamped the
            digest — and the recovery sidecar — at promote time."""
            if not hash_on_land:
                return
            digests = getattr(job, "landed_digests", None)
            if digests is None:
                return  # job double without the carrier: nobody
                # downstream could consume the digest, don't burn a pass
            if os.path.abspath(output) in digests:
                return  # stamped (and sidecar-noted) at promote time
            try:
                size = os.path.getsize(output)
            except OSError:
                return
            mark = time.monotonic()
            # graftlint: disable=second-pass-read -- the blessed landing-site hash: bytes are hot in cache and this digest retires every later re-read
            digest = await asyncio.to_thread(md5_file_hex, output)
            if record is not None:
                record.note_hop("hash", size, time.monotonic() - mark)
            digests[os.path.abspath(output)] = digest
            await asyncio.to_thread(_note_sidecar, digest)

        def _note_origin_wait(mark: float) -> None:
            # request -> response-headers latency: the origin's
            # time-to-first-byte, billed as its own hop so "slow origin"
            # and "slow copy path" are separable in the ledger
            if record is not None:
                record.note_hop("origin_wait", 0, time.monotonic() - mark)

        async def _splice_body(resp, out_fd, offset=None, limit=None,
                               strict=True, progress=None) -> int:
            """Kernel-path body landing: socket -> pipe -> file, no
            userspace copies (see SPLICE_OK).  ~70% of staging CPU per
            byte was the two memcpys this skips (profiled r5).

            ``offset`` None writes at (and advances) the fd's own
            position; an int uses positioned writes — the segmented
            path shares ONE fd across concurrent segments.  ``limit``
            caps landed bytes (a segment must never write past its
            end; surplus response bytes die with the connection).
            ``strict`` raises on early EOF; the segmented caller
            instead returns short and lets its range loop re-request.
            ``progress`` (racing fetch) is called with each landed
            byte count; returning False stops the transfer early —
            the bytes already landed stay valid, the connection dies
            with the response.  Returns bytes landed."""
            import fcntl

            transport = resp.connection.transport
            # pause, drain aiohttp's buffer, pause AGAIN: draining can
            # re-enable reading behind our back (StreamReader's flow
            # control calls resume_reading when its buffer empties —
            # review r5), and the whole block is await-free so no
            # callback can feed more bytes in between.  After this,
            # every remaining body byte is still in the kernel.
            transport.pause_reading()
            head = resp.content.read_nowait(-1)
            transport.pause_reading()
            # the worker writes through a PRIVATE dup of the output fd,
            # owned (like the pipes) by the cleanup below: a
            # double-cancel can leave the worker inside os.splice after
            # the caller's fd is closed and its NUMBER recycled — with
            # a dup, the write lands in the right file description no
            # matter what the caller closed (review r5).  For
            # offset=None the dup shares the file offset, so
            # positionless writes still advance the caller's handle.
            out_dup = os.dup(out_fd)
            total = 0
            resp_left = resp.content_length - len(head)
            if resp_left < 0 and strict:
                # server closed early AND aiohttp buffered the truncated
                # body past content_length's promise — without this the
                # loop below is skipped (remaining <= 0) and a short
                # total returns silently, unlike the unbuffered path
                # which raises (advisor r5).  Close before raising: body
                # bytes are unaccounted, the connection can't be pooled.
                resp.close()
                os.close(out_dup)
                raise aiohttp.ClientPayloadError(
                    f"response over-delivered: buffered {len(head)} bytes "
                    f"against content-length {resp.content_length}")
            cap = (limit if limit is not None
                   else len(head) + max(resp_left, 0))
            pipe_r, pipe_w = os.pipe()
            abort_r, abort_w = os.pipe()
            cleaned = [False]

            def _cleanup(_fut=None) -> None:
                # idempotent; owns EVERY fd the worker touches plus the
                # response — it must only run once no worker thread can
                # still be inside poll/splice
                if cleaned[0]:
                    return
                cleaned[0] = True
                for fd in (pipe_r, pipe_w, abort_r, abort_w, out_dup):
                    os.close(fd)
                # body bytes were consumed behind aiohttp's parser: this
                # connection must never return to the pool
                resp.close()

            fut = None
            try:
                if head:
                    landed = min(len(head), cap)
                    write_mark = time.monotonic()
                    if offset is None:
                        _write_all(out_dup, memoryview(head)[:cap], None)
                    else:
                        # positioned head writes go to a worker like the
                        # streaming fallback's pwrites: a contended
                        # volume must not stall the event loop (r5)
                        await asyncio.to_thread(
                            _write_all, out_dup, memoryview(head)[:cap],
                            offset, True)
                    if record is not None:
                        record.note_hop("disk_write", landed,
                                        time.monotonic() - write_mark)
                    total = landed
                    fetched[0] += landed
                    watchdog.feed(fetched[0])
                    if limiter is not None:
                        await limiter.consume(landed)
                    if progress is not None and not progress(landed):
                        return total
                remaining = min(cap - total, resp_left)
                sock = transport.get_extra_info("socket")
                sock_fd = sock.fileno()
                if _rcvbuf_grow_ok():
                    try:
                        sock.setsockopt(socket.SOL_SOCKET,
                                        socket.SO_RCVBUF, _SPLICE_RCVBUF)
                    except OSError:
                        pass  # best-effort
                try:
                    fcntl.fcntl(pipe_w, fcntl.F_SETPIPE_SZ,
                                _SPLICE_PIPE_SIZE)
                except OSError:
                    pass  # pipe stays at the kernel default: just slower
                while remaining > 0:
                    cancel.raise_if_cancelled()
                    slice_mark = time.monotonic()
                    fut = asyncio.ensure_future(asyncio.to_thread(
                        _splice_slice_blocking, sock_fd, pipe_r, pipe_w,
                        out_dup, min(remaining, _SPLICE_SLICE),
                        STALL_TIMEOUT_SECONDS, abort_r,
                        None if offset is None else offset + total,
                    ))
                    try:
                        moved = await asyncio.shield(fut)
                    except asyncio.CancelledError:
                        # wake the worker and JOIN it before unwinding —
                        # cleanup closes fds it may still be using
                        os.write(abort_w, b"x")
                        try:
                            await fut
                        # graftlint: disable=swallowed-cancellation -- join guard only: the outer handler re-raises the first CancelledError
                        except BaseException:
                            # a SECOND cancellation can interrupt the
                            # join itself; the deferred-cleanup path in
                            # finally handles that case (review r5)
                            pass
                        raise
                    if record is not None and moved:
                        # one hop for the whole kernel path: socket ->
                        # pipe -> file never touches userspace, so there
                        # is no read/write boundary to attribute across
                        record.note_hop("splice", moved,
                                        time.monotonic() - slice_mark)
                    if moved == 0:
                        if not strict:
                            break  # segment range loop re-requests
                        raise aiohttp.ClientPayloadError(
                            f"connection closed {remaining} bytes early "
                            "during splice")
                    total += moved
                    remaining -= moved
                    fetched[0] += moved
                    watchdog.feed(fetched[0])
                    if limiter is not None:
                        await limiter.consume(moved)
                    if progress is not None and not progress(moved):
                        break
            finally:
                if fut is not None and not fut.done():
                    # join interrupted: the worker may still be in
                    # poll/splice — hand fd/response ownership to its
                    # completion callback instead of closing under it
                    # (fd-recycling corruption hazard)
                    os.write(abort_w, b"x")
                    fut.add_done_callback(_cleanup)
                else:
                    _cleanup()
            return total

        async def _stream_body(resp, mode: str, hasher=None) -> int:
            # the async face of the disk family: windowed ``disk`` rules
            # (latency/ENOSPC/EIO) drill the landing loop here, where a
            # brownout-style sleep is legal — the sync shim below only
            # enacts what a syscall can (drift.py windowed coverage)
            if faults.enabled():
                await faults.fire("disk.land", key=partial)
            total = 0
            decoder = _decoder_for(resp)
            use_splice = decoder is None and _spliceable(resp)
            open_mode = mode
            if use_splice and mode == "ab":
                # O_APPEND files are invalid splice targets (EINVAL);
                # resume instead via an explicit seek to the end
                open_mode = "r+b" if os.path.exists(partial) else "wb"
            # graftlint: disable=blocking-call-in-async -- one open(2); the body I/O below is awaited chunk/splice work
            with open(partial, open_mode, buffering=0) as fh:
                if open_mode == "r+b":
                    fh.seek(0, os.SEEK_END)
                if use_splice:
                    return await _splice_body(resp, fh.fileno())
                # hop ledger: socket_read = waiting on (and draining) the
                # response stream, disk_write = the write call itself.
                # Limiter sleeps are deliberate pacing, not a copy hop,
                # so the read clock restarts after each loop body.
                hop_mark = time.monotonic()
                async for raw in resp.content.iter_any():
                    if record is not None:
                        record.note_hop("socket_read", len(raw),
                                        time.monotonic() - hop_mark)
                    cancel.raise_if_cancelled()
                    if limiter is not None:
                        await limiter.consume(len(raw))
                    # watchdog tracks raw network progress; ``total`` counts
                    # decoded bytes written to disk
                    fetched[0] += len(raw)
                    watchdog.feed(fetched[0])
                    data = decoder.decompress(raw) if decoder else raw
                    if data:
                        write_mark = time.monotonic()
                        vfs.fh_write_all(fh, data, key=partial)
                        if record is not None:
                            record.note_hop("disk_write", len(data),
                                            time.monotonic() - write_mark)
                        if hasher is not None:
                            hasher.update(data)
                        total += len(data)
                    hop_mark = time.monotonic()
                if decoder is not None:
                    tail = decoder.flush()
                    if tail:
                        vfs.fh_write_all(fh, tail, key=partial)
                        if hasher is not None:
                            hasher.update(tail)
                        total += len(tail)
            return total

        # -- segmented (parallel ranged) fast path -------------------------
        seg_partial = output + ".partial-seg"
        seg_state_path = seg_partial + ".state"

        def _discard_segmented() -> None:
            # state FIRST: a crash between the removes must never leave a
            # live checkpoint pointing at a missing/zero-filled data file
            for path in (seg_state_path, seg_partial):
                try:
                    os.remove(path)
                except OSError:
                    pass

        async def _fetch_segmented(session, job: Job) -> "int | None":
            """Download with concurrent ranged connections — ``seg_count``
            lanes against one origin, or (origin plane,
            downloader_tpu_torch/origins/) work-stealing ranges RACED across
            the job's mirror set when ``Download.mirrors`` names
            redundant origins for this entity.

            Returns fetched bytes on success, or None when the entity
            isn't segmentable (no range support, no strong validator,
            encoded body, or too small) — the caller then runs the
            sequential path.  Every segment request carries If-Range, so
            a mid-flight entity change surfaces as a 200 and aborts the
            whole attempt instead of stitching two versions; a MIRROR
            whose probe disagrees with the primary's validator/length is
            excluded up front (it serves a different entity).

            Progress survives crashes: segment positions checkpoint to a
            ``.partial-seg.state`` sidecar every few seconds, and a
            redelivered job resumes each segment from its recorded
            position when the validator still matches — racing and
            single-origin runs share the state format, so either can
            resume the other's partial.
            """
            from ..origins.plan import OriginHealth, build_origin_set

            health = OriginHealth.shared(ctx.resources, ctx.config)
            origins = build_origin_set(
                resource_url, getattr(job, "mirrors", ()) or (),
                health=health,
            )
            probe_headers = {**base_headers, "Range": "bytes=0-0"}

            async def _probe_reference(origin) -> "tuple | None":
                """Probe one origin as the entity REFERENCE: 206 +
                strong validator + identity body, else None.

                With mirrors to fail over to, even the PRIMARY's probe
                is bounded (10 s): a black-holed primary must cost
                seconds before a mirror is promoted, not the 240 s
                watchdog (an explicit ``timeout=None`` would be
                UNBOUNDED in aiohttp — not the session default).  A
                lone origin keeps the session default, the legacy
                behavior."""
                kwargs = {}
                if not origin.primary or len(origins) > 1:
                    kwargs["timeout"] = aiohttp.ClientTimeout(total=10)
                request_mark = time.monotonic()
                async with session.get(
                    origin.url, headers=probe_headers, **kwargs
                ) as probe:
                    _note_origin_wait(request_mark)
                    if probe.status != 206:
                        return None  # no byte-range support
                    crange = _content_range(probe)
                    if crange is None:
                        return None
                    ref_validator = choose_validator(probe.headers)
                    if not ref_validator or _is_encoded(probe.headers):
                        return None
                    await probe.read()
                    return ref_validator, crange[2]

            # the PRIMARY defines the entity; a primary that cannot even
            # answer its probe fails over to the first mirror that can
            # (promoted to reference — the failover promise must cover
            # an origin that died before the job started), while a
            # primary that ANSWERS "not segmentable" keeps the legacy
            # sequential path (its entity stays authoritative).
            reference = None
            try:
                reference = await _probe_reference(origins[0])
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError) as err:
                if len(origins) == 1:
                    raise
                origins[0].dead = True
                logger.warn("primary origin probe failed; trying "
                            "mirrors", error=str(err)[:200])
                if record is not None:
                    record.event("origin_probe",
                                 origin=origins[0].label, ok=False,
                                 primary=True,
                                 reason=f"probe_failed: {str(err)[:80]}")
                for mirror in origins[1:]:
                    try:
                        reference = await _probe_reference(mirror)
                    except (aiohttp.ClientError, asyncio.TimeoutError,
                            OSError) as mirror_err:
                        if record is not None:
                            record.event(
                                "origin_probe", origin=mirror.label,
                                ok=False,
                                reason="probe_failed: "
                                       f"{str(mirror_err)[:80]}",
                            )
                        mirror.dead = True
                        continue
                    if reference is None:
                        mirror.dead = True  # answered, not segmentable
                        continue
                    # this mirror now DEFINES the entity: mid-flight
                    # changes on it abort the attempt like a primary's
                    mirror.primary = True
                    if record is not None:
                        record.event("origin_failover",
                                     origin=origins[0].label,
                                     promoted=mirror.label,
                                     what="reference_probe")
                    break
                if reference is None:
                    raise  # nobody could define the entity
            if reference is None:
                return None
            validator, total_len = reference
            reference_origin = next(o for o in origins if not o.dead)
            if total_len < SEG_MIN_SIZE and len(origins) == 1:
                # small entities aren't worth extra connections — unless
                # mirrors exist: racing's failover must cover small
                # files too, and one range is cheap
                return None
            if record is not None:
                record.event("origin_probe",
                             origin=reference_origin.label, ok=True,
                             primary=True, total=total_len,
                             bps=round(
                                 health.bps(reference_origin.label), 1))

            async def _probe_mirror(origin) -> None:
                """Admit a mirror only when it provably serves the SAME
                entity: 206, equal length, equal strong validator."""
                why = None
                try:
                    request_mark = time.monotonic()
                    async with session.get(
                        origin.url, headers=probe_headers,
                        timeout=aiohttp.ClientTimeout(total=10),
                    ) as resp:
                        _note_origin_wait(request_mark)
                        mirror_range = _content_range(resp)
                        if resp.status != 206 or mirror_range is None:
                            why = "no_range_support"
                        elif mirror_range[2] != total_len:
                            why = "length_mismatch"
                        elif choose_validator(resp.headers) != validator:
                            why = "validator_mismatch"
                        elif _is_encoded(resp.headers):
                            why = "encoded_body"
                        else:
                            await resp.read()
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        OSError) as err:
                    why = f"probe_failed: {str(err)[:80]}"
                if why is not None:
                    origin.dead = True
                    logger.warn("mirror excluded from racing",
                                origin=origin.label, reason=why)
                if record is not None:
                    record.event("origin_probe", origin=origin.label,
                                 ok=why is None, reason=why,
                                 bps=round(health.bps(origin.label), 1))

            unprobed = [o for o in origins
                        if not o.dead and o is not reference_origin]
            if unprobed:
                await asyncio.gather(*(_probe_mirror(o)
                                       for o in unprobed))
            racing = [o for o in origins if not o.dead]

            # segments are [start, pos, end): pos = next absolute byte
            segments = None
            try:
                # graftlint: disable=blocking-call-in-async -- sidecar checkpoint is a few hundred bytes
                with open(seg_state_path) as fh:
                    state = json.load(fh)  # graftlint: disable=blocking-call-in-async -- same tiny sidecar
                # the checkpoint is only as good as the data file it
                # describes: wrong/missing size means the positions are
                # lies (e.g. the big file was deleted to free disk)
                if (state.get("validator") == validator
                        and state.get("total") == total_len
                        and os.path.getsize(seg_partial) == total_len):
                    segments = [
                        [int(s[0]), int(s[1]), int(s[2])]
                        for s in state["segments"]
                    ]
                    resumed = sum(s[1] - s[0] for s in segments)
                    if resumed:
                        logger.info(
                            "http: resuming segmented download",
                            bytes_resumed=resumed, total=total_len,
                        )
            except (OSError, ValueError, KeyError, TypeError, IndexError):
                pass
            if segments is None:
                # racing wants more, smaller ranges than the per-origin
                # lane count: work-stealing balances load only at range
                # granularity, so ~4 ranges per origin (bounded: >= 2 MiB
                # each, <= 64 total) keeps a slow origin from holding a
                # quarter of the file
                lanes = seg_count
                if len(racing) > 1:
                    lanes = max(seg_count, min(len(racing) * 4, 64))
                span = -(-total_len // lanes)
                if len(racing) > 1:
                    span = max(span, 2 << 20)
                segments = [
                    [lo, lo, min(lo + span, total_len)]
                    for lo in range(0, total_len, span)
                ]
            # preflight AFTER the checkpoint: resumed bytes are credit,
            # or a resumable 80%-done download would fail forever on a
            # volume that can easily hold the remainder
            _ensure_disk_space(
                download_path,
                total_len - sum(s[1] - s[0] for s in segments),
            )
            logger.info(
                "http: segmented download", segments=len(segments),
                total=total_len,
            )

            def _write_state(blob: dict) -> None:
                tmp = seg_state_path + ".tmp"
                with open(tmp, "w") as fh:
                    json.dump(blob, fh)
                os.replace(tmp, seg_state_path)

            # one dedicated writer thread: pwrites and state checkpoints
            # leave the event loop (a contended volume must not stall
            # heartbeats/other jobs), stay ordered (single worker, so a
            # cancelled checkpoint write can never interleave with the
            # final one on the same tmp path), and can be drained to
            # completion before the fd closes — a plain to_thread write
            # cancelled mid-flight would keep running unsupervised
            io_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
            loop = asyncio.get_running_loop()

            # chunk landing primitive: io_uring ring when the knob AND
            # the probe both say yes, else plain pwrite.  The ring is
            # owned by (and only touched from) the single io_pool
            # writer thread; any ring-side failure falls back to
            # pwrite for that chunk (a real write error — ENOSPC,
            # EBADF — fails identically on both paths and propagates).
            uring_writer = None
            if use_io_uring:
                from ..utils import uring as _uring
                if _uring.available():
                    try:
                        uring_writer = _uring.UringWriter()
                    except (OSError, RuntimeError):
                        uring_writer = None
                if uring_writer is not None:
                    logger.info("http: io_uring chunk landing engaged")
            if uring_writer is not None:
                def _land_chunk(fd, data, off, _w=uring_writer):
                    try:
                        return _w.pwrite(fd, data, off)
                    except (OSError, RuntimeError):
                        # whole-chunk fallback (ring setup/teardown
                        # trouble); per-CQE short/EIO fallback lives
                        # inside UringWriter.pwrite itself
                        vfs.write_all(fd, data, off, thread_ok=True)
                        return len(data)
            else:
                def _land_chunk(fd, data, off):
                    vfs.write_all(fd, data, off, thread_ok=True)
                    return len(data)

            async def _save_state() -> None:
                # snapshot on the loop thread (segment tasks mutate
                # ``seg[1]`` between awaits), write in the worker
                blob = {
                    "validator": validator,
                    "total": total_len,
                    "segments": [list(s) for s in segments],
                }
                await loop.run_in_executor(io_pool, _write_state, blob)

            def _truncate() -> None:
                with open(seg_partial, "ab") as fh:
                    fh.truncate(total_len)

            await loop.run_in_executor(io_pool, _truncate)
            await _save_state()
            fd = os.open(seg_partial, os.O_WRONLY)

            async def _fetch_range(seg, url=resource_url,
                                   guard=None) -> None:
                """Fetch ``[seg[1], seg[2])`` from ``url`` into the
                shared fd at absolute offsets — the single-origin
                segment loop, parameterized so the racing scheduler can
                point it at any origin.  ``guard(delta) -> bool`` (the
                scheduler's merge/first-byte-wins hook) is consulted
                after every landed chunk; False stops the fetch with
                the landed bytes intact."""
                stopped = [False]

                def advance(n: int) -> bool:
                    seg[1] += n
                    if guard is None:
                        return True
                    ok = guard(n)
                    if not ok:
                        stopped[0] = True
                    return ok

                while seg[1] < seg[2] and not stopped[0]:
                    cancel.raise_if_cancelled()
                    if faults.enabled():
                        await faults.fire("origin.fetch", key=url)
                    before = seg[1]
                    headers = {
                        **base_headers,
                        "Range": f"bytes={seg[1]}-{seg[2] - 1}",
                        "If-Range": validator,
                    }
                    request_mark = time.monotonic()
                    async with session.get(
                        url, headers=headers
                    ) as resp:
                        _note_origin_wait(request_mark)
                        if resp.status == 200:
                            raise _EntityChangedDuringSegments()
                        if resp.status != 206:
                            resp.raise_for_status()
                            raise RuntimeError(
                                f"segmented: unexpected {resp.status}"
                            )
                        crange = _content_range(resp)
                        if crange is None or crange[0] != seg[1]:
                            raise RuntimeError(
                                "segmented: mis-ranged 206 "
                                f"{resp.headers.get('Content-Range')!r}"
                            )
                        if (_spliceable(resp)
                                and not _is_encoded(resp.headers)):
                            # kernel landing at the segment's offset;
                            # non-strict: a short/closed 206 just
                            # re-ranges like the streaming loop would.
                            # ``advance`` (not a post-hoc +=) keeps
                            # seg[1] honest while slices land, so the
                            # racing guard sees live progress.
                            await _splice_body(
                                resp, fd, offset=seg[1],
                                limit=seg[2] - seg[1], strict=False,
                                progress=advance)
                        else:
                            hop_mark = time.monotonic()
                            async for raw in resp.content.iter_any():
                                if record is not None:
                                    # per-segment busy time: concurrent
                                    # segments each bill their own wait,
                                    # so the hop sums are busy-seconds,
                                    # not wall (like CPU time)
                                    record.note_hop(
                                        "socket_read", len(raw),
                                        time.monotonic() - hop_mark)
                                cancel.raise_if_cancelled()
                                if limiter is not None:
                                    await limiter.consume(len(raw))
                                fetched[0] += len(raw)
                                watchdog.feed(fetched[0])
                                # never write past our segment: a peer
                                # segment owns the bytes after seg[2]
                                data = raw[:seg[2] - seg[1]]
                                write_mark = time.monotonic()
                                await loop.run_in_executor(
                                    io_pool, _land_chunk, fd, data,
                                    seg[1])
                                if record is not None:
                                    record.note_hop(
                                        "disk_write", len(data),
                                        time.monotonic() - write_mark)
                                if not advance(len(data)):
                                    break
                                if len(data) < len(raw):
                                    break  # server over-delivered; done
                                hop_mark = time.monotonic()
                    if stopped[0]:
                        return  # the scheduler ended this writer's turn
                    if seg[1] == before:
                        # a capped/empty 206 must still advance, else
                        # this loops forever against a broken origin
                        raise RuntimeError(
                            f"segmented: no progress at {seg[1]}"
                        )

            async def _checkpoint() -> None:
                while True:
                    await asyncio.sleep(SEG_STATE_INTERVAL)
                    await _save_state()

            saver = asyncio.create_task(_checkpoint())
            if len(racing) > 1:
                # origin plane: one work-stealing scheduler instead of
                # one task per segment — each origin pulls the next
                # pending range, stragglers get duplicated tails, and a
                # dying origin fails over without failing the job.  The
                # canonical triples are the SAME lists the checkpoint
                # snapshots, so crash-resume is unchanged.
                from ..origins.racing import RangeScheduler

                async def _race_fetch(origin, triple, guard) -> None:
                    await _fetch_range(triple, url=origin.url,
                                       guard=guard)

                scheduler = RangeScheduler(
                    racing, segments, _race_fetch,
                    retrier=retrier, health=health, cancel=cancel,
                    record=record, metrics=ctx.metrics, logger=logger,
                    config=ctx.config,
                )
                tasks = [asyncio.create_task(scheduler.run())]
            else:
                # one surviving origin (usually the primary; after a
                # reference promotion, the mirror that answered)
                tasks = [
                    asyncio.create_task(
                        _fetch_range(s, url=racing[0].url)
                    )
                    for s in segments
                ]
            try:
                await asyncio.gather(*tasks)
            finally:
                try:
                    # gather does NOT cancel siblings when one raises:
                    # every task must be settled BEFORE the fd closes, or
                    # an orphan segment pwrites into a closed (and soon
                    # reused) fd — which would corrupt the sequential
                    # fallback's file
                    for task in tasks:
                        task.cancel()
                    await asyncio.gather(*tasks, return_exceptions=True)
                    # likewise settle the saver so it can't resurrect the
                    # state file after the success path removes it
                    saver.cancel()
                    await asyncio.gather(saver, return_exceptions=True)
                    try:
                        await _save_state()
                    except OSError:
                        pass
                finally:
                    # drain the pool BEFORE the fd closes, even when a
                    # second cancellation interrupts any await above
                    # (this inner finally is the ONLY cleanup guaranteed
                    # to run on that path).  Synchronous on purpose: an
                    # await here could itself be interrupted, leaking
                    # the fd and the thread; pool shutdown also rejects
                    # any still-unsettled task's later submissions, so
                    # nothing can reach a closed fd.  The pending work
                    # is page-cache writes — the brief loop stall is
                    # confined to error teardown.
                    io_pool.shutdown(wait=True)
                    if uring_writer is not None:
                        uring_writer.close()
                    os.close(fd)
            # same crash-consistent publish as the sequential promote:
            # sidecar note durably BEFORE the rename.  Segments land by
            # positioned writes with no inline hasher (and a stale
            # sequential hasher from an earlier attempt must not be
            # trusted here), so the digest is one hot-cache pass.
            land_hasher[0] = None
            digest = await _path_digest(seg_partial)
            await asyncio.to_thread(_note_sidecar, digest)
            await asyncio.to_thread(vfs.promote, seg_partial, output,
                                    key=output)
            _stamp_digest(digest)
            try:
                os.remove(seg_state_path)
            except OSError:
                pass
            return fetched[0]

        async def _existing_output_ok(session) -> bool:
            """Validate a pre-existing completed file against the origin.

            Guards against a truncated ``output`` left by a non-atomic
            writer (older deployments wrote ``output`` directly): compare
            its size to the origin's Content-Length when a HEAD can tell
            us.  Unknowable (HEAD unsupported, no length, encoded body)
            -> trust the file.
            """
            try:
                async with session.head(
                    resource_url, headers=base_headers, allow_redirects=True
                ) as resp:
                    if resp.status != 200:
                        return True
                    if _is_encoded(resp.headers):
                        return True
                    length = resp.headers.get("Content-Length")
                    if length is None:
                        return True
                    return int(length) == os.path.getsize(output)
            except (aiohttp.ClientError, ValueError, OSError):
                return True

        async def _fetch() -> int:
            # large read buffer + iter_any: fewer loop wakeups and no
            # re-chunking copy on the hot path (this stage is the service's
            # bandwidth bottleneck)
            async with aiohttp.ClientSession(
                read_bufsize=_CHUNK, auto_decompress=False,
                trust_env=True,  # honor HTTP(S)_PROXY/NO_PROXY like the
                # reference's request lib (lib/download.js:159)
            ) as session:
                if os.path.exists(output):
                    # a previous attempt finished the download but the job
                    # died before settling (e.g. crash before upload acked)
                    if await _existing_output_ok(session):
                        logger.info(
                            "http: already downloaded, skipping", file=output
                        )
                        return 0
                    logger.warn(
                        "http: existing file fails size check, re-downloading",
                        file=output,
                    )
                    os.remove(output)
                # segmented fast path: when configured — or whenever the
                # job carries racing mirrors (origin plane) — and never
                # while a sequential .partial is mid-resume (finish what
                # the cheaper path started)
                from ..origins.plan import resolve_mirrors

                has_mirrors = bool(resolve_mirrors(
                    resource_url, getattr(job, "mirrors", ()) or ()
                ))
                if ((seg_count > 1 or has_mirrors)
                        and not os.path.exists(partial)):
                    try:
                        got = await _fetch_segmented(session, job)
                    except _EntityChangedDuringSegments:
                        logger.warn(
                            "http: entity changed mid-segments, restarting"
                        )
                        _discard_segmented()
                        got = None
                    if got is not None:
                        return got
                # a server may legally satisfy an open-ended range with a
                # capped 206 (fewer bytes than the remainder), so resuming
                # loops until the entity is complete; every round must
                # advance the offset or the attempt errors out
                while True:
                    cancel.raise_if_cancelled()
                    offset = (
                        os.path.getsize(partial)
                        if os.path.exists(partial)
                        else 0
                    )
                    validator = _read_validator() if offset else ""
                    if not (offset and validator):
                        break  # nothing resumable: full download below
                    headers = {
                        **base_headers,
                        "Range": f"bytes={offset}-",
                        "If-Range": validator,
                    }
                    request_mark = time.monotonic()
                    async with session.get(
                        resource_url, headers=headers
                    ) as resp:
                        _note_origin_wait(request_mark)
                        crange = _content_range(resp)
                        if (
                            resp.status == 206
                            and crange is not None
                            and crange[0] == offset
                            and not _is_encoded(resp.headers)
                        ):
                            start, end, total_len = crange
                            logger.info(
                                "http: resuming partial download",
                                offset=offset,
                                total=total_len,
                            )
                            got = await _stream_body(resp, "ab")
                            # promote on the bytes actually on disk — a
                            # close-delimited 206 can deliver fewer bytes
                            # than its Content-Range advertises without
                            # raising
                            if os.path.getsize(partial) >= total_len:
                                await _promote()
                                return fetched[0]
                            if got <= 0:
                                raise RuntimeError(
                                    "http resume made no progress at "
                                    f"offset {offset}"
                                )
                            continue  # short/capped 206: next range round
                        if resp.status == 200:
                            # entity changed (If-Range miss) or no range
                            # support: body is the full entity, restart on
                            # this response
                            _discard_partial()
                            try:
                                expected = int(
                                    resp.headers.get("Content-Length", 0)
                                )
                            except ValueError:
                                expected = 0
                            _ensure_disk_space(download_path, expected)
                            _write_validator(resp)
                            land_hasher[0] = (
                                _LandHasher(record) if hash_on_land
                                else None)
                            await _stream_body(resp, "wb",
                                               hasher=land_hasher[0])
                            await _promote()
                            return fetched[0]
                        if resp.status == 416:
                            # If-Range was sent, so a 416 means the
                            # validator matched; length == offset proves the
                            # partial is the complete entity
                            if _entity_complete(resp, offset):
                                await _promote()
                                return fetched[0]
                            # oversized/stale partial: clean restart below
                        elif resp.status != 206:
                            resp.raise_for_status()
                        # mis-ranged/unparseable 206 or stale 416: restart
                        break
                _discard_partial()
                request_mark = time.monotonic()
                async with session.get(
                    resource_url, headers=base_headers
                ) as resp:
                    _note_origin_wait(request_mark)
                    resp.raise_for_status()
                    try:
                        expected = int(resp.headers.get("Content-Length", 0))
                    except ValueError:
                        expected = 0
                    _ensure_disk_space(download_path, expected)
                    _write_validator(resp)
                    land_hasher[0] = (
                        _LandHasher(record) if hash_on_land else None)
                    await _stream_body(resp, "wb",
                                       hasher=land_hasher[0])
                    await _promote()
                    return fetched[0]

        async def _attempt() -> int:
            if faults.enabled():
                await faults.fire("http.fetch", key=resource_url)
            return await watchdog.watch(_fetch())

        # transient origin trouble retries in-process under the "http"
        # policy; ``fetched``/the .partial resume point persist across
        # attempts, so a retry continues the transfer instead of
        # restarting it.  A stall (ERRDLSTALL) passes straight through —
        # the orchestrator's drop policy owns it.
        total = await retrier.run("http", _attempt, cancel=cancel,
                                  record=ctx.record, logger=logger)
        if ctx.record is not None:
            ctx.record.add_bytes("downloaded", total)
        if ctx.metrics is not None:
            ctx.metrics.bytes_downloaded.labels(protocol="http").inc(total)
        # promote time: every _fetch exit path leaves the complete entity
        # at ``output`` (fresh promote, resumed promote, or a previous
        # attempt's validated file), so this IS the file's durable moment
        # — digest it while the bytes are hot, then announce
        await _settle_digest()
        await _announce_file(job, output)

    async def manifest(resource_url: str, file_id: str,
                       download_path: str, job: Job):
        """HLS-style segment-manifest ingest (origins/manifest.py):
        ``source_kind: MANIFEST`` jobs treat the http(s) source URI as a
        media playlist, landing each segment as its own durable file —
        announced into the FileStream the moment it completes, so the
        streaming pipeline stages early segments while later ones are
        still being produced (live) or still downloading (VOD).

        Mirrors are playlist-level: each ``Download.mirrors`` URL is
        that origin's copy of the playlist, and relative segment URIs
        resolve against whichever origin serves them (EWMA-ordered,
        first-byte hedge, per-origin breaker/retry seams).  No outer
        watchdog: a live playlist legitimately idles between segments,
        so liveness is the ingest's own ``origins.manifest.stall_timeout``
        (raised as ``ERRDLSTALL`` — the orchestrator's dead-stream
        drop policy, same as a stalled transfer).
        """
        from ..origins.manifest import ManifestIngest
        from ..origins.plan import OriginHealth, build_origin_set

        logger.info("manifest", url=resource_url)
        health = OriginHealth.shared(ctx.resources, ctx.config)
        origins = build_origin_set(
            resource_url, getattr(job, "mirrors", ()) or (),
            health=health,
        )

        async def progress(percent: int) -> None:
            await telemetry.emit_progress(file_id, downloading, percent)

        async def announce(path: str, size: int) -> None:
            await _announce_file(job, path, size)

        async with aiohttp.ClientSession(
            read_bufsize=_CHUNK, auto_decompress=False, trust_env=True,
        ) as session:
            ingest = ManifestIngest(
                origins, session, retrier=retrier, health=health,
                cancel=cancel, record=ctx.record, metrics=ctx.metrics,
                logger=logger, config=ctx.config, limiter=limiter,
                announce=announce, progress=progress,
            )
            total = await ingest.run(resource_url, download_path)
        if ctx.record is not None:
            ctx.record.add_bytes("downloaded", total)
        if ctx.metrics is not None:
            ctx.metrics.bytes_downloaded.labels(
                protocol="manifest").inc(total)
        logger.info("manifest complete", bytes=total)

    async def file(resource_url: str, file_id: str, download_path: str, job: Job):
        # (reference lib/download.js:177-189)
        if os.environ.get("ALLOW_FILE_URLS") != "true":
            raise PermissionError("File URLs are not allowed.")

        qualified = urllib.request.url2pathname(
            urllib.parse.urlparse(resource_url).path
        )
        output = os.path.join(download_path, os.path.basename(qualified))
        logger.debug("file copy", src=qualified, dst=output)
        os.makedirs(download_path, exist_ok=True)
        import shutil

        # off the loop: a file:// source is arbitrarily large media —
        # a synchronous copy would stall every other job's transfer for
        # the whole copy (graftlint blocking-call-in-async)
        await _join_offloaded(shutil.copyfile, qualified, output)
        if ctx.metrics is not None:
            ctx.metrics.bytes_downloaded.labels(protocol="file").inc(
                os.path.getsize(output)
            )
        await _announce_file(job, output)

    async def bucket(resource_url: str, file_id: str, download_path: str, job: Job):
        # (reference lib/download.js:199-227)
        logger.info("bucket", url=resource_url)
        params = parse_bucket_uri(resource_url)
        logger.info("bucket endpoint", endpoint=params["endpoint"])

        client = bucket_client_factory(
            params["endpoint"], params["access_key"], params["secret_key"]
        )
        try:
            sub_folder = params["sub_folder"]
            prefix = sub_folder.rstrip("/") + "/"
            total = 0
            # materialize the listing — and pre-create every local parent
            # directory — BEFORE the first byte moves: the streaming
            # filter's directory verdicts (notably the sole-top-level
            # rule) need the tree shape to be final when the first
            # per-object completion event fires
            items = []
            async for item in client.list_objects(params["bucket"], prefix):
                cancel.raise_if_cancelled()
                if not item.name:
                    continue
                # strip the subFolder prefix from the local path
                # (reference lib/download.js:223); object keys are untrusted
                # remote data, so drop dot segments that would escape
                # download_path (S3 keys may legally contain '..')
                relative = item.name.replace(sub_folder, "", 1)
                parts = [
                    p for p in relative.split("/") if p not in ("", ".", "..")
                ]
                if not parts:
                    continue
                items.append((item, os.path.join(download_path, *parts)))
            def _touch_placeholders() -> None:
                for _item, local in items:
                    os.makedirs(os.path.dirname(local), exist_ok=True)
                    # zero-byte placeholder: the media filter's
                    # sole-top-level rule counts root-level FILES in its
                    # directory listing too, so every local path — not
                    # just the directories — must exist before the first
                    # event or an incremental verdict could diverge from
                    # the authoritative walk's.  fget truncates on
                    # write, and events only fire for fully-fetched
                    # objects, so a placeholder is never read as content.
                    with open(local, "ab"):
                        pass

            # off the loop: a few syscalls per object is real stall time
            # on a 200-object bucket (graftlint blocking-call-in-async)
            await _join_offloaded(_touch_placeholders)
            # live per-chunk transfer counters (ObjectStore.fget_object
            # progress callback): a multi-GB object is then visibly
            # moving in GET /v1/jobs/{id}/events instead of flat until
            # its final byte
            moved = [0]

            async def _on_chunk(n: int) -> None:
                moved[0] += n
                if ctx.record is not None:
                    ctx.record.note_transfer("download", total + moved[0])

            for item, local in items:
                cancel.raise_if_cancelled()
                logger.info("bucket fetch", object=item.name, to=local)
                moved[0] = 0
                fetch_mark = time.monotonic()
                await client.fget_object(params["bucket"], item.name,
                                         local, progress=_on_chunk)
                if ctx.record is not None:
                    # one combined hop: the driver streams socket -> disk
                    # inside fget, so read/write are not separable here
                    ctx.record.note_hop("bucket_fetch", item.size,
                                        time.monotonic() - fetch_mark)
                total += item.size
                if ctx.record is not None:
                    ctx.record.note_transfer("download", total)
                # per-object completion: the fget streamed to completion,
                # so this object's local file is durable
                await _announce_file(job, local, item.size)
            if ctx.record is not None:
                ctx.record.add_bytes("downloaded", total)
            if ctx.metrics is not None:
                ctx.metrics.bytes_downloaded.labels(protocol="bucket").inc(total)
        finally:
            closer = getattr(client, "close", None)
            if closer is not None:
                await closer()

    methods = {"torrent": torrent, "http": http, "file": file, "bucket": bucket}

    # -- content-addressed staging cache + singleflight -----------------
    # Shared across every job via ctx.resources: the orchestrator injects
    # its instance (possibly None = disabled); standalone stage use (tests,
    # one-shot CLI) builds one from config on first touch.  N same-content
    # jobs — concurrent or sequential — pay for at most one download.
    if "content_cache" not in ctx.resources:
        ctx.resources["content_cache"] = ContentCache.from_config(
            ctx.config, logger=logger
        )
    cache: "ContentCache | None" = ctx.resources["content_cache"]
    flights: Singleflight = ctx.resources.setdefault(
        "cache_singleflight", Singleflight()
    )

    def _probe_session() -> aiohttp.ClientSession:
        """One shared keep-alive session for HEAD revalidation probes:
        under fan-in every job probes the same origin, so per-probe
        session/connection setup is pure per-job overhead.  Memoized
        across jobs in ctx.resources; closed at orchestrator shutdown."""
        session = ctx.resources.get("cache_probe_session")
        if session is None or session.closed:
            session = aiohttp.ClientSession(trust_env=True)
            ctx.resources["cache_probe_session"] = session

            async def _close(session=session) -> None:
                await session.close()

            ctx.cleanups.append(_close)
        return session

    async def cache_identity(protocol: str, url: str) -> "str | None":
        """Content key for this source; None = not cacheable.

        - torrent magnets: the infohash IS the content address (and the
          client verifies every piece against it before the fill).
        - http: URL + strong RFC-7232 validator from a HEAD probe
          (``choose_validator``'s strict rules) — no validator means no
          way to prove two fetches returned the same entity, so no
          caching.  ``.torrent`` URLs chain to the torrent method and are
          keyed there only via magnets.
        - bucket: endpoint + bucket + subFolder + the job's credentials
          (hashed): only jobs presenting the same credentials share an
          entry, so a cache hit never hands out bytes the job couldn't
          have fetched itself.  Object stores feeding this pipeline
          publish immutable media, the same assumption the idempotency
          marker already makes.
        - file: local copies are already cheap; never cached.
        """
        if cache is None:
            return None
        if protocol == "torrent" and url.startswith("magnet:"):
            try:
                from ..torrent.magnet import parse_magnet

                return cache_key("torrent", parse_magnet(url).info_hash_hex)
            except ValueError:
                return None
        if protocol == "http":
            parsed = urllib.parse.urlparse(url)
            if posixpath.splitext(parsed.path)[1] == ".torrent":
                return None
            try:
                session = _probe_session()
                async with session.head(
                    url, allow_redirects=True,
                    headers={"Accept-Encoding": "identity"},
                    # a black-holed origin must cost seconds, not the
                    # session's 5-minute default, before the real fetch
                    timeout=aiohttp.ClientTimeout(total=10),
                ) as resp:
                    if resp.status != 200:
                        return None
                    validator = choose_validator(resp.headers)
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError):
                return None  # probe trouble never blocks the real fetch
            if not validator:
                return None
            return cache_key("http", url, validator)
        if protocol == "bucket":
            try:
                params = parse_bucket_uri(url)
            except ValueError:
                return None
            # credentials ARE part of the key identity: a job may only
            # hit entries filled under the same credentials, so a job
            # whose keys were revoked (or wrong) can never be served
            # bytes it couldn't fetch itself (key material is hashed,
            # so secrets never appear on disk)
            return cache_key("bucket", params["endpoint"], params["bucket"],
                             params["sub_folder"], params["access_key"],
                             params["secret_key"])
        return None

    async def materialize_hit(key: str, download_path: str, job: Job,
                              *, coalesced: bool) -> bool:
        """Serve the job from the cache; False = miss (or entry lost).

        A hit stamps ``job.cache_files`` with the materialized paths so
        downstream (process stage, streaming reconcile) serves from the
        known list instead of re-walking the workdir, and bills the
        ``cache`` hop with the measured link wall — the hop-budget
        ratchet sees cache serving get cheaper, not vanish.
        """
        entry = await cache.lookup(key)
        if entry is None:
            return False
        with ctx.tracer.span("stage.download.cache", key=key[:16]) as span:
            mark = time.monotonic()
            materialized = await cache.materialize_entry(key, download_path)
            got = materialized[0] if materialized is not None else None
            outcome = ("lost" if got is None
                       else ("coalesced" if coalesced else "hit"))
            span.set_tag("outcome", outcome)
        if ctx.record is not None:
            ctx.record.event("cache", outcome=outcome, key=key[:16],
                             bytes=got or 0)
        if got is None:
            return False  # evicted between lookup and link: treat as miss
        job.cache_files = materialized[1]
        if ctx.record is not None:
            ctx.record.note_hop("cache", got, time.monotonic() - mark)
        if ctx.metrics is not None:
            if not coalesced:
                ctx.metrics.cache_hits.inc()
            ctx.metrics.cache_bytes_saved.inc(got)
        logger.info("download served from staging cache",
                    key=key[:16], bytes=got, coalesced=coalesced)
        return True

    async def cached_download(key: str, method, url: str, file_id: str,
                              download_path: str, job: Job) -> None:
        """Probe -> singleflight -> fetch -> fill, for a cacheable key.

        With a fleet plane attached (fleet/plane.py, via the
        orchestrator's stage_resources) the in-process singleflight
        LEADER additionally coordinates fleet-wide before touching the
        origin: shared-tier probe, then the content lease — losers park
        and materialize the winning worker's publish instead of
        duplicating the download.  Coordination trouble degrades to
        exactly the pre-fleet behavior.
        """
        # warm path: no network at all (acceptance: a warm-cache job
        # never re-fetches — only the HEAD revalidation above ran)
        if await materialize_hit(key, download_path, job, coalesced=False):
            return

        async def origin_fill(report) -> None:
            """Fetch from the origin into the workdir + fill the cache."""
            if ctx.metrics is not None:
                ctx.metrics.cache_misses.inc()
            with ctx.tracer.span("stage.download.cache", key=key[:16]) as span:
                span.set_tag("outcome", "miss")
            if ctx.record is not None:
                ctx.record.event("cache", outcome="miss", key=key[:16])
            job.cache_report = report  # torrent progress feeds waiters
            try:
                report(0)
                await method(url, file_id, download_path, job)
                report(50)
            finally:
                job.cache_report = None
            # fill AFTER the fetch completed (torrent pieces are SHA-1
            # verified by the client; http promoted its .partial only on
            # a complete body) — a failed fetch raises before this, so a
            # partial workdir is never inserted.  A fill failure (disk)
            # must not fail a job that already has its bytes.
            try:
                entry = await cache.insert(
                    key, download_path,
                    digests=_landed_rel_digests(job, download_path))
                if ctx.record is not None:
                    ctx.record.event("cache", outcome="fill", key=key[:16],
                                     bytes=entry.size if entry else 0)
            except OSError as err:
                logger.warn("cache fill failed", error=str(err))
                if ctx.record is not None:
                    ctx.record.event("cache", outcome="fill_failed",
                                     key=key[:16], error=str(err)[:120])

        async def leader_fetch(report) -> None:
            # re-probe under the flight: a previous leader may have
            # filled the key while this job queued for leadership
            if await materialize_hit(key, download_path, job, coalesced=False):
                return
            fleet = ctx.resources.get("fleet_plane")
            if fleet is not None:
                async def _led_fill() -> None:
                    # the fetch every parked waiter is actually waiting
                    # on, as a named span in THIS job's trace — the
                    # lease doc carries our traceparent, so a waiter's
                    # assembled trace (GET /v1/trace) shows this span
                    # under the leader's worker id
                    with ctx.tracer.span("fleet.origin_fetch",
                                         key=key[:16]):
                        await origin_fill(report)

                # the admission-edge routing identity rides the lease
                # doc (fleet/router.py computes the identical hash from
                # the message alone), so every peer's watch-fed lease
                # view can steer same-content deliveries here while
                # this fetch leads
                from ..fleet.router import route_key_for
                outcome = await fleet.coordinate(
                    key, cache, _led_fill,
                    cancel=cancel, record=ctx.record,
                    registry=ctx.resources.get("job_registry"),
                    slot=ctx.slot, logger=logger,
                    route_key=route_key_for(url),
                )
                if outcome == "led":
                    return  # origin_fill ran under our lease
                if outcome == "shared":
                    # a peer worker's bytes landed in the LOCAL cache:
                    # serve this job (and the flight's waiters) from it
                    if await materialize_hit(key, download_path, job,
                                             coalesced=False):
                        return
                    # evicted between fill and link: fetch ourselves
                # "uncoordinated": coordination store unavailable or the
                # wait bound hit — fall through to the lone-worker path
            await origin_fill(report)

        async def waiter_progress(percent: int) -> None:
            await telemetry.emit_progress(file_id, downloading, percent)

        led = await flights.run(key, leader_fetch,
                                on_wait_progress=waiter_progress)
        if not led:
            # coalesced onto another job's fetch; take the bytes from the
            # cache it just filled
            if ctx.metrics is not None:
                ctx.metrics.cache_coalesced.inc()
            if not await materialize_hit(key, download_path, job, coalesced=True):
                # leader succeeded but its fill wasn't usable (nothing
                # cacheable, fill error, instant eviction): fetch alone
                logger.warn("coalesced fetch left no cache entry; "
                            "falling back to own download", key=key[:16])
                if ctx.record is not None:
                    ctx.record.event("cache", outcome="fallback",
                                     key=key[:16])
                await method(url, file_id, download_path, job)

    async def download(job: Job):
        media = job.media
        file_id = media.id
        cancel.raise_if_cancelled()

        download_path = job_download_dir(ctx.config, file_id)

        url = media.source_uri
        protocol = schemas.enum_to_string(schemas.SourceType, media.source)

        try:
            os.makedirs(download_path, exist_ok=True)
            logger.info("created downloadPath", path=download_path)
        except OSError as err:
            logger.error("Failed to create directory", error=str(err))

        logger.info("starting download", protocol=protocol, url=url)

        await telemetry.emit_progress(file_id, downloading, 0)

        method = methods.get(protocol.lower())
        if method is None:
            raise ValueError("Protocol not supported.")
        # origin plane: Download.source_kind steers interpretation of
        # the URI.  MANIFEST rides the http transport but is its own
        # ingest loop; AUTO/DIRECT keep the historical dispatch.
        source_kind = (getattr(job, "source_kind", "AUTO")
                       or "AUTO").upper()
        if source_kind == "MANIFEST":
            if protocol.lower() != "http":
                raise ValueError(
                    "source_kind MANIFEST requires an http(s) source"
                )
            method = manifest

        with ctx.tracer.span("stage.download", protocol=protocol, mediaId=file_id):
            try:
                # live manifests are not immutable content: never cached
                key = (None if source_kind == "MANIFEST"
                       else await cache_identity(protocol.lower(), url))
                if key is None:
                    await method(url, file_id, download_path, job)
                else:
                    await cached_download(
                        key, method, url, file_id, download_path, job
                    )
            except Exception as err:
                logger.error("Download error", error=str(err))
                raise

        logger.info("finished download")
        await telemetry.emit_progress(file_id, downloading, 50)
        return {"path": download_path}

    return download
