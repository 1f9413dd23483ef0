"""S3-compatible object-store driver (AWS Signature V4 over aiohttp).

The reference talks to MinIO through the ``minio`` npm client
(upstream lib/main.js:41, lib/download.js:210-215,
lib/upload.js:20); this is the equivalent driver, implemented directly
against the S3 REST API so the framework has no extra dependencies.
Implements exactly the surface :class:`~downloader_tpu_torch.store.base.ObjectStore`
defines: bucket head/create, object get/put (bytes and files), and
ListObjectsV2 with prefix + continuation pagination.

Works against MinIO, AWS S3, GCS interop mode, or the in-repo test server
(``tests/minis3.py``).
"""

from __future__ import annotations

import asyncio
import base64
import datetime
import errno
import hashlib
import hmac
import mmap
import os
import re
import socket
import urllib.parse
import xml.etree.ElementTree as ET
from typing import AsyncIterator, Dict, Optional

import aiohttp
import yarl

from ..platform.errors import PERMANENT, TRANSIENT, tag_fault
from .base import ObjectInfo, ObjectNotFound, ObjectStore

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()

# get_object / get_object_versioned are the CONTROL-plane fetch (done
# markers, fleet manifests, coordination docs) and buffer the body in
# memory; media-sized objects must go through the streaming
# fget_object.  The cap turns "someone pointed the doc fetch at a
# 40 GB object" into a loud, immediate error instead of an OOM.
GET_OBJECT_MAX_BYTES = 64 << 20


def _status_error(op: str, status: int, body: bytes = b"") -> RuntimeError:
    """S3 error carrying its taxonomy class (platform/errors.py): 5xx /
    408 / 429 are dependency blips worth a retry; other 4xx repeat
    deterministically and must fail fast."""
    err = RuntimeError(f"{op} failed: {status} {body!r}")
    err.fault_class = (TRANSIENT if status >= 500 or status in (408, 429)
                       else PERMANENT)
    return err


def _uri_encode(value: str, encode_slash: bool = True) -> str:
    safe = "-_.~" if encode_slash else "-_.~/"
    return urllib.parse.quote(value, safe=safe)


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


class SigV4Signer:
    """AWS Signature Version 4 for S3 (single-chunk, signed payload)."""

    def __init__(self, access_key: str, secret_key: str, region: str = "us-east-1"):
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.service = "s3"

    def sign(
        self,
        method: str,
        host: str,
        path: str,
        query: Dict[str, str],
        payload_hash: str,
        now: Optional[datetime.datetime] = None,
    ) -> Dict[str, str]:
        """Return the headers (including Authorization) for the request."""
        now = now or datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        date_stamp = now.strftime("%Y%m%d")

        canonical_query = "&".join(
            f"{_uri_encode(k)}={_uri_encode(v)}" for k, v in sorted(query.items())
        )
        headers = {
            "host": host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        signed_headers = ";".join(sorted(headers))
        canonical_headers = "".join(
            f"{k}:{headers[k].strip()}\n" for k in sorted(headers)
        )
        # ``path`` must arrive already URI-encoded (S3 canonical URIs are
        # encoded exactly once; re-encoding here would corrupt '%')
        canonical_request = "\n".join(
            [
                method,
                path,
                canonical_query,
                canonical_headers,
                signed_headers,
                payload_hash,
            ]
        )
        scope = f"{date_stamp}/{self.region}/{self.service}/aws4_request"
        string_to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode("utf-8")).hexdigest(),
            ]
        )
        key = _hmac(
            _hmac(
                _hmac(
                    _hmac(("AWS4" + self.secret_key).encode("utf-8"), date_stamp),
                    self.region,
                ),
                self.service,
            ),
            "aws4_request",
        )
        signature = hmac.new(
            key, string_to_sign.encode("utf-8"), hashlib.sha256
        ).hexdigest()
        authorization = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        )
        return {
            "Authorization": authorization,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }


class S3ObjectStore(ObjectStore):
    """Path-style S3 client: ``<endpoint>/<bucket>/<key>``."""

    # defaults for the multipart knobs (config: store.multipart_part_size /
    # store.multipart_concurrency); 64 MiB parts match the common S3 client
    # defaults, 5 MiB is the API's hard minimum part size
    DEFAULT_PART_SIZE = 64 << 20
    DEFAULT_MULTIPART_CONCURRENCY = 3
    MIN_PART_SIZE = 5 << 20

    @classmethod
    def from_endpoint(
        cls,
        endpoint: str,
        access_key: str = "",
        secret_key: str = "",
        ssl: bool = True,
        region: str = "us-east-1",
        multipart_part_size: Optional[int] = None,
        multipart_concurrency: Optional[int] = None,
        zero_copy: bool = True,
    ) -> "S3ObjectStore":
        """Build from a host[:port] or full URL; an explicit scheme wins,
        otherwise ``ssl`` picks https/http."""
        if "://" not in endpoint:
            scheme = "https" if ssl else "http"
            endpoint = f"{scheme}://{endpoint}"
        return cls(endpoint, access_key, secret_key, region,
                   multipart_part_size=multipart_part_size,
                   multipart_concurrency=multipart_concurrency,
                   zero_copy=zero_copy)

    def __init__(
        self,
        endpoint: str,
        access_key: str = "",
        secret_key: str = "",
        region: str = "us-east-1",
        session: Optional[aiohttp.ClientSession] = None,
        multipart_part_size: Optional[int] = None,
        multipart_concurrency: Optional[int] = None,
        zero_copy: bool = True,
    ):
        self.endpoint = endpoint.rstrip("/")
        parsed = urllib.parse.urlparse(self.endpoint)
        self._host = parsed.netloc
        self._signer = SigV4Signer(access_key, secret_key, region)
        self._session = session
        # multipart kicks in above the threshold (= the part size, so no
        # object ever uploads as a single part bigger than a part).
        # Misconfiguration fails loudly, like the rate-limit knobs: a
        # part size under the S3 API's 5 MiB floor would be rejected by
        # the server at complete time with a far less obvious error.
        # None = unset; an explicit 0 must hit the validation below, not
        # silently coerce to the default
        part_size = (self.DEFAULT_PART_SIZE if multipart_part_size is None
                     else int(multipart_part_size))
        if part_size < self.MIN_PART_SIZE:
            raise ValueError(
                f"multipart_part_size must be >= {self.MIN_PART_SIZE} "
                f"(S3 minimum part size), got {part_size}"
            )
        concurrency = (self.DEFAULT_MULTIPART_CONCURRENCY
                       if multipart_concurrency is None
                       else int(multipart_concurrency))
        if concurrency < 1:
            raise ValueError(
                f"multipart_concurrency must be >= 1, got {concurrency}"
            )
        self.multipart_threshold = part_size
        self.multipart_part_size = part_size
        self.multipart_concurrency = concurrency
        # zero-copy staging (config: store.zero_copy, default on):
        # multipart parts are fed from an mmap of the source file
        # (UNSIGNED-PAYLOAD signing, so no hashing pass either) instead
        # of being read into fresh userspace buffers, and — on a plain
        # http endpoint, where the transport allows it — single PUTs and
        # parts go out via os.sendfile so body bytes never transit
        # userspace at all.  Off = the byte-exact read() path everywhere.
        self.zero_copy = bool(zero_copy)
        self._scheme = parsed.scheme or "https"

    async def _ensure_session(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession()
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    async def _request(
        self,
        method: str,
        path: str,
        query: Optional[Dict[str, str]] = None,
        data: bytes = b"",
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> aiohttp.ClientResponse:
        query = query or {}
        payload_hash = (
            _EMPTY_SHA256 if not data else hashlib.sha256(data).hexdigest()
        )
        headers = self._signer.sign(method, self._host, path, query, payload_hash)
        if extra_headers:
            # merged AFTER signing: conditional headers (If-Match /
            # If-None-Match) are not part of the canonical request, so
            # the signature stays valid with or without them
            headers = {**headers, **extra_headers}
        session = await self._ensure_session()
        url = f"{self.endpoint}{path}"
        if query:
            # identical encoding to the canonical query string, and the URL is
            # marked pre-encoded so yarl can't rewrite what was signed
            url += "?" + "&".join(
                f"{_uri_encode(k)}={_uri_encode(v)}" for k, v in sorted(query.items())
            )
        return await session.request(
            method, yarl.URL(url, encoded=True), headers=headers, data=data
        )

    # -- ObjectStore surface -------------------------------------------
    async def bucket_exists(self, bucket: str) -> bool:
        resp = await self._request("HEAD", f"/{bucket}")
        resp.release()
        return resp.status == 200

    async def make_bucket(self, bucket: str) -> None:
        resp = await self._request("PUT", f"/{bucket}")
        body = await resp.read()
        if resp.status not in (200, 204) and b"BucketAlreadyOwnedByYou" not in body:
            raise _status_error(f"make_bucket({bucket})", resp.status, body)

    def _object_path(self, bucket: str, name: str) -> str:
        return f"/{bucket}/" + "/".join(
            urllib.parse.quote(part, safe="") for part in name.split("/")
        )

    async def _read_capped(self, resp, op: str, bucket: str,
                           name: str) -> bytes:
        """Drain a GET body with a hard in-memory cap.

        ``resp.read()`` buffers however much the server sends; pointing
        the control-plane fetch at a media-sized object used to mean an
        unbounded allocation.  Chunked accumulation up to
        ``GET_OBJECT_MAX_BYTES`` keeps the failure mode a deterministic
        PERMANENT error naming the streaming alternative."""
        declared = int(resp.headers.get("Content-Length") or 0)
        if declared > GET_OBJECT_MAX_BYTES:
            resp.close()  # abort: draining the body is the very cost
            err = RuntimeError(
                f"{op}({bucket}/{name}): object is {declared} bytes, over "
                f"the {GET_OBJECT_MAX_BYTES}-byte in-memory cap — stream "
                "it with fget_object instead")
            err.fault_class = PERMANENT
            raise err
        chunks, total = [], 0
        async for chunk in resp.content.iter_chunked(1 << 20):
            total += len(chunk)
            if total > GET_OBJECT_MAX_BYTES:
                resp.close()  # abort: draining the body is the very cost
                err = RuntimeError(
                    f"{op}({bucket}/{name}): body exceeded the "
                    f"{GET_OBJECT_MAX_BYTES}-byte in-memory cap — stream "
                    "it with fget_object instead")
                err.fault_class = PERMANENT
                raise err
            chunks.append(chunk)
        return b"".join(chunks)

    async def get_object(self, bucket: str, name: str) -> bytes:
        resp = await self._request("GET", self._object_path(bucket, name))
        if resp.status == 404:
            resp.release()
            raise ObjectNotFound(bucket, name)
        if resp.status != 200:
            raise _status_error("get_object", resp.status,
                                await resp.read())
        return await self._read_capped(resp, "get_object", bucket, name)

    async def put_object(self, bucket: str, name: str, data: bytes) -> None:
        resp = await self._request("PUT", self._object_path(bucket, name), data=data)
        body = await resp.read()
        if resp.status not in (200, 204):
            raise _status_error("put_object", resp.status, body)

    async def get_object_versioned(self, bucket: str, name: str):
        resp = await self._request("GET", self._object_path(bucket, name))
        if resp.status == 404:
            resp.release()
            raise ObjectNotFound(bucket, name)
        if resp.status != 200:
            raise _status_error("get_object_versioned", resp.status,
                                await resp.read())
        body = await self._read_capped(resp, "get_object_versioned",
                                       bucket, name)
        return body, resp.headers.get("ETag", "").strip('"')

    async def put_object_cas(self, bucket: str, name: str, data: bytes, *,
                             if_match: Optional[str] = None,
                             if_none_match: bool = False) -> Optional[str]:
        """S3 conditional write (AWS since 2024-08, MinIO, R2): 412 /
        409 = precondition failed = lost the race, reported as ``None``
        rather than raised — losing a CAS is the caller's normal flow."""
        headers: Dict[str, str] = {}
        if if_none_match:
            headers["If-None-Match"] = "*"
        elif if_match is not None:
            headers["If-Match"] = f'"{if_match}"'
        resp = await self._request(
            "PUT", self._object_path(bucket, name), data=data,
            extra_headers=headers,
        )
        body = await resp.read()
        if resp.status in (409, 412):
            return None
        if resp.status not in (200, 204):
            raise _status_error("put_object_cas", resp.status, body)
        etag = resp.headers.get("ETag", "").strip('"')
        if not etag:
            # a backend that accepted the write but returned no ETag:
            # recover the token with a stat so the caller can CAS again
            try:
                etag = (await self.stat_object(bucket, name)).etag
            except ObjectNotFound:
                etag = ""
        return etag

    async def remove_object(self, bucket: str, name: str) -> None:
        resp = await self._request(
            "DELETE", self._object_path(bucket, name)
        )
        body = await resp.read()
        # S3 DELETE is idempotent: 204 whether or not the key existed;
        # tolerate an explicit 404 from stricter fakes
        if resp.status not in (200, 204, 404):
            raise _status_error("remove_object", resp.status, body)

    async def fget_object(self, bucket: str, name: str, file_path: str,
                          *, progress=None) -> None:
        """Streaming GET straight to disk — media files can be tens of GB,
        so the body must never be buffered whole in memory.

        ``progress`` is an optional ``async (bytes_moved)`` callback
        fired after each chunk lands on disk, so callers (the download
        stage's ``bucket`` method, the fleet shared tier) can keep live
        transfer counters moving during a multi-GB object instead of
        jumping once at the end."""
        path = self._object_path(bucket, name)
        resp = await self._request("GET", path)
        try:
            if resp.status == 404:
                raise ObjectNotFound(bucket, name)
            if resp.status != 200:
                body = await resp.read()
                raise _status_error("fget_object", resp.status, body)
            os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
            # graftlint: disable=blocking-call-in-async -- one open(2); the download loop below awaits per chunk
            with open(file_path, "wb") as fh:
                async for chunk in resp.content.iter_chunked(1 << 20):
                    fh.write(chunk)
                    if progress is not None:
                        await progress(len(chunk))
        finally:
            resp.release()

    # -- zero-copy upload transport ------------------------------------
    def _sendfile_eligible(self) -> bool:
        """True when PUT bodies can ride ``os.sendfile`` straight from
        the page cache into the socket: the zero-copy knob is on, the
        endpoint is plain http (TLS encrypts in userspace, so there is
        nothing to splice), and the platform has sendfile at all."""
        return (self.zero_copy and self._scheme == "http"
                and hasattr(os, "sendfile"))

    def _signed_url(self, path: str, query: Dict[str, str]) -> yarl.URL:
        url = f"{self.endpoint}{path}"
        if query:
            # identical encoding to the canonical query string (and to
            # _request): pre-encoded so yarl can't rewrite what was signed
            url += "?" + "&".join(
                f"{_uri_encode(k)}={_uri_encode(v)}"
                for k, v in sorted(query.items())
            )
        return yarl.URL(url, encoded=True)

    async def _sendfile_put(self, path: str, query: Dict[str, str],
                            file_path: str, offset: int,
                            count: int, extra_headers=None):
        """One plain-HTTP PUT whose body is fed by ``os.sendfile`` —
        file bytes go page cache -> socket without ever entering
        userspace (the kernel half of the zero-copy upload path).

        Speaks just enough HTTP/1.1 for the S3 PUT surface: one
        request, ``Connection: close``, a status line + headers +
        Content-Length (or EOF) delimited body back.  Returns
        ``(status, headers_dict, body)``.  Any transport error
        propagates — the caller falls back to the byte-exact
        buffered path."""
        loop = asyncio.get_running_loop()
        headers = self._signer.sign("PUT", self._host, path, query,
                                    "UNSIGNED-PAYLOAD")
        # aiohttp adds these implicitly; raw HTTP must spell them out
        # (Host is part of the signed canonical headers)
        headers["Host"] = self._host
        headers["Content-Length"] = str(count)
        headers["Connection"] = "close"
        if extra_headers:
            headers = {**headers, **extra_headers}
        request_uri = path
        if query:
            request_uri += "?" + "&".join(
                f"{_uri_encode(k)}={_uri_encode(v)}"
                for k, v in sorted(query.items()))
        head = (f"PUT {request_uri} HTTP/1.1\r\n"
                + "".join(f"{k}: {v}\r\n" for k, v in headers.items())
                + "\r\n").encode("ascii")

        host, _, port = self._host.partition(":")
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setblocking(False)
            await loop.sock_connect(sock, (host, int(port or 80)))
            await loop.sock_sendall(sock, head)
            if count:
                # graftlint: disable=blocking-call-in-async -- one open(2); the body transfer below is awaited sendfile work
                with open(file_path, "rb") as fh:
                    fh.seek(offset)
                    await loop.sock_sendfile(sock, fh, offset, count,
                                             fallback=True)
            raw = b""
            while b"\r\n\r\n" not in raw:
                chunk = await loop.sock_recv(sock, 65536)
                if not chunk:
                    raise ConnectionError(
                        "connection closed before response headers")
                raw += chunk
            head_blob, _, body = raw.partition(b"\r\n\r\n")
            lines = head_blob.decode("latin-1").split("\r\n")
            status = int(lines[0].split(" ", 2)[1])
            resp_headers: Dict[str, str] = {}
            for line in lines[1:]:
                key, _, value = line.partition(":")
                resp_headers[key.strip().lower()] = value.strip()
            want = int(resp_headers.get("content-length", -1))
            while want < 0 or len(body) < want:
                chunk = await loop.sock_recv(sock, 65536)
                if not chunk:
                    break
                body += chunk
            return status, resp_headers, body
        finally:
            sock.close()

    async def fput_object(self, bucket: str, name: str, file_path: str,
                          *, consume: bool = False, progress=None,
                          content_md5: Optional[str] = None) -> None:
        """Upload a file from disk.

        Small files go up as one streaming PUT with an UNSIGNED-PAYLOAD
        SigV4 signature (no slurping, no double hashing).  Files over
        ``multipart_threshold`` use S3 multipart upload: fixed-size parts
        with per-part retry, so one dropped connection at the 60-GB mark of
        a media file costs one part, not the whole transfer; failures abort
        the upload server-side so no orphaned parts accrue storage.

        With ``zero_copy`` on, a plain-http single PUT rides
        ``os.sendfile`` (body bytes never enter userspace); any
        transport hiccup falls back to the byte-exact aiohttp path.

        ``progress`` is an optional ``async (bytes_moved)`` callback fired
        after each part lands (once with the full size on the single-PUT
        path).  The upload stage charges its egress token bucket there, so
        pacing engages at part granularity instead of only after a whole
        multi-GB object — and only for bytes that actually moved (a part
        charged once on success; failed attempts charge nothing).

        ``content_md5`` (hex) is the caller's hash-on-land digest; it
        rides the single PUT as a ``Content-MD5`` header so the server
        verifies the body against the digest computed when the bytes
        landed — end-to-end integrity with zero extra local reads."""
        size = os.path.getsize(file_path)
        if size > self.multipart_threshold:
            await self._multipart_upload(bucket, name, file_path, size,
                                         progress=progress)
            return
        path = self._object_path(bucket, name)
        extra: Dict[str, str] = {}
        if content_md5:
            # merged after signing, like the CAS conditionals: not part
            # of the canonical request, so the signature stays valid
            extra["Content-MD5"] = base64.b64encode(
                bytes.fromhex(content_md5)).decode("ascii")
        if self._sendfile_eligible():
            try:
                status, _resp_headers, body = await self._sendfile_put(
                    path, {}, file_path, 0, size, extra_headers=extra)
                if status not in (200, 204):
                    raise _status_error("fput_object", status, body)
                if progress is not None:
                    await progress(size)
                return
            except (OSError, ConnectionError, ValueError, IndexError):
                # raw transport hiccup (proxy, IPv6-only host, odd
                # server framing): the buffered path below is byte-exact
                pass
        headers = self._signer.sign(
            "PUT", self._host, path, {}, "UNSIGNED-PAYLOAD"
        )
        headers["Content-Length"] = str(size)
        headers.update(extra)
        session = await self._ensure_session()

        # graftlint: disable=blocking-call-in-async -- one open(2); aiohttp streams the fh body without slurping
        with open(file_path, "rb") as fh:
            resp = await session.request(
                "PUT",
                yarl.URL(f"{self.endpoint}{path}", encoded=True),
                headers=headers,
                data=fh,
            )
        body = await resp.read()
        if resp.status not in (200, 204):
            raise _status_error("fput_object", resp.status, body)
        if progress is not None:
            await progress(size)

    # -- multipart upload ----------------------------------------------
    async def _multipart_upload(self, bucket: str, name: str,
                                file_path: str, size: int,
                                progress=None) -> None:
        path = self._object_path(bucket, name)
        resp = await self._request("POST", path, query={"uploads": ""})
        body = await resp.read()
        if resp.status != 200:
            raise _status_error("initiate multipart", resp.status, body)
        match = re.search(rb"<UploadId>([^<]+)</UploadId>", body)
        if match is None:
            raise RuntimeError(f"initiate multipart: no UploadId in {body!r}")
        upload_id = match.group(1).decode()

        try:
            etags = await self._upload_parts(path, upload_id, file_path, size,
                                             progress=progress)
            manifest = "".join(
                f"<Part><PartNumber>{num}</PartNumber>"
                f"<ETag>{etag}</ETag></Part>"
                for num, etag in etags
            )
            payload = (
                f"<CompleteMultipartUpload>{manifest}"
                f"</CompleteMultipartUpload>"
            ).encode()
            resp = await self._request(
                "POST", path, query={"uploadId": upload_id}, data=payload
            )
            body = await resp.read()
            if resp.status != 200 or b"<Error>" in body:
                raise RuntimeError(
                    f"complete multipart failed: {resp.status} {body!r}"
                )
        except BaseException:
            # abort so the server drops the stored parts (otherwise they
            # bill storage forever with no visible object)
            try:
                resp = await self._request(
                    "DELETE", path, query={"uploadId": upload_id}
                )
                resp.release()
            except Exception:
                pass
            raise

    async def _put_part_streamed(self, path: str, query: Dict[str, str],
                                 payload, length: int):
        """One part PUT with UNSIGNED-PAYLOAD signing: the body (an mmap
        memoryview slice) goes to the transport without being hashed or
        copied into a fresh buffer first — the userspace half of the
        zero-copy upload path."""
        headers = self._signer.sign("PUT", self._host, path, query,
                                    "UNSIGNED-PAYLOAD")
        headers["Content-Length"] = str(length)
        session = await self._ensure_session()
        return await session.request(
            "PUT", self._signed_url(path, query), headers=headers,
            data=payload,
        )

    async def _upload_parts(self, path: str, upload_id: str,
                            file_path: str, size: int, progress=None):
        """Upload fixed-size parts with bounded concurrency + per-part
        retry; returns [(part_number, etag)] in order.

        With ``zero_copy`` on, part bodies are fed from ONE shared mmap
        of the source file — page-cache-backed slices, no per-part
        read() into a fresh buffer, and UNSIGNED-PAYLOAD signing so no
        per-part sha256 pass either (upload CPU stops scaling with
        payload size).  On a plain-http endpoint each part instead rides
        ``os.sendfile`` end to end.  Any zero-copy failure falls back to
        the byte-exact buffered read() path for that attempt."""
        part_size = self.multipart_part_size
        part_count = (size + part_size - 1) // part_size
        sem = asyncio.Semaphore(self.multipart_concurrency)
        use_sendfile = self._sendfile_eligible()

        source_map = None
        if self.zero_copy and not use_sendfile and size:
            try:
                # graftlint: disable=blocking-call-in-async -- one open(2) to seed the mmap; the part bodies stream without further reads
                with open(file_path, "rb") as fh:
                    # the map holds its own fd reference; pages are
                    # clean/page-cache-backed, so queued parts pin
                    # nothing the kernel can't reclaim
                    source_map = mmap.mmap(fh.fileno(), 0,
                                           access=mmap.ACCESS_READ)
            except (OSError, ValueError):
                source_map = None  # exotic fs: buffered fallback below

        def _read_region(offset: int, length: int) -> bytes:
            with open(file_path, "rb") as fh:
                fh.seek(offset)
                return fh.read(length)

        async def _attempt_put(part_number: int, offset: int,
                               length: int, buffered: bool):
            query = {"partNumber": str(part_number),
                     "uploadId": upload_id}
            if not buffered and use_sendfile:
                status, resp_headers, body = await self._sendfile_put(
                    path, query, file_path, offset, length)
                return status, resp_headers.get("etag", ""), body
            if not buffered and source_map is not None:
                payload = memoryview(source_map)[offset:offset + length]
                try:
                    resp = await self._put_part_streamed(
                        path, query, payload, length)
                    body = await resp.read()
                finally:
                    payload.release()
                return (resp.status,
                        resp.headers.get("ETag", ""), body)
            # byte-exact fallback: re-read per attempt (in a thread: a
            # 64 MiB read must not stall the event loop) — the file
            # region is the source of truth, a shared buffer would pin
            # memory for queued parts
            data = await asyncio.to_thread(_read_region, offset, length)
            resp = await self._request("PUT", path, query=query,
                                       data=data)
            body = await resp.read()
            return resp.status, resp.headers.get("ETag", ""), body

        async def _one(part_number: int):
            offset = (part_number - 1) * part_size
            length = min(part_size, size - offset)
            async with sem:
                last: Optional[Exception] = None
                buffered = False
                for attempt in range(3):
                    try:
                        status, etag, body = await _attempt_put(
                            part_number, offset, length, buffered)
                        if status == 200:
                            etag = etag.strip('"')
                            if not etag:
                                # fabricating a local md5 here would turn a
                                # proxy quirk into a confusing InvalidPart
                                # at complete time — fail where the cause is
                                raise RuntimeError(
                                    f"part {part_number}: response has no "
                                    "ETag header"
                                )
                            if progress is not None:
                                # inside the semaphore on purpose: a
                                # pacing sleep in the callback holds this
                                # part's slot, throttling the pool to the
                                # configured egress rate
                                await progress(length)
                            return part_number, etag
                        last = RuntimeError(
                            f"part {part_number}: {status} {body!r}"
                        )
                    except (aiohttp.ClientError, OSError,
                            ConnectionError, ValueError,
                            IndexError) as err:
                        if (isinstance(err, OSError)
                                and err.errno == errno.ENOSPC):
                            # local disk full reading/staging the part:
                            # every further attempt re-reads the same
                            # full volume.  Fail fast PERMANENT so the
                            # retry budget isn't burned and the caller's
                            # except-path AbortMultipartUpload drops the
                            # already-stored parts NOW (no orphans
                            # billing storage with no visible object)
                            raise tag_fault(err, PERMANENT)
                        if getattr(err, "fault_class", None) == PERMANENT:
                            # explicitly pre-classified (injected disk
                            # faults, status-coded errors): fail fast.
                            # NOT classify()-based — a bare ValueError/
                            # IndexError here is a zero-copy slice quirk
                            # whose cure IS the buffered retry below.
                            raise err
                        last = err
                        # a zero-copy transport error retries on the
                        # buffered path — correctness never depends on
                        # the fast path working
                        buffered = True
                    await asyncio.sleep(0.2 * (attempt + 1))
                raise RuntimeError(
                    f"part {part_number} failed after retries: {last}"
                )

        tasks = [
            asyncio.create_task(_one(n)) for n in range(1, part_count + 1)
        ]
        try:
            results = await asyncio.gather(*tasks)
        except BaseException:
            # settle the siblings BEFORE the caller aborts the upload: a
            # part PUT landing after AbortMultipartUpload re-creates
            # orphaned (billed) parts on real S3
            for task in tasks:
                task.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise
        finally:
            if source_map is not None:
                try:
                    source_map.close()
                except BufferError:
                    pass  # a straggler view: dropped with the map by gc
        return sorted(results)

    async def stat_object(self, bucket: str, name: str) -> ObjectInfo:
        resp = await self._request("HEAD", self._object_path(bucket, name))
        resp.release()
        if resp.status == 404:
            raise ObjectNotFound(bucket, name)
        if resp.status != 200:
            raise _status_error("stat_object", resp.status)
        # S3 ETag: MD5 hex for single-part uploads, md5-of-part-md5s with
        # a ``-N`` suffix for multipart — exposed verbatim; callers that
        # verify content handle both forms (see stages/upload.py
        # _already_staged / utils.hashing.multipart_etag_hex)
        etag = resp.headers.get("ETag", "").strip('"')
        return ObjectInfo(
            name=name,
            size=int(resp.headers.get("Content-Length", 0)),
            etag=etag,
        )

    async def list_objects(self, bucket: str, prefix: str = "") -> AsyncIterator[ObjectInfo]:
        token: Optional[str] = None
        while True:
            query = {"list-type": "2", "prefix": prefix}
            if token:
                query["continuation-token"] = token
            resp = await self._request("GET", f"/{bucket}", query=query)
            body = await resp.read()
            if resp.status == 404:
                raise ObjectNotFound(bucket, prefix)
            if resp.status != 200:
                raise _status_error("list_objects", resp.status, body)

            root = ET.fromstring(body)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            for contents in root.findall(f"{ns}Contents"):
                key = contents.findtext(f"{ns}Key") or ""
                size = int(contents.findtext(f"{ns}Size") or 0)
                yield ObjectInfo(name=key, size=size)

            truncated = (root.findtext(f"{ns}IsTruncated") or "false") == "true"
            token = root.findtext(f"{ns}NextContinuationToken")
            if not truncated or not token:
                break
