"""Distributed tracing.

The reference plumbs a Jaeger tracer (upstream index.js:10,15) and
imports the opentracing symbols (upstream lib/main.js:20) but never
creates a span — SURVEY.md §5 flags tracing as "plumbed-but-unused" and the
build plan (§7 step 7) says to wire it for real.  This module is a small
OpenTracing-style tracer: nested spans with tags and timings, kept in an
in-memory buffer, optionally exported as JSON lines for offline analysis,
and — the production path — shipped to any OpenTelemetry collector over
OTLP/HTTP JSON (:class:`OtlpExporter`; Jaeger ingests OTLP natively since
1.35, so this supersedes the reference's jaeger-thrift wire).

Configuration: ``tracing.otlp_endpoint`` in the service YAML or
``$OTLP_ENDPOINT`` (e.g. ``http://localhost:4318``).  Spans are batched in
a background thread; a down collector never blocks or fails the pipeline.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import queue
import re
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Any, Dict, List, Optional

_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "current_span", default=None
)


class RemoteSpanContext:
    """A parent carried over the wire (W3C traceparent) rather than the
    contextvar: just the two ids a child span needs.  The reference
    imports serialize/unserialize for exactly this cross-service carry
    (upstream lib/main.js:20) and never uses them — here the
    context actually rides queue message headers."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id


def format_traceparent(span: Optional["Span"] = None) -> Optional[str]:
    """W3C trace-context header for ``span`` (default: the current one);
    None when there is nothing to propagate."""
    span = span or _current_span.get()
    if span is None:
        return None
    return f"00-{span.trace_id}-{span.span_id}-01"


_HEX32 = re.compile(r"[0-9a-f]{32}")
_HEX16 = re.compile(r"[0-9a-f]{16}")
_HEX2 = re.compile(r"[0-9a-f]{2}")


def parse_traceparent(value: Any) -> Optional[RemoteSpanContext]:
    """Parse a W3C traceparent header; None for anything malformed
    (wire headers are untrusted — never raise)."""
    if isinstance(value, bytes):
        try:
            value = value.decode("ascii")
        except UnicodeDecodeError:
            return None
    if not isinstance(value, str):
        return None
    parts = value.split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    # strict lowercase hex (int(x, 16) would admit signs/underscores/
    # uppercase, and a malformed id poisons the whole OTLP batch it is
    # exported with — review r5)
    if version != "00" or not _HEX32.fullmatch(trace_id) \
            or not _HEX16.fullmatch(span_id) or not _HEX2.fullmatch(flags):
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None  # the spec's all-zero ids mean "no trace"
    return RemoteSpanContext(trace_id, span_id)


class Span:
    __slots__ = (
        "tracer", "name", "trace_id", "span_id", "parent_id",
        "start", "end", "tags", "error", "_mono",
    )

    def __init__(self, tracer: "Tracer", name: str,
                 parent: "Optional[Span | RemoteSpanContext]" = None,
                 trace_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 **tags: Any):
        self.tracer = tracer
        self.name = name
        # W3C/OTLP sizes: 16-byte trace id, 8-byte span id (hex).
        # Explicit ids win (the orchestrator pre-allocates a job's ids so
        # its child logger and flight recorder carry them from receipt,
        # before the span opens); otherwise inherit/generate as before.
        self.trace_id = trace_id or (parent.trace_id if parent
                                     else uuid.uuid4().hex)
        self.span_id = span_id or uuid.uuid4().hex[:16]
        self.parent_id = parent.span_id if parent else None
        # wall-clock anchors the OTLP start/end nanos; the duration is
        # measured on the monotonic clock (an NTP step mid-span would
        # otherwise skew — or negate — every timing derived from it)
        self.start = time.time()
        self._mono = time.monotonic()
        self.end: Optional[float] = None
        self.tags: Dict[str, Any] = dict(tags)
        self.error: Optional[str] = None

    def set_tag(self, key: str, value: Any) -> None:
        self.tags[key] = value

    def finish(self, error: Optional[BaseException] = None) -> None:
        if self.end is not None:
            return
        # end = wall start + monotonic elapsed: OTLP nanos stay
        # wall-anchored while the span's duration is NTP-step-immune
        self.end = self.start + (time.monotonic() - self._mono)
        if error is not None:
            self.error = f"{type(error).__name__}: {error}"
        self.tracer._record(self)

    @property
    def duration(self) -> float:
        if self.end is None:
            return time.monotonic() - self._mono
        return self.end - self.start

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "startTime": self.start,
            "duration": self.duration,
            "tags": self.tags,
            "error": self.error,
        }


def _otlp_attr(key: str, value: Any) -> dict:
    """One OTLP KeyValue; non-primitive values stringify."""
    if isinstance(value, bool):
        body: dict = {"boolValue": value}
    elif isinstance(value, int):
        body = {"intValue": str(value)}
    elif isinstance(value, float):
        body = {"doubleValue": value}
    else:
        body = {"stringValue": str(value)}
    return {"key": key, "value": body}


def span_to_otlp(span: "Span") -> dict:
    """One finished span in OTLP/JSON (opentelemetry-proto mapping)."""
    out = {
        "traceId": span.trace_id,
        "spanId": span.span_id,
        "name": span.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(int(span.start * 1e9)),
        "endTimeUnixNano": str(int((span.end or span.start) * 1e9)),
        "attributes": [_otlp_attr(k, v) for k, v in span.tags.items()],
    }
    if span.parent_id:
        out["parentSpanId"] = span.parent_id
    if span.error:
        out["status"] = {"code": 2, "message": span.error}  # STATUS_CODE_ERROR
    return out


class OtlpExporter:
    """Ships finished spans to an OTLP/HTTP collector in the background.

    Batches up to ``max_batch`` spans every ``interval`` seconds and POSTs
    them to ``<endpoint>/v1/traces`` as OTLP JSON.  Export failures are
    counted and dropped — tracing must never block or fail the pipeline.
    """

    def __init__(self, endpoint: str, service: str,
                 interval: float = 2.0, max_batch: int = 512,
                 max_queue: int = 8192, timeout: float = 5.0):
        self.url = endpoint.rstrip("/") + "/v1/traces"
        self.service = service
        self.interval = interval
        self.max_batch = max_batch
        self.timeout = timeout
        self.dropped = 0
        self.exported = 0
        self.errors = 0
        self._queue: "queue.Queue[Optional[dict]]" = queue.Queue(max_queue)
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="otlp-exporter", daemon=True
        )
        self._thread.start()

    def enqueue(self, span: "Span") -> None:
        try:
            self._queue.put_nowait(span_to_otlp(span))
        except queue.Full:
            self.dropped += 1

    # ------------------------------------------------------------------
    def _run(self) -> None:
        while not self._closed.is_set() or not self._queue.empty():
            batch: List[dict] = []
            deadline = time.monotonic() + self.interval
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if self._closed.is_set():
                    remaining = 0.0
                try:
                    item = self._queue.get(timeout=max(remaining, 0.01))
                except queue.Empty:
                    break
                if item is None:
                    break
                batch.append(item)
            if batch:
                self._post(batch)

    def _post(self, batch: List[dict]) -> None:
        payload = json.dumps({
            "resourceSpans": [{
                "resource": {
                    "attributes": [_otlp_attr("service.name", self.service)],
                },
                "scopeSpans": [{
                    "scope": {"name": "downloader_tpu_torch"},
                    "spans": batch,
                }],
            }]
        }).encode("utf-8")
        request = urllib.request.Request(
            self.url, data=payload,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(request, timeout=self.timeout):
                self.exported += len(batch)
        except (urllib.error.URLError, OSError, ValueError):
            self.errors += 1
            self.dropped += len(batch)

    def close(self, timeout: float = 10.0) -> None:
        """Flush remaining spans and stop the exporter thread."""
        self._closed.set()
        self._queue.put(None)  # wake the worker
        self._thread.join(timeout)


class Tracer:
    """Span factory + buffer.  ``export_path`` (or ``$TRACE_EXPORT``) appends
    each finished span as one JSON line; ``exporter`` (an
    :class:`OtlpExporter`) ships spans to a collector."""

    def __init__(self, service: str, export_path: Optional[str] = None,
                 max_buffer: int = 10_000,
                 exporter: Optional[OtlpExporter] = None):
        self.service = service
        self.export_path = export_path or os.environ.get("TRACE_EXPORT")
        self.exporter = exporter
        # optional structured logger (init_tracer attaches it): used to
        # report exporter health once at the shutdown flush
        self.logger = None
        self.finished: List[Span] = []
        self._max_buffer = max_buffer
        self._lock = threading.Lock()

    def buffer_depth(self) -> int:
        """Finished spans currently held in the in-process buffer."""
        with self._lock:
            return len(self.finished)

    @contextlib.contextmanager
    def span(self, name: str, remote_parent: Optional[RemoteSpanContext] = None,
             trace_id: Optional[str] = None, span_id: Optional[str] = None,
             **tags: Any):
        parent = remote_parent or _current_span.get()
        span = Span(self, name, parent, trace_id=trace_id, span_id=span_id,
                    **tags)
        token = _current_span.set(span)
        try:
            yield span
        except BaseException as exc:
            span.finish(error=exc)
            raise
        finally:
            _current_span.reset(token)
            span.finish()

    def _record(self, span: Span) -> None:
        with self._lock:
            self.finished.append(span)
            if len(self.finished) > self._max_buffer:
                del self.finished[: len(self.finished) - self._max_buffer]
        if self.exporter is not None:
            self.exporter.enqueue(span)
        if self.export_path:
            line = json.dumps({"service": self.service, **span.to_dict()})
            with self._lock, open(self.export_path, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")

    def close(self) -> None:
        """Flush the OTLP exporter, if any, and report its health.

        Export failures are deliberately silent in-flight (a down
        collector must never fail the pipeline), so the shutdown flush
        is where their tally surfaces: one log line with
        exported/dropped/errors — the operator's signal that traces
        were (or were not) actually leaving the process.
        """
        if self.exporter is not None:
            self.exporter.close()
            if self.logger is not None:
                self.logger.info(
                    "otlp exporter flushed",
                    exported=self.exporter.exported,
                    dropped=self.exporter.dropped,
                    errors=self.exporter.errors,
                    queued=self.exporter._queue.qsize(),
                )

    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            return [s for s in self.finished if name is None or s.name == name]


class NullTracer(Tracer):
    """Tracer that records nothing (for perf-sensitive or minimal runs)."""

    def __init__(self) -> None:
        super().__init__("null")

    def _record(self, span: Span) -> None:
        pass


def init_tracer(service: str, logger=None, config=None) -> Tracer:
    """(reference ``Tracer('downloader', logger)``, index.js:15)

    Resolution for the OTLP endpoint: ``$OTLP_ENDPOINT`` env, then the
    ``tracing.otlp_endpoint`` config key.  Absent both, spans stay in the
    in-process buffer (and the optional JSONL file) only.
    """
    from .config import cfg_get

    endpoint = os.environ.get("OTLP_ENDPOINT") or cfg_get(
        config, "tracing.otlp_endpoint"
    )
    exporter = OtlpExporter(endpoint, service) if endpoint else None
    tracer = Tracer(service, exporter=exporter)
    tracer.logger = logger
    if logger is not None:
        logger.debug(
            "tracer initialized", service=service,
            otlp=endpoint or "disabled",
        )
    return tracer
