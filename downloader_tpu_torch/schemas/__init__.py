"""Wire schemas and enum helpers for the downloader pipeline.

Capability-equivalent to the reference's `triton-core/proto` registry usage:
``proto.load`` / ``proto.encode`` / ``proto.decode`` (upstream lib/main.js:55-63,161)
and ``proto.enumToString`` / ``proto.stringToEnum``
(upstream lib/download.js:243, upstream lib/process.js:53).

Messages are real protobuf (see ``downloader.proto``), so the wire format is
binary protobuf just like the reference's, and the generated classes are the
single source of truth for field names and enum values.
"""

from __future__ import annotations

from typing import Type

from google.protobuf.message import Message

from .downloader_pb2 import (
    Convert,
    Download,
    JobPriority,
    Media,
    MediaType,
    SourceKind,
    SourceType,
    TelemetryProgressEvent,
    TelemetryStatus,
    TelemetryStatusEvent,
)

__all__ = [
    "Convert", "Download", "JobPriority", "Media", "MediaType",
    "SourceKind", "SourceType", "TelemetryProgressEvent",
    "TelemetryStatus", "TelemetryStatusEvent",
    "DOWNLOAD_QUEUE", "CONVERT_QUEUE", "CONVERT_EXCHANGE",
    "encode", "decode",
]

# Queue names (reference lib/main.js:164,172).
DOWNLOAD_QUEUE = "v1.download"
CONVERT_QUEUE = "v1.convert"
# fanout exchange feeding CONVERT_QUEUE (when the backend supports
# exchanges), so observers — e.g. `cli submit --wait` — can see job
# completion without stealing the converter's deliveries
CONVERT_EXCHANGE = CONVERT_QUEUE + ".fanout"

_MESSAGE_TYPES = {
    "downloader.Download": Download,
    "downloader.Convert": Convert,
    "downloader.Media": Media,
    "downloader.TelemetryStatusEvent": TelemetryStatusEvent,
    "downloader.TelemetryProgressEvent": TelemetryProgressEvent,
}


def load(name: str) -> Type[Message]:
    """Look up a message class by registry name.

    Mirrors the reference's ``proto.load('api.Download')`` surface
    (upstream lib/main.js:55) with our own registry names.
    """
    try:
        return _MESSAGE_TYPES[name]
    except KeyError:
        raise KeyError(
            f"unknown message type {name!r}; known: {sorted(_MESSAGE_TYPES)}"
        ) from None


# Optional process-wide wire remap (see remap.py): reconciling our frozen
# field numbers with a real triton-core deployment is a config change
# (`wire_remap:` table), not a schema migration.
_active_remap = None


def configure_remap(tables) -> None:
    """Install (or clear, with a falsy argument) the wire remap.

    ``tables`` is the ``wire_remap`` config section: per message simple
    name, a mapping of OUR field name to the DEPLOYMENT's wire number.
    Bad tables (unknown fields, duplicate numbers) fail here, at boot,
    not on the first job.
    """
    global _active_remap
    if not tables:
        _active_remap = None
        return
    from .remap import RemapError, WireRemap

    # every table key must name a message reachable from the registry —
    # a typo ('Mdia') must not silently disable the remap for that type
    known = set()
    stack = [t.DESCRIPTOR for t in _MESSAGE_TYPES.values()]
    while stack:
        descriptor = stack.pop()
        if descriptor.name in known:
            continue
        known.add(descriptor.name)
        stack.extend(f.message_type for f in descriptor.fields
                     if f.message_type is not None)
    unknown = set(tables) - known
    if unknown:
        raise RemapError(
            f"wire_remap names unknown message type(s) {sorted(unknown)}; "
            f"known: {sorted(known)}"
        )

    remap = WireRemap(tables)
    for msg_type in _MESSAGE_TYPES.values():  # compile now -> fail fast
        remap.to_wire(msg_type.DESCRIPTOR, b"")
        remap.from_wire(msg_type.DESCRIPTOR, b"")
    _active_remap = remap


def encode(msg: Message) -> bytes:
    """Serialize a message to its binary wire format (remapped to the
    deployment's field numbers when a wire remap is configured)."""
    data = msg.SerializeToString()
    if _active_remap is not None:
        data = _active_remap.to_wire(msg.DESCRIPTOR, data)
    return data


def decode(msg_type: Type[Message], data: bytes) -> Message:
    """Parse binary wire format into a message instance (translating
    from the deployment's field numbers when a wire remap is configured)."""
    if _active_remap is not None:
        data = _active_remap.from_wire(msg_type.DESCRIPTOR, data)
    msg = msg_type()
    msg.ParseFromString(data)
    return msg


def enum_to_string(enum_type, value: int) -> str:
    """Enum numeric value -> name (reference ``proto.enumToString``,
    upstream lib/download.js:243)."""
    return enum_type.Name(value)


def string_to_enum(enum_type, name: str) -> int:
    """Enum name -> numeric value (reference ``proto.stringToEnum``,
    upstream lib/process.js:53)."""
    return enum_type.Value(name)
