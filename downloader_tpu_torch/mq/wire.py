"""AMQP 0-9-1 wire codec: frames, field values, methods, content.

The reference speaks AMQP 0-9-1 to RabbitMQ through ``triton-core/amqp``
(amqplib, upstream yarn.lock:3574-3575; connected at
upstream lib/main.js:46-47).  This module implements the subset of
the protocol the pipeline exercises — connection/channel handshake, queue
declare, qos, publish with content, consume/deliver, ack/nack, heartbeat —
from the public AMQP 0-9-1 specification.  It is shared by the asyncio
client (:mod:`downloader_tpu_torch.mq.amqp`) and the hermetic test broker
(``tests/miniamqp.py``), so both ends of every test exchange real protocol
bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

PROTOCOL_HEADER = b"AMQP\x00\x00\x09\x01"
FRAME_END = 0xCE

FRAME_METHOD = 1
FRAME_HEADER = 2
FRAME_BODY = 3
FRAME_HEARTBEAT = 8

# class ids
CLASS_CONNECTION = 10
CLASS_CHANNEL = 20
CLASS_QUEUE = 50
CLASS_BASIC = 60

# (class, method) ids for the methods this framework uses
CONNECTION_START = (10, 10)
CONNECTION_START_OK = (10, 11)
CONNECTION_TUNE = (10, 30)
CONNECTION_TUNE_OK = (10, 31)
CONNECTION_OPEN = (10, 40)
CONNECTION_OPEN_OK = (10, 41)
CONNECTION_CLOSE = (10, 50)
CONNECTION_CLOSE_OK = (10, 51)

CHANNEL_OPEN = (20, 10)
CHANNEL_OPEN_OK = (20, 11)
CHANNEL_CLOSE = (20, 40)
CHANNEL_CLOSE_OK = (20, 41)

EXCHANGE_DECLARE = (40, 10)
EXCHANGE_DECLARE_OK = (40, 11)

QUEUE_DECLARE = (50, 10)
QUEUE_DECLARE_OK = (50, 11)
QUEUE_BIND = (50, 20)
QUEUE_BIND_OK = (50, 21)

BASIC_QOS = (60, 10)
BASIC_QOS_OK = (60, 11)
BASIC_CONSUME = (60, 20)
BASIC_CONSUME_OK = (60, 21)
BASIC_CANCEL = (60, 30)
BASIC_CANCEL_OK = (60, 31)
BASIC_PUBLISH = (60, 40)
BASIC_DELIVER = (60, 60)
BASIC_ACK = (60, 80)
BASIC_NACK = (60, 120)

CONFIRM_SELECT = (85, 10)
CONFIRM_SELECT_OK = (85, 11)

# Per-method argument layouts.  Codes: 'o' octet, 'h' short, 'l' long,
# 'q' long-long, 's' shortstr, 'S' longstr, 'F' field table, 'b' bit.
# Consecutive bits pack into shared octets, per the spec.
METHOD_ARGS: Dict[Tuple[int, int], str] = {
    CONNECTION_START: "ooFSS",
    CONNECTION_START_OK: "FsSs",
    CONNECTION_TUNE: "hlh",
    CONNECTION_TUNE_OK: "hlh",
    CONNECTION_OPEN: "ssb",
    CONNECTION_OPEN_OK: "s",
    CONNECTION_CLOSE: "hshh",
    CONNECTION_CLOSE_OK: "",
    CHANNEL_OPEN: "s",
    CHANNEL_OPEN_OK: "S",
    CHANNEL_CLOSE: "hshh",
    CHANNEL_CLOSE_OK: "",
    EXCHANGE_DECLARE: "hssbbbbbF",
    EXCHANGE_DECLARE_OK: "",
    QUEUE_DECLARE: "hsbbbbbF",
    QUEUE_DECLARE_OK: "sll",
    QUEUE_BIND: "hsssbF",
    QUEUE_BIND_OK: "",
    BASIC_QOS: "lhb",
    BASIC_QOS_OK: "",
    BASIC_CONSUME: "hssbbbbF",
    BASIC_CONSUME_OK: "s",
    BASIC_CANCEL: "sb",
    BASIC_CANCEL_OK: "s",
    BASIC_PUBLISH: "hssbb",
    BASIC_DELIVER: "sqbss",
    BASIC_ACK: "qb",
    BASIC_NACK: "qbb",
    CONFIRM_SELECT: "b",
    CONFIRM_SELECT_OK: "",
}

# Basic content properties, in property-flag order (bit 15 downward).
BASIC_PROPERTIES: List[Tuple[str, str]] = [
    ("content_type", "s"),
    ("content_encoding", "s"),
    ("headers", "F"),
    ("delivery_mode", "o"),
    ("priority", "o"),
    ("correlation_id", "s"),
    ("reply_to", "s"),
    ("expiration", "s"),
    ("message_id", "s"),
    ("timestamp", "q"),
    ("type", "s"),
    ("user_id", "s"),
    ("app_id", "s"),
    ("cluster_id", "s"),
]


class ProtocolError(Exception):
    """Malformed or unexpected AMQP bytes."""


# ---------------------------------------------------------------------------
# primitive value codec
# ---------------------------------------------------------------------------


class Writer:
    """Append-only buffer with AMQP primitive encoders."""

    def __init__(self) -> None:
        self._parts: List[bytes] = []
        # pending bit-pack state: consecutive 'b' args share octets
        self._bits: List[bool] = []

    def _flush_bits(self) -> None:
        while self._bits:
            chunk, self._bits = self._bits[:8], self._bits[8:]
            octet = 0
            for i, bit in enumerate(chunk):
                if bit:
                    octet |= 1 << i
            self._parts.append(bytes([octet]))

    def octet(self, v: int) -> None:
        self._flush_bits()
        self._parts.append(struct.pack(">B", v))

    def short(self, v: int) -> None:
        self._flush_bits()
        self._parts.append(struct.pack(">H", v))

    def long(self, v: int) -> None:
        self._flush_bits()
        self._parts.append(struct.pack(">I", v))

    def longlong(self, v: int) -> None:
        self._flush_bits()
        self._parts.append(struct.pack(">Q", v))

    def bit(self, v: bool) -> None:
        self._bits.append(bool(v))

    def shortstr(self, v: str) -> None:
        self._flush_bits()
        raw = v.encode("utf-8")
        if len(raw) > 255:
            raise ProtocolError("shortstr too long")
        self._parts.append(struct.pack(">B", len(raw)) + raw)

    def longstr(self, v) -> None:
        self._flush_bits()
        raw = v if isinstance(v, (bytes, bytearray)) else str(v).encode("utf-8")
        self._parts.append(struct.pack(">I", len(raw)) + bytes(raw))

    def table(self, v: Optional[Dict[str, Any]]) -> None:
        self._flush_bits()
        body = _encode_table(v or {})
        self._parts.append(struct.pack(">I", len(body)) + body)

    def getvalue(self) -> bytes:
        self._flush_bits()
        return b"".join(self._parts)


class Reader:
    """Cursor over received AMQP bytes with primitive decoders."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0
        # bit-unpack state mirrors Writer._bits
        self._bit_octet = 0
        self._bits_left = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._data):
            raise ProtocolError("truncated frame payload")
        out = self._data[self._pos:self._pos + n]
        self._pos += n
        return out

    def _reset_bits(self) -> None:
        self._bits_left = 0

    def octet(self) -> int:
        self._reset_bits()
        return self._take(1)[0]

    def short(self) -> int:
        self._reset_bits()
        return struct.unpack(">H", self._take(2))[0]

    def long(self) -> int:
        self._reset_bits()
        return struct.unpack(">I", self._take(4))[0]

    def longlong(self) -> int:
        self._reset_bits()
        return struct.unpack(">Q", self._take(8))[0]

    def bit(self) -> bool:
        if self._bits_left == 0:
            self._bit_octet = self._take(1)[0]
            self._bits_left = 8
        v = bool(self._bit_octet & 1)
        self._bit_octet >>= 1
        self._bits_left -= 1
        return v

    def shortstr(self) -> str:
        self._reset_bits()
        n = self._take(1)[0]
        return self._take(n).decode("utf-8")

    def longstr(self) -> bytes:
        self._reset_bits()
        n = struct.unpack(">I", self._take(4))[0]
        return self._take(n)

    def table(self) -> Dict[str, Any]:
        self._reset_bits()
        n = struct.unpack(">I", self._take(4))[0]
        return _decode_table(Reader(self._take(n)))

    def remaining(self) -> int:
        return len(self._data) - self._pos


def _encode_value(v: Any) -> bytes:
    """Encode one field-table value with its type octet (RabbitMQ dialect)."""
    if isinstance(v, bool):
        return b"t" + struct.pack(">B", int(v))
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return b"I" + struct.pack(">i", v)
        return b"l" + struct.pack(">q", v)
    if isinstance(v, float):
        return b"d" + struct.pack(">d", v)
    if isinstance(v, str):
        raw = v.encode("utf-8")
        return b"S" + struct.pack(">I", len(raw)) + raw
    if isinstance(v, (bytes, bytearray)):
        return b"S" + struct.pack(">I", len(v)) + bytes(v)
    if isinstance(v, dict):
        body = _encode_table(v)
        return b"F" + struct.pack(">I", len(body)) + body
    if isinstance(v, (list, tuple)):
        body = b"".join(_encode_value(item) for item in v)
        return b"A" + struct.pack(">I", len(body)) + body
    if v is None:
        return b"V"
    raise ProtocolError(f"cannot encode table value of type {type(v).__name__}")


def _encode_table(table: Dict[str, Any]) -> bytes:
    out = []
    for key, value in table.items():
        raw = key.encode("utf-8")
        out.append(struct.pack(">B", len(raw)) + raw + _encode_value(value))
    return b"".join(out)


def _decode_value(r: Reader) -> Any:
    kind = r._take(1)
    if kind == b"t":
        return bool(r._take(1)[0])
    if kind == b"b":
        return struct.unpack(">b", r._take(1))[0]
    if kind == b"B":
        return r._take(1)[0]
    if kind == b"s":
        return struct.unpack(">h", r._take(2))[0]
    if kind == b"u":
        return struct.unpack(">H", r._take(2))[0]
    if kind == b"I":
        return struct.unpack(">i", r._take(4))[0]
    if kind == b"i":
        return struct.unpack(">I", r._take(4))[0]
    if kind == b"l":
        return struct.unpack(">q", r._take(8))[0]
    if kind == b"f":
        return struct.unpack(">f", r._take(4))[0]
    if kind == b"d":
        return struct.unpack(">d", r._take(8))[0]
    if kind == b"D":  # decimal: scale octet + long
        scale = r._take(1)[0]
        return struct.unpack(">i", r._take(4))[0] / (10 ** scale)
    if kind == b"S":
        n = struct.unpack(">I", r._take(4))[0]
        return r._take(n).decode("utf-8", "replace")
    if kind == b"x":
        n = struct.unpack(">I", r._take(4))[0]
        return r._take(n)
    if kind == b"T":
        return struct.unpack(">Q", r._take(8))[0]
    if kind == b"F":
        n = struct.unpack(">I", r._take(4))[0]
        return _decode_table(Reader(r._take(n)))
    if kind == b"A":
        n = struct.unpack(">I", r._take(4))[0]
        sub = Reader(r._take(n))
        items = []
        while sub.remaining():
            items.append(_decode_value(sub))
        return items
    if kind == b"V":
        return None
    raise ProtocolError(f"unknown field-table value type {kind!r}")


def _decode_table(r: Reader) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    while r.remaining():
        n = r._take(1)[0]
        key = r._take(n).decode("utf-8")
        out[key] = _decode_value(r)
    return out


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def encode_frame(ftype: int, channel: int, payload: bytes) -> bytes:
    return struct.pack(">BHI", ftype, channel, len(payload)) + payload + bytes([FRAME_END])


def encode_method(channel: int, method: Tuple[int, int], *args: Any) -> bytes:
    """Encode a method frame using the METHOD_ARGS layout for ``method``."""
    w = Writer()
    w.short(method[0])
    w.short(method[1])
    layout = METHOD_ARGS[method]
    if len(args) != len(layout):
        raise ProtocolError(
            f"method {method} takes {len(layout)} args, got {len(args)}"
        )
    for code, arg in zip(layout, args):
        if code == "o":
            w.octet(arg)
        elif code == "h":
            w.short(arg)
        elif code == "l":
            w.long(arg)
        elif code == "q":
            w.longlong(arg)
        elif code == "s":
            w.shortstr(arg)
        elif code == "S":
            w.longstr(arg)
        elif code == "F":
            w.table(arg)
        elif code == "b":
            w.bit(arg)
        else:  # pragma: no cover - layout strings are static
            raise ProtocolError(f"bad layout code {code!r}")
    return encode_frame(FRAME_METHOD, channel, w.getvalue())


def decode_method(payload: bytes) -> Tuple[Tuple[int, int], List[Any]]:
    """Decode a method frame payload into ((class, method), args)."""
    r = Reader(payload)
    method = (r.short(), r.short())
    layout = METHOD_ARGS.get(method)
    if layout is None:
        raise ProtocolError(f"unsupported method {method}")
    args: List[Any] = []
    for code in layout:
        if code == "o":
            args.append(r.octet())
        elif code == "h":
            args.append(r.short())
        elif code == "l":
            args.append(r.long())
        elif code == "q":
            args.append(r.longlong())
        elif code == "s":
            args.append(r.shortstr())
        elif code == "S":
            args.append(r.longstr())
        elif code == "F":
            args.append(r.table())
        elif code == "b":
            args.append(r.bit())
    return method, args


def encode_content_header(
    channel: int, body_size: int, properties: Optional[Dict[str, Any]] = None
) -> bytes:
    """Encode a basic-class content header frame."""
    properties = properties or {}
    w = Writer()
    w.short(CLASS_BASIC)
    w.short(0)  # weight, always 0
    w.longlong(body_size)
    flags = 0
    vals = Writer()
    for i, (name, code) in enumerate(BASIC_PROPERTIES):
        value = properties.get(name)
        if value is None:
            continue
        flags |= 1 << (15 - i)
        if code == "s":
            vals.shortstr(value)
        elif code == "o":
            vals.octet(value)
        elif code == "q":
            vals.longlong(value)
        elif code == "F":
            vals.table(value)
    w.short(flags)
    return encode_frame(FRAME_HEADER, channel, w.getvalue() + vals.getvalue())


def decode_content_header(payload: bytes) -> Tuple[int, Dict[str, Any]]:
    """Decode a content header payload into (body_size, properties)."""
    r = Reader(payload)
    class_id = r.short()
    if class_id != CLASS_BASIC:
        raise ProtocolError(f"unexpected content class {class_id}")
    r.short()  # weight
    body_size = r.longlong()
    flags = r.short()
    props: Dict[str, Any] = {}
    for i, (name, code) in enumerate(BASIC_PROPERTIES):
        if not flags & (1 << (15 - i)):
            continue
        if code == "s":
            props[name] = r.shortstr()
        elif code == "o":
            props[name] = r.octet()
        elif code == "q":
            props[name] = r.longlong()
        elif code == "F":
            props[name] = r.table()
    return body_size, props


def encode_body_frames(channel: int, body: bytes, frame_max: int) -> List[bytes]:
    """Split ``body`` into body frames honouring the negotiated frame-max."""
    # frame overhead: 7-byte header + 1-byte end marker
    chunk = max(frame_max - 8, 1)
    return [
        encode_frame(FRAME_BODY, channel, body[i:i + chunk])
        for i in range(0, len(body), chunk)
    ] or [encode_frame(FRAME_BODY, channel, b"")]


async def read_frame(reader) -> Tuple[int, int, bytes]:
    """Read one frame from an ``asyncio.StreamReader``."""
    header = await reader.readexactly(7)
    ftype, channel, size = struct.unpack(">BHI", header)
    payload = await reader.readexactly(size)
    end = await reader.readexactly(1)
    if end[0] != FRAME_END:
        raise ProtocolError(f"bad frame end {end!r}")
    return ftype, channel, payload
