"""Bencoding (BEP 3): the wire/metadata format of BitTorrent.

Canonical rules: integers ``i<n>e``, byte strings ``<len>:<bytes>``, lists
``l...e``, dicts ``d...e`` with byte-string keys sorted lexicographically.
Round-trip stability matters because infohashes are SHA-1 of the re-encoded
``info`` dict.
"""

from __future__ import annotations

from typing import Any, Tuple


def bencode(value: Any) -> bytes:
    """Encode ints, bytes, str (utf-8), lists, and dicts."""
    if isinstance(value, bool):
        raise TypeError("bool is not bencodable")
    if isinstance(value, int):
        return b"i%de" % value
    if isinstance(value, str):
        value = value.encode("utf-8")
    if isinstance(value, (bytes, bytearray, memoryview)):
        value = bytes(value)
        return b"%d:%s" % (len(value), value)
    if isinstance(value, (list, tuple)):
        return b"l" + b"".join(bencode(item) for item in value) + b"e"
    if isinstance(value, dict):
        out = [b"d"]
        keys = []
        for key in value:
            if isinstance(key, str):
                keys.append(key.encode("utf-8"))
            elif isinstance(key, bytes):
                keys.append(key)
            else:
                raise TypeError(f"dict key must be str/bytes, got {type(key)}")
        for raw_key in sorted(keys):
            original = raw_key if raw_key in value else raw_key.decode("utf-8")
            out.append(bencode(raw_key))
            out.append(bencode(value[original]))
        out.append(b"e")
        return b"".join(out)
    raise TypeError(f"cannot bencode {type(value).__name__}")


class BencodeError(ValueError):
    pass


def _decode_at(data: bytes, pos: int) -> Tuple[Any, int]:
    if pos >= len(data):
        raise BencodeError("truncated bencode data")
    char = data[pos:pos + 1]
    if char == b"i":
        end = data.index(b"e", pos)
        text = data[pos + 1:end]
        if text in (b"", b"-") or (text.startswith(b"0") and text != b"0") or \
                text.startswith(b"-0"):
            raise BencodeError(f"invalid integer {text!r}")
        return int(text), end + 1
    if char == b"l":
        items = []
        pos += 1
        while data[pos:pos + 1] != b"e":
            item, pos = _decode_at(data, pos)
            items.append(item)
        return items, pos + 1
    if char == b"d":
        out = {}
        pos += 1
        last_key = None
        while data[pos:pos + 1] != b"e":
            key, pos = _decode_at(data, pos)
            if not isinstance(key, bytes):
                raise BencodeError("dict key must be a byte string")
            if last_key is not None and key <= last_key:
                # tolerated (some clients emit unsorted dicts) but the
                # re-encode will canonicalize
                pass
            last_key = key
            value, pos = _decode_at(data, pos)
            out[key] = value
        return out, pos + 1
    if char.isdigit():
        colon = data.index(b":", pos)
        length = int(data[pos:colon])
        start = colon + 1
        end = start + length
        if end > len(data):
            raise BencodeError("byte string exceeds buffer")
        return data[start:end], end
    raise BencodeError(f"unexpected byte {char!r} at {pos}")


def bdecode(data: bytes) -> Any:
    """Decode a single bencoded value; trailing bytes are an error."""
    value, end = _decode_at(bytes(data), 0)
    if end != len(data):
        raise BencodeError(f"{len(data) - end} trailing bytes")
    return value


def bdecode_prefix(data: bytes) -> Tuple[Any, int]:
    """Decode one value from the head of ``data``; returns (value, consumed).

    Used by ut_metadata messages, which append raw piece bytes after the
    bencoded header (BEP 9).
    """
    return _decode_at(bytes(data), 0)
