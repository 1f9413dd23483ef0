"""A read-only OCDBT key-value store: the on-disk format tensorstore's
``ocdbt`` driver writes and orbax keeps every checkpoint item in.

An item directory holds ``manifest.ocdbt`` and data files under ``d/``
(orbax's per-process trees sit in ``ocdbt.process_N/``, and the root
tree points into their data files).  Every manifest, version-tree node
and b-tree node is a file, or a stretch of a data file, laid out as

    magic (u32 big-endian) | length (u64) | version (varint, 0) |
    compression (varint: 0 none, 1 zstd) | body | crc32c (u32)

where the crc covers everything before it.  The manifest's body holds
the store's config, then the newest stretch of the version tree: a
data-file table and, for each version, the address of its b-tree root
(older versions sit in version-tree nodes, which the newest does not
need).
A b-tree node holds its own data-file table and either child addresses
(interior) or keys with values stored inline or as (data file, offset,
length) references (leaf).  Keys are prefix-coded within a node, and each
child's keys drop the prefix its parent's entry names.

Only what orbax's writes produce is read: a single-file manifest, format
version 0, no or zstd compression.  Anything else, and any malformed,
truncated or missing file, raises ``ValueError`` naming the file.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple, Union

from . import zstd

MANIFEST = "manifest.ocdbt"
_MANIFEST_MAGIC = 0x0CDB3A2A
_BTREE_NODE_MAGIC = 0x0CDB20DE
_HEADER = 4 + 8
_NO_ADDRESS = (1 << 64) - 1
_MAX_HEIGHT = 64

# a value: bytes held inline, or (data file path, offset, length)
_Value = Union[bytes, Tuple[str, int, int]]


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the OCDBT footer holds it."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads the fields of one decoded body; every read is bounds-checked."""

    __slots__ = ("data", "pos", "where")

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, why: str) -> ValueError:
        return ValueError(f"{self.where}: {why}")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise self.fail("truncated OCDBT node")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        for _ in range(10):
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                if value > _NO_ADDRESS:
                    break
                return value
            shift += 7
        raise self.fail("malformed varint")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u64s(self, n: int) -> List[int]:
        return [int.from_bytes(self.take(8), "little") for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise self.fail(f"{len(self.data) - self.pos} bytes after the OCDBT node")


def _decode(raw: bytes, magic: int, where: str) -> bytes:
    """The body of one OCDBT file (header checked, crc checked,
    decompressed)."""
    if len(raw) < _HEADER + 2 + 4:
        raise ValueError(f"{where}: truncated OCDBT file")
    if int.from_bytes(raw[:4], "big") != magic:
        raise ValueError(f"{where}: not an OCDBT file of the expected kind "
                         f"(magic {raw[:4].hex()})")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise ValueError(f"{where}: OCDBT length field does not match the "
                         f"{len(raw)} bytes read (truncated?)")
    if _crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise ValueError(f"{where}: OCDBT checksum mismatch")
    head = _Cursor(raw[_HEADER:-4], where)
    version = head.varint()
    if version != 0:
        raise ValueError(f"{where}: OCDBT format version {version} is not supported")
    compression = head.varint()
    body = raw[_HEADER + head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        try:
            return zstd.decompress(body)
        except ValueError as err:
            raise ValueError(f"{where}: {err}") from err
    raise ValueError(f"{where}: OCDBT compression {compression} is not supported")


def _data_file_table(cur: _Cursor, base: str) -> List[Tuple[str, str]]:
    """A data-file table: per file (its path under the store's root, the
    base path its own nodes' tables are relative to)."""
    n = cur.varint()
    prefix = cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    base_len = cur.varints(n)
    files: List[Tuple[str, str]] = []
    previous = b""
    for i in range(n):
        shared = prefix[i - 1] if i else 0
        if shared > len(previous):
            raise cur.fail("malformed data-file table")
        path = previous[:shared] + cur.take(suffix[i])
        if base_len[i] > len(path):
            raise cur.fail("malformed data-file table")
        previous = path
        text = path.decode("utf-8", "strict")
        full = base + text
        if full.startswith("/") or ".." in full.split("/"):
            raise cur.fail(f"data file path {full!r} leaves the store")
        files.append((full, base + text[:base_len[i]]))
    return files


class OcdbtStore:
    """The newest version of the OCDBT store rooted at ``root``:
    :meth:`list` its keys and :meth:`read` their values."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._entries: Dict[bytes, _Value] = {}
        cur = _Cursor(_decode(self._read_file(MANIFEST), _MANIFEST_MAGIC,
                              self._where(MANIFEST)), self._where(MANIFEST))
        cur.take(16)                           # uuid
        kind = cur.varint()
        if kind != 0:
            raise cur.fail(f"manifest kind {kind} (numbered manifests) is not supported")
        cur.varints(2)                         # max inline value, node bytes
        cur.byte()                             # version_tree_arity_log2
        compression = cur.varint()
        if compression == 1:
            cur.take(4)                        # zstd level
        elif compression:
            raise cur.fail(f"OCDBT compression {compression} is not supported")
        files = _data_file_table(cur, "")
        n = cur.varint()
        if not n:
            raise cur.fail("manifest holds no version")
        cur.varints(n)                         # generation numbers
        heights = [cur.byte() for _ in range(n)]
        ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(3 * n)                     # key, tree and value byte counts
        cur.u64s(n)                            # commit times
        refs = cur.varint()                    # older versions' tree nodes
        cur.varints(5 * refs)
        cur.u64s(refs)
        cur.take(refs)
        cur.end()
        if offsets[-1] != _NO_ADDRESS:         # else the newest version is empty
            self._walk(self._address(cur, files, ids[-1], offsets[-1], lengths[-1]),
                       heights[-1], b"")

    # -- public ------------------------------------------------------

    def list(self) -> List[str]:
        """Every key of the newest version, in order."""
        return [k.decode("utf-8") for k in sorted(self._entries)]

    def read(self, key: str) -> bytes:
        """The value of ``key``; ``KeyError`` when the store lacks it."""
        value = self._entries[key.encode("utf-8")]
        if isinstance(value, bytes):
            return value
        path, offset, length = value
        return self._read_file(path, offset, length)

    def __contains__(self, key: str) -> bool:
        return key.encode("utf-8") in self._entries

    # -- reading -----------------------------------------------------

    def _where(self, path: str) -> str:
        return os.path.join(self.root, path)

    def _read_file(self, path: str, offset: int = 0, length: int = -1) -> bytes:
        where = self._where(path)
        try:
            with open(where, "rb") as fh:
                fh.seek(offset)
                data = fh.read(length) if length >= 0 else fh.read()
        except OSError as err:
            raise ValueError(f"{where}: cannot read OCDBT file ({err.strerror})") from err
        if length >= 0 and len(data) != length:
            raise ValueError(f"{where}: truncated OCDBT data file (wanted {length} "
                             f"bytes at offset {offset}, found {len(data)})")
        return data

    @staticmethod
    def _address(cur: _Cursor, files: List[Tuple[str, str]], file_id: int,
                 offset: int, length: int) -> Tuple[str, str, int, int]:
        if file_id >= len(files):
            raise cur.fail(f"data file {file_id} is not in the table")
        path, base = files[file_id]
        return path, base, offset, length

    def _walk(self, address: Tuple[str, str, int, int], height: int,
              prefix: bytes) -> None:
        path, base, offset, length = address
        where = f"{self._where(path)} @ {offset}"
        cur = _Cursor(_decode(self._read_file(path, offset, length),
                              _BTREE_NODE_MAGIC, where), where)
        if cur.byte() != height or height > _MAX_HEIGHT:
            raise cur.fail("b-tree node height does not match its reference")
        files = _data_file_table(cur, base)
        n = cur.varint()
        shared = cur.varints(max(n - 1, 0))
        suffix = cur.varints(n)
        common = cur.varints(n) if height else [0] * n
        keys: List[bytes] = []
        for i in range(n):
            keep = shared[i - 1] if i else 0
            if keep > (len(keys[-1]) if keys else 0):
                raise cur.fail("malformed key prefix")
            keys.append((keys[-1][:keep] if i else b"") + cur.take(suffix[i]))
        if height:
            ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)                 # key, tree and value byte counts
            cur.end()
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise cur.fail("malformed subtree prefix")
                self._walk(self._address(cur, files, ids[i], offsets[i], lengths[i]),
                           height - 1, prefix + keys[i][:common[i]])
            return
        sizes = cur.varints(n)
        kinds = cur.varints(n)
        if any(k > 1 for k in kinds):
            raise cur.fail("unknown value kind")
        indirect = sum(kinds)
        ids, offsets = cur.varints(indirect), cur.varints(indirect)
        j = 0
        for key, size, kind in zip(keys, sizes, kinds):
            if kind:
                path_j = self._address(cur, files, ids[j], offsets[j], size)[0]
                self._entries[prefix + key] = (path_j, offsets[j], size)
                j += 1
            else:
                self._entries[prefix + key] = cur.take(size)
        cur.end()
