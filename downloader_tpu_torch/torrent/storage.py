"""Piece <-> file mapping: read/write the torrent's linear byte stream across
its (possibly many) files on disk."""

from __future__ import annotations

import errno
import os
from typing import List, Tuple

# positioned IO where the platform has it (Unix); Windows falls back to
# lseek+read/write on the same cached fds.  The fd cache is NOT
# thread-safe; the invariant that protects it is strict sequencing, not
# instance isolation: the resume scan runs the SHARED storage in a
# worker thread, but the event loop awaits it to completion before the
# seeder or any download writer touches storage (client.py download
# flow).  Overlapping loop-thread calls with a scan would race the
# cache dict and, on the lseek fallback, the seek pointer.
_HAS_PREAD = hasattr(os, "pread")

from .metainfo import Metainfo


class TorrentStorage:
    """Maps absolute stream offsets onto files under ``root``.

    The reference hands webtorrent a download directory and lets it lay the
    torrent's files out inside it (upstream lib/download.js:64-66);
    this does the same: ``<root>/<file.path>``.
    """

    # bound on cached open file handles (a torrent rarely has more
    # files than this; evicting the oldest keeps pathological
    # many-file torrents from exhausting the process fd budget)
    MAX_CACHED_FDS = 64

    def __init__(self, meta: Metainfo, root: str):
        self.meta = meta
        self.root = os.path.abspath(root)
        # path -> O_RDWR fd.  The swarm serve path reads 16 KiB blocks;
        # re-opening the file per block was >2k opens per 32 MiB
        # transfer (profiled r5).  Positioned pread/pwrite keeps the
        # handles stateless, so concurrent serve/verify paths never
        # fight over a seek pointer.
        self._fds: dict = {}

    def _fd(self, path: str, write: bool = False) -> int:
        entry = self._fds.pop(path, None)
        if entry is not None and write and not entry[1]:
            os.close(entry[0])  # cached read-only, writer needs more
            entry = None
        if entry is None:
            flags = getattr(os, "O_BINARY", 0)  # Windows: no CRLF mangling
            if write:
                entry = (os.open(path, os.O_RDWR | flags), True)
            else:
                # fall back to read-only so seeding from write-protected
                # media libraries keeps working (the old per-call open
                # used "rb" here); EROFS (read-only mount) is a plain
                # OSError, not PermissionError (review r5)
                try:
                    entry = (os.open(path, os.O_RDWR | flags), True)
                except OSError as exc:
                    if exc.errno not in (errno.EACCES, errno.EPERM,
                                         errno.EROFS):
                        raise
                    entry = (os.open(path, os.O_RDONLY | flags), False)
            while len(self._fds) >= self.MAX_CACHED_FDS:
                old_path = next(iter(self._fds))
                os.close(self._fds.pop(old_path)[0])
        self._fds[path] = entry  # re-insert = LRU touch
        return entry[0]

    def close(self) -> None:
        """Release cached handles (idempotent; reopened on next use)."""
        fds, self._fds = self._fds, {}
        for fd, _writable in fds.values():
            try:
                os.close(fd)
            except OSError:
                pass

    def __del__(self):  # safety net; close() is the real lifecycle
        self.close()

    def file_path(self, entry_path: str) -> str:
        parts = [p for p in entry_path.split("/") if p not in ("", ".", "..")]
        return os.path.join(self.root, *parts)

    def _ranges(self, offset: int, length: int) -> List[Tuple[str, int, int, int]]:
        """(path, file_offset, stream_start, chunk_len) per touched file."""
        out = []
        end = offset + length
        for entry in self.meta.files:
            file_start = entry.offset
            file_end = entry.offset + entry.length
            lo = max(offset, file_start)
            hi = min(end, file_end)
            if lo < hi:
                out.append(
                    (self.file_path(entry.path), lo - file_start, lo - offset, hi - lo)
                )
        return out

    def preallocate(self) -> None:
        for entry in self.meta.files:
            path = self.file_path(entry.path)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if not os.path.exists(path) or os.path.getsize(path) != entry.length:
                with open(path, "wb") as fh:
                    fh.truncate(entry.length)

    @staticmethod
    def _pwrite(fd: int, chunk, pos: int) -> int:
        if _HAS_PREAD:
            return os.pwrite(fd, chunk, pos)
        os.lseek(fd, pos, os.SEEK_SET)
        return os.write(fd, chunk)

    @staticmethod
    def _pread(fd: int, n: int, pos: int) -> bytes:
        if _HAS_PREAD:
            return os.pread(fd, n, pos)
        os.lseek(fd, pos, os.SEEK_SET)
        return os.read(fd, n)

    def write(self, offset: int, data: bytes) -> None:
        view = memoryview(data)
        for path, file_off, rel, length in self._ranges(offset, len(data)):
            fd = self._fd(path, write=True)
            pos = file_off
            chunk = view[rel:rel + length]
            while chunk:
                n = self._pwrite(fd, chunk, pos)
                pos += n
                chunk = chunk[n:]

    def read(self, offset: int, length: int) -> bytes:
        out = bytearray(length)
        for path, file_off, rel, chunk_len in self._ranges(offset, length):
            fd = self._fd(path)
            got = 0
            while got < chunk_len:
                piece = self._pread(fd, chunk_len - got, file_off + got)
                if not piece:
                    break  # short file: leave zeros, like the old read
                out[rel + got:rel + got + len(piece)] = piece
                got += len(piece)
        return bytes(out)

    def read_piece(self, index: int) -> bytes:
        return self.read(
            index * self.meta.piece_length, self.meta.piece_size(index)
        )

    def write_piece(self, index: int, data: bytes) -> None:
        self.write(index * self.meta.piece_length, data)
