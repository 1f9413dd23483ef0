"""Torrent metainfo: parse/build ``.torrent`` info dicts (BEP 3).

Supports single-file and multi-file torrents.  The infohash is SHA-1 of the
canonically re-encoded ``info`` dict — the identity the whole protocol keys
on (handshakes, tracker announces, magnet links).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List, Optional

from .bencode import bdecode, bencode

BLOCK_SIZE = 1 << 14  # 16 KiB, the universal request granularity


@dataclasses.dataclass(frozen=True)
class FileEntry:
    path: str          # relative path inside the torrent (''/'-joined)
    length: int
    offset: int        # absolute byte offset in the torrent's linear stream


@dataclasses.dataclass(frozen=True)
class Metainfo:
    info_hash: bytes           # 20-byte SHA-1
    name: str
    piece_length: int
    piece_hashes: List[bytes]  # 20 bytes each
    files: List[FileEntry]
    info_bytes: bytes          # canonical bencoded info dict (for ut_metadata)
    trackers: List[str] = dataclasses.field(default_factory=list)
    # BEP 19 HTTP seeds (``url-list`` in .torrent / ``ws=`` in magnets)
    webseeds: List[str] = dataclasses.field(default_factory=list)

    @property
    def total_length(self) -> int:
        return sum(f.length for f in self.files)

    @property
    def num_pieces(self) -> int:
        return len(self.piece_hashes)

    def piece_size(self, index: int) -> int:
        if index == self.num_pieces - 1:
            remainder = self.total_length - self.piece_length * index
            return remainder
        return self.piece_length

    def to_torrent_bytes(self) -> bytes:
        """Serialize back to a ``.torrent`` file."""
        data: dict = {b"info": bdecode(self.info_bytes)}
        if self.trackers:
            data[b"announce"] = self.trackers[0].encode()
            if len(self.trackers) > 1:
                data[b"announce-list"] = [[t.encode()] for t in self.trackers]
        if self.webseeds:
            data[b"url-list"] = [u.encode() for u in self.webseeds]
        return bencode(data)


def parse_info_dict(info_bytes: bytes, trackers: Optional[List[str]] = None,
                    webseeds: Optional[List[str]] = None) -> Metainfo:
    """Build a :class:`Metainfo` from a bencoded info dict."""
    info = bdecode(info_bytes)
    canonical = bencode(info)
    info_hash = hashlib.sha1(canonical).digest()
    name = info[b"name"].decode("utf-8", "surrogateescape")
    piece_length = info[b"piece length"]
    pieces_blob = info[b"pieces"]
    if len(pieces_blob) % 20 != 0:
        raise ValueError("pieces blob not a multiple of 20 bytes")
    piece_hashes = [pieces_blob[i:i + 20] for i in range(0, len(pieces_blob), 20)]

    files: List[FileEntry] = []
    if b"files" in info:  # multi-file: paths nest under the torrent name
        offset = 0
        for entry in info[b"files"]:
            rel = "/".join(
                part.decode("utf-8", "surrogateescape") for part in entry[b"path"]
            )
            files.append(FileEntry(path=f"{name}/{rel}", length=entry[b"length"],
                                   offset=offset))
            offset += entry[b"length"]
    else:
        files.append(FileEntry(path=name, length=info[b"length"], offset=0))

    expected = sum(f.length for f in files)
    max_len = piece_length * len(piece_hashes)
    if not (max_len - piece_length < expected <= max_len):
        raise ValueError(
            f"length {expected} inconsistent with {len(piece_hashes)} pieces "
            f"of {piece_length}"
        )
    return Metainfo(
        info_hash=info_hash,
        name=name,
        piece_length=piece_length,
        piece_hashes=piece_hashes,
        files=files,
        info_bytes=canonical,
        trackers=list(trackers or []),
        webseeds=list(webseeds or []),
    )


def parse_torrent_bytes(data: bytes) -> Metainfo:
    """Parse a ``.torrent`` file's bytes."""
    outer = bdecode(data)
    trackers: List[str] = []
    if b"announce-list" in outer:
        for tier in outer[b"announce-list"]:
            for tracker in tier:
                url = tracker.decode()
                if url not in trackers:
                    trackers.append(url)
    if b"announce" in outer:
        url = outer[b"announce"].decode()
        if url not in trackers:
            trackers.insert(0, url)
    webseeds: List[str] = []
    url_list = outer.get(b"url-list", [])
    if isinstance(url_list, bytes):  # BEP 19 allows a bare string
        url_list = [url_list]
    for entry in url_list:
        if isinstance(entry, bytes):
            url = entry.decode("utf-8", "surrogateescape")
            if url not in webseeds:
                webseeds.append(url)
    return parse_info_dict(bencode(outer[b"info"]), trackers, webseeds)


def make_metainfo(
    root: str,
    name: Optional[str] = None,
    piece_length: int = 1 << 18,
    trackers: Optional[List[str]] = None,
    webseeds: Optional[List[str]] = None,
) -> Metainfo:
    """Create metainfo for a file or directory on disk (the seeding side).

    Directory sources become multi-file torrents with deterministic
    (sorted) file order.
    """
    if piece_length < BLOCK_SIZE:
        # non-positive values would spin _feed forever; tiny ones break
        # the universal 16 KiB request granularity
        raise ValueError(
            f"piece_length {piece_length} < BLOCK_SIZE {BLOCK_SIZE}"
        )
    root = os.path.abspath(root)
    name = name or os.path.basename(root)

    paths: List[str] = []
    if os.path.isdir(root):
        for dirpath, _dirnames, filenames in os.walk(root):
            for filename in filenames:
                paths.append(os.path.join(dirpath, filename))
        paths.sort()
    else:
        paths.append(root)

    hasher = hashlib.sha1()
    piece_hashes: List[bytes] = []
    in_piece = 0

    def _feed(chunk: bytes) -> None:
        nonlocal hasher, in_piece
        view = memoryview(chunk)
        while view:
            take = min(len(view), piece_length - in_piece)
            hasher.update(view[:take])
            in_piece += take
            view = view[take:]
            if in_piece == piece_length:
                piece_hashes.append(hasher.digest())
                hasher = hashlib.sha1()
                in_piece = 0

    entries = []
    for path in paths:
        length = os.path.getsize(path)
        with open(path, "rb") as fh:
            while True:
                chunk = fh.read(1 << 20)
                if not chunk:
                    break
                _feed(chunk)
        entries.append((path, length))
    if in_piece:
        piece_hashes.append(hasher.digest())

    pieces_blob = b"".join(piece_hashes)
    if os.path.isdir(root):
        info = {
            b"name": name.encode(),
            b"piece length": piece_length,
            b"pieces": pieces_blob,
            b"files": [
                {
                    b"length": length,
                    b"path": [
                        part.encode()
                        for part in os.path.relpath(path, root).split(os.sep)
                    ],
                }
                for path, length in entries
            ],
        }
    else:
        info = {
            b"name": name.encode(),
            b"piece length": piece_length,
            b"pieces": pieces_blob,
            b"length": entries[0][1],
        }
    return parse_info_dict(bencode(info), trackers, webseeds)
