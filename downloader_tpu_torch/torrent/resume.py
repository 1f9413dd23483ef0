"""Fast-resume sidecar: skip the full re-hash when nothing changed.

Without resume data, every restart hashes every piece on disk before a
single byte moves (``TorrentClient._resume_from_disk``) — minutes for a
large torrent.  Mainstream clients (libtorrent et al.) persist a resume
record instead; webtorrent relied on re-hashing, so this is a capability
the rebuild adds on top of the reference (which restarted jobs from
zero anyway, SURVEY.md §5 "checkpoint/resume").

The record (``.dt-resume`` JSON in the download directory) holds the
info-hash, the verified-piece bitfield, and each file's (size,
mtime_ns) captured AFTER the last write.  On load, a piece is trusted
only when every file it touches still matches its recorded size and
mtime; anything else falls back to hashing that piece.  The check is
deliberately conservative: a crash mid-write leaves mtimes newer than
the record, so the affected files re-hash; an orderly exit — completed
download, stall-watchdog abort that the queue will redeliver, SIGTERM
drain — resumes instantly.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Dict, Optional, Set

from .metainfo import Metainfo

RESUME_NAME = ".dt-resume"
_VERSION = 1


def _resume_path(root: str) -> str:
    return os.path.join(os.path.abspath(root), RESUME_NAME)


def _pack_bitfield(done: Set[int], num_pieces: int) -> str:
    bits = bytearray((num_pieces + 7) // 8)
    for index in done:
        bits[index >> 3] |= 0x80 >> (index & 7)
    return base64.b64encode(bytes(bits)).decode("ascii")


def _unpack_bitfield(blob: str, num_pieces: int) -> Set[int]:
    bits = base64.b64decode(blob)
    return {
        index for index in range(num_pieces)
        if index >> 3 < len(bits) and bits[index >> 3] & (0x80 >> (index & 7))
    }


def save_resume(root: str, meta: Metainfo, done: Set[int]) -> None:
    """Record the verified bitfield + file fingerprints (best-effort:
    resume data is an optimization, never worth failing a download
    over)."""
    from .storage import TorrentStorage

    storage = TorrentStorage(meta, root)
    files = []
    try:
        for entry in meta.files:
            st = os.stat(storage.file_path(entry.path))
            files.append({
                "path": entry.path,
                "size": st.st_size,
                "mtime_ns": st.st_mtime_ns,
            })
        record = {
            "version": _VERSION,
            "info_hash": meta.info_hash.hex(),
            "num_pieces": meta.num_pieces,
            "bitfield": _pack_bitfield(done, meta.num_pieces),
            "files": files,
        }
        tmp = _resume_path(root) + ".tmp"
        with open(tmp, "w", encoding="ascii") as fh:
            json.dump(record, fh)
        os.replace(tmp, _resume_path(root))
    except OSError:
        pass


def load_resume(root: str, meta: Metainfo) -> Optional[Set[int]]:
    """Trusted verified-piece set, or None when there is no usable record.

    Pieces touching a file whose (size, mtime_ns) changed since the
    record was written are dropped from the returned set — they go back
    through the hash check like any other on-disk data."""
    from .storage import TorrentStorage

    try:
        with open(_resume_path(root), "r", encoding="ascii") as fh:
            record = json.load(fh)
    except (OSError, ValueError):
        return None
    if (record.get("version") != _VERSION
            or record.get("info_hash") != meta.info_hash.hex()
            or record.get("num_pieces") != meta.num_pieces):
        return None

    storage = TorrentStorage(meta, root)
    recorded: Dict[str, dict] = {
        f.get("path"): f for f in record.get("files", [])
    }
    intact_files = set()
    for entry in meta.files:
        info = recorded.get(entry.path)
        if info is None:
            continue
        try:
            st = os.stat(storage.file_path(entry.path))
        except OSError:
            continue
        if (st.st_size == info.get("size")
                and st.st_mtime_ns == info.get("mtime_ns")):
            intact_files.add(entry.path)

    try:
        done = _unpack_bitfield(record["bitfield"], meta.num_pieces)
    except (KeyError, ValueError):
        return None

    piece_len = meta.piece_length
    trusted = set()
    for index in done:
        start = index * piece_len
        end = start + meta.piece_size(index)
        touched_ok = all(
            entry.path in intact_files
            for entry in meta.files
            if entry.offset < end and entry.offset + entry.length > start
        )
        if touched_ok:
            trusted.add(index)
    return trusted
