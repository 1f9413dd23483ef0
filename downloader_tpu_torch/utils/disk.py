"""Disk-space preflight shared by the download paths.

Losing a multi-GB transfer to ENOSPC at the tail is the worst way to
find out the volume is small — both the HTTP and torrent fetch paths
check up front and fail with a clear, actionable error instead.  The
``needed`` figure must already credit resumable bytes on disk (each
caller knows its own resume accounting); for sparse preallocated files
use :func:`allocated_bytes`, not ``st_size`` — a sparse truncate makes
apparent size lie about what the volume actually holds.
"""

from __future__ import annotations

import os
import shutil


class InsufficientDiskSpace(OSError):
    """The target volume cannot hold the remaining transfer."""


def allocated_bytes(path: str) -> int:
    """Bytes actually backed by the volume (``st_blocks``), clamped to
    apparent size — sparse preallocation inflates ``st_size`` without
    consuming space, and filesystem metadata can inflate ``st_blocks``
    past the data."""
    try:
        st = os.stat(path)
    except OSError:
        return 0
    blocks = getattr(st, "st_blocks", None)  # absent on e.g. Windows
    if blocks is None:
        return st.st_size
    return min(blocks * 512, st.st_size)


def dir_bytes(dirpath: str) -> int:
    """Total bytes actually backed by the volume under ``dirpath``
    (recursive; 0 for a missing dir).  Uses :func:`allocated_bytes` per
    file so sparse preallocated transfers report what they really hold —
    the per-tenant staging-footprint gauge feeds off this."""
    total = 0
    try:
        entries = os.scandir(dirpath)
    except OSError:
        return 0
    with entries:
        for entry in entries:
            try:
                if entry.is_dir(follow_symlinks=False):
                    total += dir_bytes(entry.path)
                elif entry.is_file(follow_symlinks=False):
                    total += allocated_bytes(entry.path)
            except OSError:
                continue
    return total


def free_bytes(dirpath: str) -> int:
    """Free bytes on ``dirpath``'s volume; 0 when the path is unstatable
    (callers treat that as "no headroom" rather than crashing)."""
    try:
        return shutil.disk_usage(dirpath).free
    except OSError:
        return 0


def ensure_disk_space(dirpath: str, needed: int) -> None:
    """Raise :class:`InsufficientDiskSpace` unless ``dirpath``'s volume
    has ``needed`` bytes free."""
    # fault-injection seam (platform/faults.py): "disk full during
    # staging" drills inject here instead of actually filling the volume
    from ..platform import faults

    if faults.enabled():
        faults.fire_sync("disk.preflight", key=dirpath)
    if needed <= 0:
        return
    free = shutil.disk_usage(dirpath).free
    if needed > free:
        raise InsufficientDiskSpace(
            f"insufficient disk space: download needs {needed} more "
            f"bytes, volume has {free} free"
        )
