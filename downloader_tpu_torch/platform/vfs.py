"""The write-syscall shim the storage fault plane rides.

Every landing/staging write in the service — the HTTP landing loop
(stages/download.py), the io_uring fallback (utils/uring.py), the fs
store's atomic writers and spill paths (store/fs.py) — routes its
write syscalls through this module instead of calling ``os.write`` /
``os.pwrite`` / ``os.replace`` directly.  In production the shim is a
pass-through (one module-level ``None`` check per call, the same cost
as the fault seams); under a fault plan with ``kind: disk`` rules
(platform/faults.py) it enacts the storage failure shapes a kernel
write path really has:

- ``enospc`` / ``eio`` — :class:`~.faults.DiskFault` raised from
  inside the write call, carrying the real errno
- ``short``   — ONE syscall accepts fewer bytes than asked; the
  caller's resume loop must carry on at the right offset
- ``latency`` — the write stalls (only enacted where the caller
  attests it is off the event loop: ``thread_ok=True``)
- ``torn``    — at :func:`promote`: rename WITHOUT the fsync, zero the
  tail of the renamed file, SIGKILL — the exact page-cache-loss state
  a power cut leaves behind a rename-before-data-durable bug.  The
  file's SIZE still matches (the torn pages are zeroed, not missing),
  so only digest-based boot recovery can catch it — which is the
  point.

Seam names fan the family out so one drill can target one layer:
``disk.write`` (landing/stream writes), ``disk.promote`` (the
fsync-before-rename publish), ``disk.fsync`` (durability barriers),
``disk.spill`` (fs-store atomic writers: cache inserts, shared-tier
spill, staged publish).  All share the ``disk`` dependency family, so
``seam: "disk.*"`` drills the whole plane.

:func:`promote` is also where the crash-consistency discipline lives:
fsync the data file, rename, fsync the parent directory — so a
promoted name never points at bytes the disk does not have.  Callers
that promote multi-GB landings run it off the loop
(``asyncio.to_thread``)."""

from __future__ import annotations

import os

from . import faults

#: bytes zeroed at the end of a torn-promoted file (one page's worth
#: rounded up — enough to defeat any size-only validity check)
TORN_TAIL_BYTES = 4096


def _action(seam: str, key: str, thread_ok: bool):
    if faults.enabled():
        return faults.disk_action(seam, key, thread_ok=thread_ok)
    return None


def _short(view: memoryview) -> memoryview:
    """The truncated prefix a short write accepts (always >= 1 byte, so
    forward progress is preserved and the drill can't livelock a
    write-all loop)."""
    if len(view) <= 1:
        return view
    return view[: max(1, len(view) // 2)]


def write(fd: int, data, *, seam: str = "disk.write", key: str = "",
          thread_ok: bool = False) -> int:
    """``os.write`` with the disk fault plan applied (may be short)."""
    view = memoryview(data)
    if _action(seam, key, thread_ok) == "short":
        view = _short(view)
    return os.write(fd, view)


def pwrite(fd: int, data, offset: int, *, seam: str = "disk.write",
           key: str = "", thread_ok: bool = True) -> int:
    """``os.pwrite`` with the disk fault plan applied (may be short)."""
    view = memoryview(data)
    if _action(seam, key, thread_ok) == "short":
        view = _short(view)
    return os.pwrite(fd, view, offset)


def write_all(fd: int, view, pos: "int | None", *,
              seam: str = "disk.write", key: str = "",
              thread_ok: bool = False) -> None:
    """Write a full buffer at ``pos`` (None = the fd's own offset),
    resuming short writes at the right offset — the landing loops'
    one write primitive."""
    view = memoryview(view)
    while view:
        if pos is None:
            n = write(fd, view, seam=seam, key=key, thread_ok=thread_ok)
        else:
            n = pwrite(fd, view, pos, seam=seam, key=key,
                       thread_ok=thread_ok)
            pos += n
        view = view[n:]


def fh_write_all(fh, data, *, seam: str = "disk.write", key: str = "",
                 thread_ok: bool = False) -> int:
    """Write a full buffer to a raw/binary file object, resuming short
    writes (a ``buffering=0`` stream's write is one syscall and may
    legally accept fewer bytes).  Returns bytes written."""
    view = memoryview(data)
    total = len(view)
    while view:
        sub = view
        if _action(seam, key, thread_ok) == "short":
            sub = _short(view)
        n = fh.write(sub)
        if n is None:  # non-blocking raw stream contract; not expected
            n = len(sub)
        view = view[n:]
    return total


def fsync(fd: int, *, seam: str = "disk.fsync", key: str = "") -> None:
    """``os.fsync`` with the disk fault plan applied (EIO drills)."""
    _action(seam, key, True)
    os.fsync(fd)


def fsync_path(path: str, *, seam: str = "disk.fsync",
               key: str = "") -> None:
    """Open-fsync-close one path — the promote barrier."""
    _action(seam, key or path, True)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Best-effort directory fsync (making a rename durable).  Swallows
    OSError: some filesystems refuse directory fsync, and a promote
    must not fail on the barrier a lesser filesystem cannot provide."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _torn_promote(src: str, dst: str, seam: str) -> None:
    """Enact the ``torn`` drill: rename without the data fsync, zero
    the file's tail (the pages the cache never wrote back), then die
    the way a power cut dies.  Never returns."""
    os.replace(src, dst)
    try:
        size = os.path.getsize(dst)
        tail = min(size, TORN_TAIL_BYTES)
        if tail:
            with open(dst, "r+b") as fh:
                fh.seek(size - tail)
                fh.write(b"\0" * tail)
                fh.flush()
                os.fsync(fh.fileno())
    except OSError:
        pass
    faults._crash_now(seam)


def promote(src: str, dst: str, *, seam: str = "disk.promote",
            key: str = "", durable: bool = True) -> None:
    """Crash-consistent rename-into-place: fsync the data file BEFORE
    the rename and the parent directory after, so the published name
    never points at bytes the disk does not hold.  ``durable=False``
    skips the barriers for small metadata sidecars whose loss is
    harmless (they are re-derivable).  ENOSPC/EIO disk rules raise
    here; a ``torn`` rule enacts the page-loss crash instead."""
    action = _action(seam, key or dst, True)
    if action == "torn":
        _torn_promote(src, dst, seam)
    if durable:
        fd = os.open(src, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    os.replace(src, dst)
    if durable:
        fsync_dir(os.path.dirname(dst))
