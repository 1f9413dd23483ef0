"""io_uring spike for the segmented chunk-landing loop.

A minimal, dependency-free (ctypes + raw syscalls) io_uring ring that
replaces the one-``pwrite``-syscall-per-chunk landing discipline with a
kernel submission ring.  Scope is deliberately a *spike*:

- synchronous submit-one/wait-one semantics, byte-identical to
  ``os.pwrite`` (the caller — the segmented download's single writer
  thread — sees the same blocking contract);
- ``available()`` probes once per process and memoizes, so a kernel
  without io_uring, a seccomp-filtered container, or a locked-down
  ``io_uring_disabled`` sysctl all degrade silently to ``os.pwrite``;
- opt-in via the ``download.io_uring`` knob (default off) — the knob
  turns the probe on, the probe turns the ring on.

The synchronous pattern leans on the syscall boundary itself as the
memory barrier: our SQ-tail store happens-before ``io_uring_enter``,
and the CQE read happens-after it returns with ``GETEVENTS`` — no
atomics needed from Python.  Single-threaded by contract (one ring per
writer thread; the landing path owns exactly one).
"""

from __future__ import annotations

import ctypes
import errno
import mmap
import os
import struct
import sys
import threading

# x86_64 and aarch64 share these io_uring syscall numbers
_NR_IO_URING_SETUP = 425
_NR_IO_URING_ENTER = 426

_IORING_OFF_SQ_RING = 0
_IORING_OFF_SQES = 0x10000000

_IORING_ENTER_GETEVENTS = 1
_IORING_FEAT_SINGLE_MMAP = 1
_IORING_OP_WRITE = 23

_SQE_SIZE = 64
_CQE_SIZE = 16

_libc = None


def _lib():
    global _libc
    if _libc is None:
        _libc = ctypes.CDLL(None, use_errno=True)
        _libc.syscall.restype = ctypes.c_long
    return _libc


class _SqOffsets(ctypes.Structure):
    _fields_ = [
        ("head", ctypes.c_uint32),
        ("tail", ctypes.c_uint32),
        ("ring_mask", ctypes.c_uint32),
        ("ring_entries", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("dropped", ctypes.c_uint32),
        ("array", ctypes.c_uint32),
        ("resv1", ctypes.c_uint32),
        ("user_addr", ctypes.c_uint64),
    ]


class _CqOffsets(ctypes.Structure):
    _fields_ = [
        ("head", ctypes.c_uint32),
        ("tail", ctypes.c_uint32),
        ("ring_mask", ctypes.c_uint32),
        ("ring_entries", ctypes.c_uint32),
        ("overflow", ctypes.c_uint32),
        ("cqes", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("resv1", ctypes.c_uint32),
        ("user_addr", ctypes.c_uint64),
    ]


class _UringParams(ctypes.Structure):
    _fields_ = [
        ("sq_entries", ctypes.c_uint32),
        ("cq_entries", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("sq_thread_cpu", ctypes.c_uint32),
        ("sq_thread_idle", ctypes.c_uint32),
        ("features", ctypes.c_uint32),
        ("wq_fd", ctypes.c_uint32),
        ("resv", ctypes.c_uint32 * 3),
        ("sq_off", _SqOffsets),
        ("cq_off", _CqOffsets),
    ]


def _setup(entries: int, params: _UringParams) -> int:
    res = _lib().syscall(
        ctypes.c_long(_NR_IO_URING_SETUP),
        ctypes.c_long(entries),
        ctypes.byref(params),
    )
    if res < 0:
        err = ctypes.get_errno()
        raise OSError(err, os.strerror(err))
    return int(res)


def _enter(ring_fd: int, to_submit: int, min_complete: int,
           flags: int) -> int:
    while True:
        res = _lib().syscall(
            ctypes.c_long(_NR_IO_URING_ENTER),
            ctypes.c_long(ring_fd),
            ctypes.c_long(to_submit),
            ctypes.c_long(min_complete),
            ctypes.c_long(flags),
            ctypes.c_void_p(0),
            ctypes.c_long(0),
        )
        if res >= 0:
            return int(res)
        err = ctypes.get_errno()
        if err == errno.EINTR:
            continue
        raise OSError(err, os.strerror(err))


class UringWriter:
    """One io_uring ring exposing a blocking ``pwrite`` equivalent."""

    def __init__(self, entries: int = 8):
        self._fd = -1
        self._ring = None
        self._sqes = None
        if not sys.platform.startswith("linux"):
            raise RuntimeError("io_uring: linux only")
        try:
            params = _UringParams()
            self._fd = _setup(entries, params)
            if not params.features & _IORING_FEAT_SINGLE_MMAP:
                # pre-5.4 two-mapping rings aren't worth supporting in
                # a spike: such kernels predate usable io_uring anyway
                raise RuntimeError("io_uring: kernel lacks single mmap")
            sq_size = params.sq_off.array + params.sq_entries * 4
            cq_size = params.cq_off.cqes + params.cq_entries * _CQE_SIZE
            flags = mmap.MAP_SHARED | getattr(mmap, "MAP_POPULATE", 0)
            self._ring = mmap.mmap(
                self._fd, max(sq_size, cq_size), flags=flags,
                prot=mmap.PROT_READ | mmap.PROT_WRITE,
                offset=_IORING_OFF_SQ_RING,
            )
            self._sqes = mmap.mmap(
                self._fd, params.sq_entries * _SQE_SIZE, flags=flags,
                prot=mmap.PROT_READ | mmap.PROT_WRITE,
                offset=_IORING_OFF_SQES,
            )
            off = params.sq_off
            self._sq_tail = off.tail
            self._sq_array = off.array
            self._sq_mask = struct.unpack_from(
                "<I", self._ring, off.ring_mask)[0]
            coff = params.cq_off
            self._cq_head = coff.head
            self._cq_tail = coff.tail
            self._cq_cqes = coff.cqes
            self._cq_mask = struct.unpack_from(
                "<I", self._ring, coff.ring_mask)[0]
        except BaseException:
            self.close()
            raise

    def pwrite(self, fd: int, data, offset: int) -> int:
        """``os.pwrite(fd, data, offset)`` through the ring.

        Submits IORING_OP_WRITE and waits for its completion before
        returning.  A degraded completion — an error CQE (e.g. ``-EIO``
        from a ring the kernel has soured on this fd) or a short/zero
        write — does NOT re-drive the ring: the remainder lands through
        one plain ``os.pwrite`` loop at the resumed offset, so the
        buffer is landed exactly once at exactly the right bytes and a
        sick ring never gets a second chance to corrupt the landing.
        Errors that are real disk errors (ENOSPC, hard EIO) reproduce
        in the fallback and surface with their ordinary errno.
        """
        if not isinstance(data, bytes):
            data = bytes(data)
        # c_char_p pins the bytes object's own buffer — no copy; the
        # reference (and hence the address) outlives the synchronous
        # submit/complete round-trip below
        ref = ctypes.c_char_p(data)
        addr = ctypes.cast(ref, ctypes.c_void_p).value or 0
        total, length = 0, len(data)
        while total < length:
            res = self._submit_write(
                fd, addr + total, length - total, offset + total)
            if res == length - total:
                total += res
                continue
            if res > 0:
                total += res
            total = self._pwrite_fallback(fd, data, offset, total)
            break
        del ref
        return total

    @staticmethod
    def _pwrite_fallback(fd: int, data: bytes, offset: int,
                         total: int) -> int:
        """Finish ``data[total:]`` with plain ``pwrite`` at the resumed
        offset (through the vfs shim, so disk drills still apply)."""
        from ..platform import vfs

        length = len(data)
        while total < length:
            n = vfs.pwrite(fd, memoryview(data)[total:], offset + total,
                           thread_ok=True)
            if n <= 0:
                raise OSError(errno.EIO, "pwrite fallback: zero-byte write")
            total += n
        return total

    def _submit_write(self, fd: int, addr: int, length: int,
                      offset: int) -> int:
        ring, sqes = self._ring, self._sqes
        tail = struct.unpack_from("<I", ring, self._sq_tail)[0]
        idx = tail & self._sq_mask
        base = idx * _SQE_SIZE
        sqes[base:base + _SQE_SIZE] = b"\x00" * _SQE_SIZE
        # opcode, flags, ioprio, fd, off, addr, len, rw_flags, user_data
        struct.pack_into(
            "<BBHiQQIIQ", sqes, base,
            _IORING_OP_WRITE, 0, 0, fd, offset, addr, length, 0, tail,
        )
        struct.pack_into("<I", ring, self._sq_array + idx * 4, idx)
        struct.pack_into("<I", ring, self._sq_tail, tail + 1)
        _enter(self._fd, 1, 1, _IORING_ENTER_GETEVENTS)
        head = struct.unpack_from("<I", ring, self._cq_head)[0]
        cq_tail = struct.unpack_from("<I", ring, self._cq_tail)[0]
        if head == cq_tail:
            raise RuntimeError("io_uring: enter returned without CQE")
        cqe = self._cq_cqes + (head & self._cq_mask) * _CQE_SIZE
        _user_data, res, _flags = struct.unpack_from("<QiI", ring, cqe)
        struct.pack_into("<I", ring, self._cq_head, head + 1)
        return res

    def close(self) -> None:
        for name in ("_sqes", "_ring"):
            mm = getattr(self, name, None)
            if mm is not None:
                try:
                    mm.close()
                except (BufferError, ValueError):
                    pass
                setattr(self, name, None)
        if self._fd >= 0:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = -1

    def __enter__(self) -> "UringWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_probe_lock = threading.Lock()
_probe: "bool | None" = None


def available() -> bool:
    """True when this kernel/container lets us build and drive a ring.

    Probed once per process with a tiny ring and a real 1-byte write to
    an unlinked temp file — ``io_uring_setup`` succeeding is NOT enough
    (seccomp policies commonly allow setup but kill/deny ``enter``).
    """
    global _probe
    with _probe_lock:
        if _probe is None:
            _probe = _probe_ring()
        return _probe


def _probe_ring() -> bool:
    import tempfile

    try:
        with UringWriter(entries=2) as writer:
            with tempfile.TemporaryFile() as fh:
                if writer.pwrite(fh.fileno(), b"\x00", 0) != 1:
                    return False
                fh.seek(0)
                return fh.read(1) == b"\x00"
    except (OSError, RuntimeError, ValueError, AttributeError):
        return False
