"""Build and load the hand-written CUDA kernels in ``compute/csrc``.

Route: ``nvcc`` compiles each ``csrc/*.cu`` into its own shared library
with a plain C interface, loaded with :mod:`ctypes` — no PyTorch headers,
so a build takes seconds, not minutes.  All sources compile at once (one
``nvcc`` process each, started together) into ``_build/<digest>/``, where
the digest hashes every source and header plus the flags; a later process
with the same sources loads the cached libraries without compiling.

Nothing here runs at import: the first :func:`function` call builds.
Every C entry point launches on the stream it is given, never
synchronises, and returns ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception.  The runtime API launches on the
*current* device, so every wrapper calls its entry point through
:func:`launch`, which makes the operands' device current around the
call (an operand on ``cuda:1`` while device 0 is current would be a
launch into another device's stream).  There is no fallback: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


class TailCoeffs(ctypes.Structure):
    """``struct TailCoeffs`` of ``s2d_tail.cu``: the three 255-scaled
    RGB->YCbCr rows, passed by value."""

    _fields_ = [("y", ctypes.c_float * 3), ("cb", ctypes.c_float * 3),
                ("cr", ctypes.c_float * 3)]


_void_p, _int, _longlong, _float = (ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_float)

# library (source stem) -> (C symbol, argtypes)
SIGNATURES = {
    "quantize_u8": ("quantize_u8_launch",
                    [_void_p, _void_p, _longlong, _int, _void_p]),
    "s2d_tail": ("s2d_tail_launch",
                 [_void_p, _void_p, _void_p, _int, _int, _int, _int, _float,
                  TailCoeffs, _void_p]),
    "s2d_head": ("s2d_head_launch",
                 [_void_p, _void_p, _void_p, _void_p, _int, _int, _int, _int,
                  _void_p]),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


# one build at a time in a process (concurrent stage jobs may reach
# their first kernel together); launch counts are bumped under a lock too
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the launch count of a kernel's
    wrapper, safely across threads."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def build() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built for the current sources;
    return ``{stem: path of lib<stem>.so}``."""
    with _BUILD_LOCK:
        return _build()


def _build() -> Dict[str, Path]:
    out_dir = BUILD_DIR / _digest()
    sources = sorted(CSRC.glob("*.cu"))
    libs = {src.stem: out_dir / f"lib{src.stem}.so" for src in sources}
    missing = [src for src in sources if not libs[src.stem].exists()]
    if not missing:
        return libs
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in missing:
        # private temp + rename: a concurrent process never loads a
        # half-written library
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        jobs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for src, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, libs[src.stem])
        else:
            tmp.unlink(missing_ok=True)
            failures.append(f"{src.name} (exit {proc.returncode}):\n"
                            f"{log.decode(errors='replace')}")
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return libs


def _load(path: Path, name: str):
    symbol, argtypes = SIGNATURES[name]
    fn = getattr(ctypes.CDLL(str(path)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_variants(name: str, variants: Dict[str, Dict[str, int]]):
    """Compile ``csrc/<name>.cu`` once per variant, each with its own
    ``-D`` macros (``{tag: {macro: value}}``), all at once; return ``{tag:
    ctypes entry point}``.  For timing a kernel's compile-time options
    against each other on the card; the port itself runs :func:`function`'s
    build.  Raises if any build fails."""
    nvcc = _nvcc()
    jobs = {}
    for tag, defines in variants.items():
        out = BUILD_DIR / _digest() / "variants" / tag / f"lib{name}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [nvcc, *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defines.items()),
               "-I", str(CSRC), "-o", str(out), str(CSRC / f"{name}.cu")]
        jobs[tag] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT))
    fns, failures = {}, []
    for tag, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            fns[tag] = _load(out, name)
        else:
            failures.append(f"{name} {tag} (exit {proc.returncode}):\n"
                            f"{log.decode(errors='replace')}")
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return fns


@functools.lru_cache(maxsize=None)
def function(name: str):
    """The ctypes entry point of kernel library ``name`` (a key of
    :data:`SIGNATURES`), building the libraries on first use."""
    return _load(build()[name], name)


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as the C entries take it."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def same_device(name: str, **operands):
    """The one device every operand (a tensor) lies on; raises
    ``ValueError`` naming them when they lie on more than one."""
    devices = {t.device for t in operands.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices: " + ", ".join(
            f"{k} on {t.device}" for k, t in operands.items()))
    return devices.pop()


def launch(fn, name: str, device, *args) -> None:
    """Call C entry point ``fn`` (a :func:`function` or a
    :func:`build_variants` build) with ``args`` and the current stream of
    ``device``, with ``device`` the current device for the call; raise if
    it reports a CUDA error."""
    import torch

    with torch.cuda.device(device):
        check(fn(*args, stream_handle(device)), name)
