"""Streaming Y4M (YUV4MPEG2) reader/writer.

Y4M is the one raw video format the framework can decode without an
external codec stack: a one-line ASCII header (``YUV4MPEG2 W.. H.. F..
C420jpeg``) followed by ``FRAME`` records of planar YCbCr bytes.  It is
what ``ffmpeg -f yuv4mpegpipe`` emits, so a production deployment puts a
decode front-end ahead of the upscale stage and pipes y4m through it; the
GPU path (see :mod:`.pipeline`) is format-independent planar uint8.

A copy of ``downloader_tpu.compute.video``: the port keeps its own copy
of every framework-free module it needs instead of importing the JAX
package.

Supported chroma samplings: the 4:2:0 family (``C420``, ``C420jpeg``,
``C420mpeg2``, ``C420paldv`` — siting differences don't matter to a
box-filter resampler), ``C422`` and ``C444``.  Frame-level parameters on
``FRAME`` lines are preserved-by-ignoring (the spec allows them; nothing
in the wild needs them interpreted for decode).
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Iterator, Optional, Tuple

import numpy as np

Y4M_MAGIC = b"YUV4MPEG2"

# colorspace tag -> (chroma height divisor, chroma width divisor)
_SUBSAMPLING = {
    "420": (2, 2),
    "420jpeg": (2, 2),
    "420mpeg2": (2, 2),
    "420paldv": (2, 2),
    "422": (1, 2),
    "444": (1, 1),
}


class Y4MError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Y4MHeader:
    width: int
    height: int
    fps_num: int = 25
    fps_den: int = 1
    interlace: str = "p"
    aspect: str = "1:1"
    colorspace: str = "420jpeg"

    @property
    def subsampling(self) -> Tuple[int, int]:
        return _SUBSAMPLING[self.colorspace]

    @property
    def chroma_shape(self) -> Tuple[int, int]:
        sub_h, sub_w = self.subsampling
        return self.height // sub_h, self.width // sub_w

    @property
    def frame_bytes(self) -> int:
        ch, cw = self.chroma_shape
        return self.height * self.width + 2 * ch * cw

    def scaled(self, scale: int) -> "Y4MHeader":
        return dataclasses.replace(
            self, width=self.width * scale, height=self.height * scale
        )

    def encode(self) -> bytes:
        return (
            f"{Y4M_MAGIC.decode()} W{self.width} H{self.height} "
            f"F{self.fps_num}:{self.fps_den} I{self.interlace} "
            f"A{self.aspect} C{self.colorspace}\n"
        ).encode("ascii")


def parse_header(line: bytes) -> Y4MHeader:
    parts = line.strip().split(b" ")
    if not parts or parts[0] != Y4M_MAGIC:
        raise Y4MError("not a YUV4MPEG2 stream")
    fields = {}
    for part in parts[1:]:
        if len(part) < 2:
            continue
        fields[chr(part[0])] = part[1:].decode("ascii")
    try:
        width = int(fields["W"])
        height = int(fields["H"])
    except (KeyError, ValueError):
        raise Y4MError("Y4M header missing W/H") from None
    fps_num, fps_den = 25, 1
    if "F" in fields and ":" in fields["F"]:
        num, den = fields["F"].split(":", 1)
        try:
            fps_num, fps_den = int(num), int(den)
        except ValueError:
            raise Y4MError(f"bad Y4M frame rate {fields['F']!r}") from None
    colorspace = fields.get("C", "420jpeg")
    if colorspace not in _SUBSAMPLING:
        raise Y4MError(f"unsupported Y4M colorspace C{colorspace}")
    sub_h, sub_w = _SUBSAMPLING[colorspace]
    if width % sub_w or height % sub_h:
        raise Y4MError(
            f"frame {width}x{height} not divisible by C{colorspace} subsampling"
        )
    return Y4MHeader(
        width=width,
        height=height,
        fps_num=fps_num,
        fps_den=fps_den,
        interlace=fields.get("I", "p"),
        aspect=fields.get("A", "1:1"),
        colorspace=colorspace,
    )


class Y4MReader:
    """Iterate (y, cb, cr) uint8 planes from a y4m byte stream."""

    def __init__(self, fh: BinaryIO):
        self._fh = fh
        self.header = parse_header(self._read_line())

    def _read_line(self) -> bytes:
        line = self._fh.readline(4096)
        if not line.endswith(b"\n"):
            raise Y4MError("truncated Y4M header line")
        return line

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        hdr = self.header
        ch, cw = hdr.chroma_shape
        y_bytes = hdr.height * hdr.width
        c_bytes = ch * cw
        while True:
            marker = self._fh.readline(4096)
            if not marker:
                return  # clean EOF
            if not marker.startswith(b"FRAME"):
                raise Y4MError(f"expected FRAME marker, got {marker[:20]!r}")
            data = self._fh.read(hdr.frame_bytes)
            if len(data) != hdr.frame_bytes:
                raise Y4MError("truncated Y4M frame payload")
            buf = np.frombuffer(data, dtype=np.uint8)
            yield (
                buf[:y_bytes].reshape(hdr.height, hdr.width),
                buf[y_bytes : y_bytes + c_bytes].reshape(ch, cw),
                buf[y_bytes + c_bytes :].reshape(ch, cw),
            )


class Y4MWriter:
    """Write (y, cb, cr) uint8 planes as a y4m byte stream."""

    def __init__(self, fh: BinaryIO, header: Y4MHeader):
        self._fh = fh
        self.header = header
        fh.write(header.encode())

    def write_frame(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> None:
        hdr = self.header
        if (
            y.shape != (hdr.height, hdr.width)
            or cb.shape != hdr.chroma_shape
            or cr.shape != hdr.chroma_shape
        ):
            raise Y4MError(
                f"frame planes {y.shape}/{cb.shape}/{cr.shape} do not match "
                f"header {hdr.width}x{hdr.height} C{hdr.colorspace}"
            )
        self._fh.write(b"FRAME\n")
        self._fh.write(np.ascontiguousarray(y, dtype=np.uint8).tobytes())
        self._fh.write(np.ascontiguousarray(cb, dtype=np.uint8).tobytes())
        self._fh.write(np.ascontiguousarray(cr, dtype=np.uint8).tobytes())


def sniff_y4m(path: str) -> Optional[Y4MHeader]:
    """Return the parsed header if ``path`` is a Y4M stream, else None."""
    try:
        with open(path, "rb") as fh:
            magic = fh.read(len(Y4M_MAGIC))
            if magic != Y4M_MAGIC:
                return None
            fh.seek(0)
            return parse_header(fh.readline(4096))
    except (OSError, Y4MError):
        return None
