"""OpenCV-backed y4m <-> container codec tool (ffmpeg-contract subset).

The transcode plumbing (:mod:`.compute.transcode`) talks to external
codecs over the ffmpeg yuv4mpegpipe contract; production deployments use
ffmpeg itself.  This tool implements the same contract on top of
OpenCV's bundled FFMPEG build (``cv2``, present in the TPU-host image),
so hosts without an ffmpeg binary — including CI and the bench host —
can still run the decode front-end and encode back-end against a real
subprocess speaking real compressed containers:

    decode:  downloader-tpu-codec -i movie.mkv -f yuv4mpegpipe \
                 -pix_fmt yuv420p -loglevel error -
             (container frames -> planar 4:2:0 y4m on stdout)

    encode:  downloader-tpu-codec -y -f yuv4mpegpipe -i - \
                 -c:v mpeg4 out.mkv
             (y4m on stdin -> compressed container at the last operand)

Flag subset: ``-i``, ``-f``, ``-pix_fmt``, ``-loglevel``, ``-c:v``,
``-preset``, ``-crf``, ``-r`` (value-taking; unknown value-flags are
rejected, ffmpeg-style, rather than mis-parsed as the output), ``-y``
(bare).  Only 4:2:0 is supported — exactly what the transcode module
requests (``-pix_fmt yuv420p``).

This is a capability fallback, not an ffmpeg replacement: codec choice
is limited to what the local OpenCV build provides (``mpeg4``/``mjpeg``/
``ffv1`` are reliably present; ``libx264`` needs an OpenH264-enabled
build and fails cleanly otherwise).
"""

from __future__ import annotations

import sys
from fractions import Fraction
from typing import List, Optional

# ffmpeg codec name -> OpenCV fourcc
_FOURCC = {
    "libx264": "avc1",
    "h264": "avc1",
    "libx265": "hev1",
    "hevc": "hev1",
    "mpeg4": "mp4v",
    "mjpeg": "MJPG",
    "ffv1": "FFV1",
    "libvpx-vp9": "VP90",
    "vp9": "VP90",
}

_VALUE_FLAGS = {"-i", "-f", "-pix_fmt", "-loglevel", "-c:v", "-preset",
                "-crf", "-r"}
_BARE_FLAGS = {"-y", "-nostdin"}
# accepted for command-line compatibility with the transcode module's
# ffmpeg invocations but not implemented by the OpenCV backend (cv2's
# VideoWriter exposes no rate-control or speed knobs): announced on
# stderr (unless -loglevel error or below) so operators comparing
# against real ffmpeg output know the requested rate/quality behavior
# was not applied (advisor r4)
_IGNORED_VALUE_FLAGS = {"-preset", "-crf", "-r"}


class CodecError(RuntimeError):
    pass


def _parse(argv: List[str]) -> dict:
    opts = {"flags": {}, "output": None}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in _VALUE_FLAGS:
            if i + 1 >= len(argv):
                raise CodecError(f"flag {arg} needs a value")
            opts["flags"][arg] = argv[i + 1]
            i += 2
        elif arg in _BARE_FLAGS:
            opts["flags"][arg] = True
            i += 1
        elif arg.startswith("-") and arg != "-":
            raise CodecError(f"unknown flag {arg}")
        else:
            if opts["output"] is not None:
                raise CodecError(
                    f"multiple outputs: {opts['output']!r} and {arg!r}")
            opts["output"] = arg
            i += 1
    if "-i" not in opts["flags"]:
        raise CodecError("no input (-i)")
    if opts["output"] is None:
        raise CodecError("no output operand")
    return opts


def _fps_fraction(fps: float) -> Fraction:
    if not fps or fps != fps or fps <= 0:  # 0/NaN from broken containers
        return Fraction(25, 1)
    return Fraction(fps).limit_denominator(100_000)


def _decode(src: str, out_fh) -> int:
    """Container -> y4m (4:2:0) on ``out_fh``.  Returns frames written."""
    import cv2
    import numpy as np

    from .compute.video import Y4MHeader, Y4MWriter

    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        raise CodecError(f"cannot open {src!r} (unsupported or missing)")
    try:
        fps = _fps_fraction(cap.get(cv2.CAP_PROP_FPS))
        writer = None
        frames = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            h, w = frame.shape[:2]
            if h % 2 or w % 2:  # 4:2:0 needs even dims; crop one line/col
                frame = frame[: h - h % 2, : w - w % 2]
                h, w = frame.shape[:2]
            if writer is None:
                header = Y4MHeader(
                    width=w, height=h,
                    fps_num=fps.numerator, fps_den=fps.denominator,
                    colorspace="420jpeg",
                )
                writer = Y4MWriter(out_fh, header)
            i420 = cv2.cvtColor(frame, cv2.COLOR_BGR2YUV_I420)
            flat = np.ascontiguousarray(i420).reshape(-1)
            y_n, c_n = h * w, (h // 2) * (w // 2)
            writer.write_frame(
                flat[:y_n].reshape(h, w),
                flat[y_n:y_n + c_n].reshape(h // 2, w // 2),
                flat[y_n + c_n:].reshape(h // 2, w // 2),
            )
            frames += 1
        if frames == 0:
            raise CodecError(f"no decodable video frames in {src!r}")
        return frames
    finally:
        cap.release()


def _encode(in_fh, dst: str, codec: Optional[str]) -> int:
    """y4m on ``in_fh`` -> container at ``dst``.  Returns frames read."""
    import cv2
    import numpy as np

    from .compute.video import Y4MReader

    reader = Y4MReader(in_fh)
    hdr = reader.header
    if hdr.subsampling != (2, 2):
        raise CodecError(
            f"only 4:2:0 input is supported, got C{hdr.colorspace}")
    if codec is not None and codec not in _FOURCC:
        raise CodecError(f"unknown codec {codec!r} "
                         f"(supported: {', '.join(sorted(_FOURCC))})")
    if codec is None:
        codec = "mjpeg" if dst.lower().endswith(".avi") else "mpeg4"
    fourcc = cv2.VideoWriter_fourcc(*_FOURCC[codec])
    fps = hdr.fps_num / hdr.fps_den if hdr.fps_den else 25.0
    writer = cv2.VideoWriter(dst, fourcc, fps, (hdr.width, hdr.height))
    if not writer.isOpened():
        writer.release()
        raise CodecError(
            f"VideoWriter rejected codec {codec!r} ({_FOURCC[codec]}) "
            f"for {dst!r} — not in this OpenCV build?")
    try:
        frames = 0
        for y, cb, cr in reader:
            i420 = np.concatenate(
                [y.reshape(-1), cb.reshape(-1), cr.reshape(-1)]
            ).reshape(hdr.height * 3 // 2, hdr.width)
            writer.write(cv2.cvtColor(i420, cv2.COLOR_YUV2BGR_I420))
            frames += 1
        if frames == 0:
            raise CodecError("empty y4m stream (no FRAMEs)")
        return frames
    finally:
        writer.release()


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts = _parse(argv)
        ignored = sorted(_IGNORED_VALUE_FLAGS & opts["flags"].keys())
        # the notice is informational, so it honors -loglevel the way
        # ffmpeg's own banner/warnings do: anything at or below "error"
        # silences it (the transcode module always passes -loglevel
        # error, keeping its captured-stderr failure tails clean)
        quiet = opts["flags"].get("-loglevel") in (
            "quiet", "panic", "fatal", "error")
        if ignored and not quiet:
            print("downloader-tpu-codec: note: accepted but not "
                  "implemented by the OpenCV backend (no effect): "
                  + " ".join(f"{f} {opts['flags'][f]}" for f in ignored),
                  file=sys.stderr)
        src = opts["flags"]["-i"]
        out = opts["output"]
        if out == "-":
            # decode mode: container in, y4m on stdout
            if opts["flags"].get("-f") != "yuv4mpegpipe":
                raise CodecError("stdout output needs -f yuv4mpegpipe")
            pix = opts["flags"].get("-pix_fmt", "yuv420p")
            if pix != "yuv420p":
                raise CodecError(f"only yuv420p output is supported, "
                                 f"got {pix!r}")
            _decode(src, sys.stdout.buffer)
            sys.stdout.buffer.flush()
        elif src == "-":
            # encode mode: y4m on stdin, container out
            _encode(sys.stdin.buffer, out, opts["flags"].get("-c:v"))
        else:
            raise CodecError(
                "need a pipe on one side: -i - (encode) or '-' out (decode)")
        return 0
    except CodecError as err:
        print(f"downloader-tpu-codec: {err}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 1
    except Exception as err:  # parity with ffmpeg: nonzero + stderr line
        print(f"downloader-tpu-codec: {type(err).__name__}: {err}",
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
