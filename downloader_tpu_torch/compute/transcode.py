"""External decode / encode front- and back-ends around the upscaler.

The pipeline deals exclusively in compressed containers (the process
stage's extension whitelist — reference lib/process.js:15-20), but the
upscale engine speaks raw planar Y4M.  This module closes the gap in BOTH
directions with external codec subprocesses, streaming — no intermediate
raw file ever touches disk:

    decoder:  <binary> -i <src> -f yuv4mpegpipe -pix_fmt yuv420p -loglevel error -
                  |  (y4m over a pipe)
    engine.upscale_to(decoder.stdout, encoder.stdin)
                  |  (upscaled y4m over a pipe)
    encoder:  <binary> -y -f yuv4mpegpipe -i - -loglevel error <args...> <dst>

A copy of ``downloader_tpu.compute.transcode`` that imports the port's
own ``utils.stale``; it drives whatever engine it is given through
``engine.upscale_to``.

``ffmpeg`` satisfies the contract out of the box and is the production
default for both ends; any binary speaking the same flag subset works
(e.g. the in-repo OpenCV-backed ``downloader-tpu-codec`` shim for hosts
without ffmpeg).  Either end is optional: decoder-only emits raw Y4M
(the pre-encode behavior), encoder-only ingests an already-raw Y4M
source, neither reduces to plain file-to-file upscaling.

Subprocess hygiene, shared by both ends:

- stderr goes to a temp FILE, never a pipe — a chatty codec could fill a
  pipe buffer and deadlock against our stream reads/writes; the tail is
  replayed into the raised error instead.
- stdin of the DECODER is /dev/null: ffmpeg with an inherited tty
  enables interactive key handling (a stray 'q' kills the decode).
  The encoder's stdin IS the y4m stream, so it gets ``-y`` — without it
  an existing dst makes ffmpeg prompt for overwrite confirmation ON
  STDIN, eating the start of the stream and hanging the transcode.
"""

from __future__ import annotations

import glob
import itertools
import os
import subprocess
import tempfile
from typing import Optional, Sequence

from ..utils.stale import PART_TEMP_RE as _PART_RE
from ..utils.stale import probe_stale

# per-call-unique temp suffix: two concurrent transcodes to the same dst
# in one process must not interleave into one temp (same lesson as the
# fs store's ingest temps); naming pattern + reclaim policy are shared
# with the fs store in utils/stale.py
_PART_SEQ = itertools.count()

# x264 in a matroska container: the downstream converter's own deliverable
# class (reference pipeline containers, lib/process.js:15-20).  CRF 18 is
# visually-lossless-grade for upscaled content; veryfast keeps the encoder
# off the critical path of the device pipeline.
DEFAULT_ENCODE_ARGS = ("-c:v", "libx264", "-preset", "veryfast", "-crf", "18")


def decoder_command(binary: str, src: str) -> list:
    return [binary, "-i", src, "-f", "yuv4mpegpipe", "-pix_fmt", "yuv420p",
            "-loglevel", "error", "-"]


def encoder_command(binary: str, dst: str,
                    encode_args: Sequence[str]) -> list:
    return [binary, "-y", "-f", "yuv4mpegpipe", "-i", "-",
            "-loglevel", "error", *encode_args, dst]


def _tail(err_fh) -> str:
    err_fh.seek(0)
    return err_fh.read()[-500:].decode("utf-8", errors="replace").strip()


def transcode(
    engine,
    src: str,
    dst: str,
    *,
    decoder: Optional[str] = None,
    encoder: Optional[str] = None,
    encode_args: Sequence[str] = DEFAULT_ENCODE_ARGS,
    depth: int = 3,
) -> int:
    """Run ``src`` through (decode ->) upscale (-> encode) into ``dst``.

    Returns the number of frames processed.  Raises ``RuntimeError``
    with the failing codec's stderr tail on subprocess failure.  The
    output is written to a per-call-unique same-directory temp name
    (extension preserved — encoders infer the muxer from it) and
    renamed onto ``dst`` only after every process exited cleanly: a
    pre-existing ``dst`` survives ANY failure untouched, no partial
    output is ever visible under the final name, and no stat heuristics
    are needed (coarse-mtime filesystems made the old caller-side ones
    false-negative; review r4).  Temps orphaned by SIGKILL are reclaimed
    on the next transcode to the same ``dst`` once their writer pid is
    dead AND a cross-host grace period has passed (the pid probe is
    host-local — see :func:`..utils.stale.probe_stale`); within the
    grace window a redelivered job is still safe because the media walk
    skips part-temp names outright (``stages/process.py``).
    """
    _reclaim_stale_parts(dst)
    ext = os.path.splitext(dst)[1]
    tmp_dst = f"{dst}.part-{os.getpid()}.{next(_PART_SEQ)}{ext}"
    try:
        frames = _transcode(engine, src, tmp_dst, decoder, encoder,
                            encode_args, depth)
        os.replace(tmp_dst, dst)
        return frames
    except BaseException:
        try:
            os.unlink(tmp_dst)
        except OSError:
            pass
        raise


def _reclaim_stale_parts(dst: str) -> None:
    """Unlink ``dst``'s temp outputs whose writer process is gone; a
    LIVE pid may be a concurrent transcode racing for the same dst —
    leave its temp alone (its rename decides the race)."""
    for path in glob.glob(glob.escape(dst) + ".part-*"):
        match = _PART_RE.search(path)
        if match is None:
            continue
        stale, _age = probe_stale(path, int(match.group(1)))
        if stale:
            try:
                os.unlink(path)
            except OSError:
                pass


def _transcode(engine, src, dst, decoder, encoder, encode_args,
               depth) -> int:
    from .video import Y4MError

    dec = enc = None
    dec_err = enc_err = None
    try:
        dec_err = tempfile.TemporaryFile()
        enc_err = tempfile.TemporaryFile()
        if decoder is not None:
            dec = subprocess.Popen(
                decoder_command(decoder, src),
                stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                stderr=dec_err,
            )
            src_fh = dec.stdout
        else:
            src_fh = open(src, "rb")
        try:
            if encoder is not None:
                enc = subprocess.Popen(
                    encoder_command(encoder, dst, encode_args),
                    stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                    stderr=enc_err,
                )
                dst_fh = enc.stdin
                try:
                    frames = engine.upscale_to(src_fh, dst_fh, depth=depth)
                finally:
                    # EOF to the encoder even on failure paths: wait()
                    # below must not hang on an encoder still reading
                    try:
                        dst_fh.close()
                    except (BrokenPipeError, OSError):
                        pass
            else:
                with open(dst, "wb") as dst_fh:
                    frames = engine.upscale_to(src_fh, dst_fh, depth=depth)
        finally:
            if dec is None:
                src_fh.close()

        if enc is not None and enc.wait() != 0:
            raise RuntimeError(
                f"encoder exited {enc.returncode}: {_tail(enc_err)}"
            )
        if dec is not None and dec.wait() != 0:
            raise RuntimeError(
                f"decoder exited {dec.returncode}: {_tail(dec_err)}"
            )
        return frames

    except Y4MError as exc:
        # the y4m stream itself was bad.  With a decoder in front that
        # means the DECODER failed — wrap with its exit code and stderr;
        # a corrupt raw source propagates as the (already clear) Y4MError.
        if dec is not None:
            dec.kill()
            rc = dec.wait()
            raise RuntimeError(
                f"decoder produced invalid y4m (exit {rc}): {exc}; "
                f"{_tail(dec_err)}"
            ) from exc
        raise
    except BrokenPipeError as exc:
        if enc is None:
            raise  # dst itself is a broken pipe (e.g. a FIFO consumer died)
        # the ENCODER died under us mid-stream; its stderr says why
        raise RuntimeError(
            f"encoder exited {enc.wait()} mid-stream: {_tail(enc_err)}"
        ) from exc
    finally:
        for proc in (dec, enc):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        for fh in (dec_err, enc_err):
            if fh is not None:
                fh.close()
