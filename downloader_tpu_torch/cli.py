"""Command line of the PyTorch/CUDA port:

    python -m downloader_tpu_torch upscale in.y4m out.y4m [--batch N] \
        [--device cuda|cpu] [--decode/--decoder BIN] [--encode/--encoder BIN] \
        [--encode-arg ARG ...]

``upscale`` mirrors the JAX package's ``upscale`` command
(``downloader_tpu/cli.py:374-403``, ``:1402-1445``): it drives the same
``transcode`` (optional decode front-end and encode back-end around the
engine) with the port's :class:`~.compute.pipeline.FrameUpscaler`.  It
runs on the GPU unless ``--device cpu`` is given.  The weights are the
seeded random init; ``--checkpoint-dir`` comes with the training slice.
"""

from __future__ import annotations

import argparse
import shutil
import sys


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="downloader-tpu-torch",
        description="The upscale compute plane on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    upscale = sub.add_parser(
        "upscale", help="upscale Y4M (or, with --decode, any container "
                        "an external decoder reads) through the model on "
                        "the GPU"
    )
    upscale.add_argument("src", help="input .y4m path (any container "
                                     "with --decode)")
    upscale.add_argument("dst", help="output .y4m path (2x dimensions)")
    upscale.add_argument("--batch", type=int, default=8,
                         help="frames per device dispatch")
    upscale.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                         help="run on the GPU (default) or, explicitly, on "
                              "the CPU's plain PyTorch path")
    upscale.add_argument("--decode", action="store_true",
                         help="pipe src through the decoder's "
                              "yuv4mpegpipe output first")
    upscale.add_argument("--decoder", default=None,
                         help="decoder binary (implies --decode; "
                              "default ffmpeg)")
    upscale.add_argument("--encode", action="store_true",
                         help="pipe the upscaled y4m through an encoder "
                              "into dst (compressed container out)")
    upscale.add_argument("--encoder", default=None,
                         help="encoder binary (implies --encode; "
                              "default ffmpeg)")
    upscale.add_argument("--encode-arg", action="append", default=None,
                         metavar="ARG", dest="encode_args",
                         help="encoder args before the output path "
                              "(repeatable; REPLACES the default set "
                              "'-c:v libx264 -preset veryfast -crf 18', "
                              "so restate what you still want)")
    return parser


def _upscale(args) -> int:
    from .compute.pipeline import FrameUpscaler
    from .compute.transcode import DEFAULT_ENCODE_ARGS, transcode

    # naming a decoder/encoder (or passing encode args) implies the mode;
    # binaries resolve BEFORE the engine is built, so a usage error does
    # not pay for device start-up
    decoder = encoder = None
    if args.decode or args.decoder:
        name = args.decoder or "ffmpeg"
        decoder = shutil.which(name)
        if decoder is None:
            print(f"decoder {name!r} not found on PATH", file=sys.stderr)
            return 2
    if args.encode or args.encoder or args.encode_args:
        name = args.encoder or "ffmpeg"
        encoder = shutil.which(name)
        if encoder is None:
            print(f"encoder {name!r} not found on PATH", file=sys.stderr)
            return 2
    upscaler = FrameUpscaler(batch=args.batch, device=args.device)
    try:
        # transcode writes through a private temp and renames onto dst
        # only on success: a pre-existing dst survives any error
        frames = transcode(
            upscaler, args.src, args.dst,
            decoder=decoder, encoder=encoder,
            encode_args=args.encode_args or DEFAULT_ENCODE_ARGS,
        )
    except RuntimeError as err:
        print(f"transcode failed: {err}", file=sys.stderr)
        return 1
    print(f"upscaled {frames} frames -> {args.dst}")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "upscale":
        return _upscale(args)
    raise AssertionError("unreachable")


if __name__ == "__main__":
    sys.exit(main())
