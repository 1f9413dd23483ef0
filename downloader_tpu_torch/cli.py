"""Command line of the PyTorch/CUDA port:

    python -m downloader_tpu_torch upscale in.y4m out.y4m [--batch N] \
        [--checkpoint-dir DIR] [--device cuda|cpu] [--decode/--decoder BIN] \
        [--encode/--encoder BIN] [--encode-arg ARG ...]
    python -m downloader_tpu_torch train --data MEDIA [--steps N] [--batch N] \
        [--crop N] [--lr LR] [--checkpoint-dir DIR] [--save-every N] \
        [--model-axis 1] [--seed N] [--scale N] [--features N] [--depth N] \
        [--device cuda|cpu]

``upscale`` mirrors the JAX package's ``upscale`` command
(``downloader_tpu/cli.py:374-403``, ``:1402-1445``): it drives the same
``transcode`` (optional decode front-end and encode back-end around the
engine) with the port's :class:`~.compute.pipeline.FrameUpscaler`, on
the weights of ``--checkpoint-dir``'s latest step or, without it, the
seeded random init.  ``train`` mirrors ``downloader_tpu/cli.py:405-430``
and ``:1454-1480``: it fits the upscaler on Y4M media and saves the
port's own checkpoints (:mod:`.compute.checkpoint`), resuming from the
latest one.  Both run on the GPU unless ``--device cpu`` is given.
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
    upscale.add_argument("--checkpoint-dir", default=None,
                         help="checkpoint dir written by the train command "
                              "(default: seeded random init)")
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

    train = sub.add_parser(
        "train", help="fit the upscaler on Y4M media (self-supervised SR)"
    )
    train.add_argument("--data", required=True,
                       help=".y4m file or directory of .y4m files")
    train.add_argument("--steps", type=int, default=200)
    train.add_argument("--batch", type=int, default=8)
    train.add_argument("--crop", type=int, default=64,
                       help="high-res crop edge (LR input is crop/scale)")
    train.add_argument("--lr", type=float, default=1e-3,
                       help="adam learning rate")
    train.add_argument("--checkpoint-dir", default=None,
                       help="dir to save to / resume from")
    train.add_argument("--save-every", type=int, default=100)
    train.add_argument("--model-axis", type=int, default=1,
                       help="tensor-parallel axis size (only 1 until the "
                            "multi-GPU slice)")
    train.add_argument("--seed", type=int, default=0)
    train.add_argument("--scale", type=int, default=2,
                       help="upscale factor (match the upscale engine's)")
    train.add_argument("--features", type=int, default=128,
                       help="conv width (match the upscale engine's)")
    train.add_argument("--depth", type=int, default=4,
                       help="conv layers (match the upscale engine's)")
    train.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="train on the GPU (default) or, explicitly, on "
                            "the CPU's plain PyTorch path")
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
    upscaler = FrameUpscaler(batch=args.batch, device=args.device,
                             checkpoint_dir=args.checkpoint_dir)
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


def _train(args) -> int:
    from .compute.trainer import TrainerSettings, discover_media, train

    paths = discover_media(args.data)
    settings = TrainerSettings(
        steps=args.steps,
        batch=args.batch,
        crop=args.crop,
        learning_rate=args.lr,
        checkpoint_dir=args.checkpoint_dir,
        save_every=args.save_every,
        model_axis=args.model_axis,
        seed=args.seed,
        scale=args.scale,
        features=args.features,
        depth=args.depth,
    )
    summary = train(paths, settings, log=print, device=args.device)
    print(
        f"trained to step {summary['final_step']} "
        f"(loss {summary['final_loss']:.6f}, batch {summary['batch']}, "
        f"devices {summary['devices']})"
    )
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "upscale":
        return _upscale(args)
    if args.command == "train":
        return _train(args)
    raise AssertionError("unreachable")


if __name__ == "__main__":
    sys.exit(main())
